"""Which slice of each parameter a rank holds, and which ranks sum its gradient.

Port of the rules of ``repro.models.sharding`` for the leaves the port has.
JAX resolves a rule to a ``PartitionSpec`` and lets GSPMD move the data;
here a rule gives each rank its slice of the full tensor
(:func:`shard_lm_params`) and a :class:`LeafPlan`: the ranks that hold the
same slice on different tokens, whose gradients must be summed, and over
which the slice is counted once in the global norm.

Symbols (per trailing dim of a leaf): ``tp`` the attention TP axis,
``fsdp`` the attention DP axis at rest, ``ep``/``etp`` the MoE axes,
``efsdp`` the MoE EDP axis. ``fsdp`` only changes where a slice is stored
(GSPMD gathers it for compute), so this slice keeps the attention-side
leaves replicated over DP: the numbers are the same (ZeRO-1 and FSDP
storage are ROADMAP.md queue 1 item 4). ``efsdp`` cuts the experts' ``D``
as the dispatcher expects (``core.moe_layer.shard_moe_params``), which
gathers it back and reduce-scatters its gradient.
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core.folding import AxisGroups, FoldedGroups

# (regex on the port's parameter name, symbols of the leaf's dims); the
# reference's (path-regex, symbols) for the leaves the port has.
RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"^embed$",                ("tp", "fsdp")),       # (V, D)
    (r"attn\.(wq|wk|wv)$",      ("fsdp", "tp")),       # (D, H*hd)
    (r"attn\.(bq|bk|bv)$",      ("tp",)),
    (r"attn\.wo$",              ("tp", "fsdp")),       # (H*hd, D)
    (r"moe\.router$",           (None, None)),         # (D, E) tiny, replicated
    (r"moe\.w[13]$",            ("ep", "efsdp", "etp")),  # (E, D, F)
    (r"moe\.w2$",               ("ep", "etp", "efsdp")),  # (E, F, D)
    (r"moe\.ws[13]$",           ("efsdp", "etp")),     # shared (D, Fs)
    (r"moe\.ws2$",              ("etp", "efsdp")),     # shared (Fs, D)
    (r"^lm_head$",              ("fsdp", "tp")),       # (D, V)
    (r".*",                     ()),                   # norms, the gate: replicated
)
_AXIS = {"tp": ("attn", "tp"), "ep": ("moe", "ep"), "etp": ("moe", "etp"),
         "efsdp": ("moe", "edp"), "fsdp": None}


def symbols(name: str) -> Tuple[Optional[str], ...]:
    """The rule's symbols for leaf ``name`` (first matching rule)."""
    return next(sym for pat, sym in RULES if re.search(pat, name))


def _axes_of(name: str, ndim: int, groups: FoldedGroups
             ) -> Tuple[Optional[AxisGroups], ...]:
    """Per dim of the leaf, the axis that cuts it (``None``: whole)."""
    sym = symbols(name)[-ndim:] if ndim else ()
    sym = (None,) * (ndim - len(sym)) + tuple(sym)
    return tuple(None if s is None or _AXIS[s] is None else groups.axis(*_AXIS[s])
                 for s in sym)


def shard_tensor(name: str, t: torch.Tensor, groups: FoldedGroups) -> torch.Tensor:
    """This rank's slice of the full leaf ``t`` named ``name`` (a parameter,
    its gradient or a moment), as a contiguous copy."""
    for dim, ax in enumerate(_axes_of(name, t.dim(), groups)):
        if ax is None or ax.size == 1:
            continue
        if t.shape[dim] % ax.size:
            raise ValueError(f"{name}: dim {dim} of size {t.shape[dim]} does not split "
                             f"over {ax.size} ranks")
        step = t.shape[dim] // ax.size
        t = t.narrow(dim, ax.index * step, step)
    return t.detach().clone().contiguous()


def map_params(module: nn.Module, fn: Callable[[str, torch.Tensor], torch.Tensor],
               prefix: str = "") -> nn.Module:
    """The same module tree with each parameter replaced by
    ``nn.Parameter(fn(name, parameter))``; the input is left as it was."""
    new = copy.copy(module)
    new._parameters = {k: None if p is None else nn.Parameter(fn(prefix + k, p.detach()))
                       for k, p in module._parameters.items()}
    new._modules = {k: None if c is None else map_params(c, fn, f"{prefix}{k}.")
                    for k, c in module._modules.items()}
    return new


def shard_lm_params(params: nn.Module, groups: FoldedGroups) -> nn.Module:
    """This rank's slices of a full parameter tree (``LMParams``)."""
    return map_params(params, lambda n, t: shard_tensor(n, t, groups))


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """``reduce``: the attention axis whose ranks sum the leaf's gradient
    after the backward (``None`` when the backward already summed it: the
    MoE leaves, in the dispatcher). ``replicas``: ``(side, axis)`` of the
    ranks that hold the same slice (``None``: no other rank does)."""

    reduce: Optional[str]
    replicas: Optional[Tuple[str, str]]


# MoE axes a leaf is not cut on → the combined axis of their ranks.
_MOE_REPLICAS = {frozenset({"edp", "ep", "etp"}): "tokens", frozenset({"ep"}): "ep",
                 frozenset(): None}


def leaf_plan(name: str) -> LeafPlan:
    """The reduction plan of one leaf. Attention-side leaves (embedding,
    attention, norms, LM head) see their rank's tokens: the ranks that hold
    the same slice (``dp_cp`` for those cut on TP, the whole ``stage`` for
    the replicated ones) sum their gradients. The MoE leaves are summed
    inside the dispatcher (the router and gate over the token ranks, the
    shared expert over EP, the experts over EDP by the gather's backward)."""
    sym = {s for s in symbols(name) if s is not None and _AXIS[s] is not None}
    if re.search(r"(^|\.)moe\.", name):
        unused = frozenset({"edp", "ep", "etp"} - {_AXIS[s][1] for s in sym})
        if unused not in _MOE_REPLICAS:
            raise ValueError(f"{name}: no reduction plan for MoE replicas {sorted(unused)}")
        axis = _MOE_REPLICAS[unused]
        return LeafPlan(reduce=None, replicas=axis and ("moe", axis))
    axis = "dp_cp" if "tp" in sym else "stage"
    return LeafPlan(reduce=axis, replicas=("attn", axis))


@torch.no_grad()
def reduce_grads(grads: Dict[str, torch.Tensor], groups: FoldedGroups) -> None:
    """Sum each gradient over the ranks of its plan's ``reduce`` axis, in
    place, in the gradient's dtype (the reference's backward reduces in the
    compute dtype)."""
    for name, g in grads.items():
        axis = leaf_plan(name).reduce
        group = None if axis is None else groups.attn[axis].group
        if group is not None:
            with torch.profiler.record_function("comm all_reduce"):
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)


def norm_counted(names, groups: FoldedGroups) -> Dict[str, bool]:
    """Whether this rank's slice of each leaf counts in the global norm:
    the first of its replicas does, the others do not."""
    out = {}
    for name in names:
        rep = leaf_plan(name).replicas
        out[name] = rep is None or groups.axis(*rep).index == 0
    return out
