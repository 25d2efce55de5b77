"""Which slice of each parameter a rank holds, and which ranks sum its gradient.

Port of the rules of ``repro.models.sharding`` for the leaves the port has.
JAX resolves a rule to a ``PartitionSpec`` and lets GSPMD move the data;
here a rule gives a *spec* (per dimension of the full leaf, the tuple of
atom names that cut it, ``core.folding.FoldedGroups.atom_names``), each
rank its slice of the full tensor (:func:`shard_tensor`), and a
:class:`LeafLayout`: which ranks sum its gradient and where its optimizer
state is cut.

Symbols (per trailing dim of a leaf): ``tp`` the attention TP axis,
``fsdp`` the attention DP axis, ``ep``/``etp`` the MoE axes, ``efsdp`` the
MoE EDP axis. A leaf has three layouts (``KINDS``):

* ``compute`` — the slice a layer computes with: ``fsdp`` resolves to no
  axis;
* ``store`` — the slice a rank holds at rest: ``fsdp`` resolves to the
  attention DP atoms when ``ParallelConfig.fsdp`` is set (the reference's
  ``_resolve``); the layer all-gathers it over DP where it is used
  (:func:`gather_for_compute`), and that gather's backward reduce-scatters
  its gradient;
* ``state`` — the slice of its optimizer state: the store spec with the
  DP atoms of the leaf's side appended by ZeRO-1
  (``optim.adamw.zero1_spec``).

The leaves of the other block kinds match the same rules: ``xattn.*``
(cross-attention) as ``attn.*``, ``norm_x`` and a LayerNorm's ``.w``/``.b``
as the other norms, ``encoder.*`` as the decoder's layers, Zamba2's
``shared.*`` block as a dense layer's. The recurrent blocks' leaves
(``models.ssm_blocks``) are stored as the reference stores them but
computed on whole (:func:`gather_whole`); their gradients are reduced as
any other TP leaf's.

``efsdp`` cuts the experts' ``D`` over EDP in all three, whatever
``fsdp`` says, because the dispatcher gathers them from there (reference
``dispatcher.py:425-428``, whose ``shard_map`` cuts ``edp`` regardless of
``fsdp``). So with ``fsdp=False`` the port stores the experts cut where the
reference replicates them: the numbers are the same, only memory differs.
As in the reference, a symbol whose atoms do not divide its dimension
leaves it whole in a spec (``_safe_spec``), and :func:`shard_tensor` keeps
the vocabulary dim (``VOCAB_DIMS``) whole: a vocabulary that TP does not
divide (Whisper's 51865) stays whole on every TP rank, which then looks up,
projects and scores the whole vocabulary for its own rows
(``models.transformer.vocab_cut``). Every other cut is required where it
resolves (the TP matmuls sum partial products, the dispatcher takes the
experts cut, FSDP's gather assumes the cut), so :func:`shard_tensor`
refuses a dim that does not divide.
"""
from __future__ import annotations

import copy
import dataclasses
import re
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups, as_layout
from repro_torch.optim.adamw import Spec, dp_axis, zero1_spec

# (regex on the port's parameter name, symbols of the leaf's dims); the
# reference's (path-regex, symbols) for the leaves the port has.
RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"^embed$",                ("tp", "fsdp")),       # (V, D)
    (r"attn\.(wq|wk|wv)$",      ("fsdp", "tp")),       # (D, H*hd)
    (r"attn\.(bq|bk|bv)$",      ("tp",)),
    (r"attn\.wo$",              ("tp", "fsdp")),       # (H*hd, D)
    (r"mlp\.(w_gate|w_up)$",    ("fsdp", "tp")),       # dense FFN (D, F)
    (r"mlp\.w_down$",           ("tp", "fsdp")),       # dense FFN (F, D)
    (r"moe\.router$",           (None, None)),         # (D, E) tiny, replicated
    (r"moe\.w[13]$",            ("ep", "efsdp", "etp")),  # (E, D, F)
    (r"moe\.w2$",               ("ep", "etp", "efsdp")),  # (E, F, D)
    (r"moe\.ws[13]$",           ("efsdp", "etp")),     # shared (D, Fs)
    (r"moe\.ws2$",              ("etp", "efsdp")),     # shared (Fs, D)
    (r"^lm_head$",              ("fsdp", "tp")),       # (D, V)
    # Recurrent blocks (models.ssm_blocks): input-dim FSDP, inner-dim TP, as
    # the reference stores them; they compute on whole leaves (gather_whole).
    (r"(^|\.)(w_in|w_x|w_qkv_lstm|wi|wf)$", ("fsdp", "tp")),
    (r"(^|\.)(w_out_ssm|w_proj_down)$", ("tp", "fsdp")),
    (r"(^|\.)(a_log|dt_bias|d_skip)$", ("tp",)),
    (r"(^|\.)conv_w$",          (None, None, "tp")),   # (W, 1, C)
    (r".*",                     ()),                   # norms, the gate, r_h, b: replicated
)
_AXIS = {"tp": ("attn", "tp"), "fsdp": ("attn", "dp"), "ep": ("moe", "ep"),
         "etp": ("moe", "etp"), "efsdp": ("moe", "edp")}
KINDS = ("compute", "store", "state")


def symbols(name: str) -> Tuple[Optional[str], ...]:
    """The rule's symbols for leaf ``name`` (first matching rule)."""
    return next(sym for pat, sym in RULES if re.search(pat, name))


def _symbols(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """One symbol per dim: the rule's trailing symbols, padded with None."""
    sym = symbols(name)[-ndim:] if ndim else ()
    return (None,) * (ndim - len(sym)) + tuple(sym)


def _resolve(sym: Optional[str], fg: FoldedGroups, kind: str) -> Tuple[str, ...]:
    if sym is None or (sym == "fsdp" and (kind == "compute" or not fg.pcfg.fsdp)):
        return ()
    return fg.atoms(*_AXIS[sym])


def leaf_spec(name: str, shape: Sequence[int], layout, kind: str = "store") -> Spec:
    """The spec of the full leaf ``name`` of ``shape`` in layout ``kind``
    (``KINDS``) at ``layout`` (a ``FoldedGroups`` or a ``ParallelConfig``)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    fg = as_layout(layout)
    spec = []
    for dim, sym in zip(shape, _symbols(name, len(shape))):
        atoms = _resolve(sym, fg, "compute" if kind == "compute" else "store")
        spec.append(atoms if dim % fg.atom_size(atoms) == 0 else ())
    if kind == "state":
        return zero1_spec(name, tuple(spec), shape, fg)
    return tuple(spec)


def _cut(t: torch.Tensor, dim: int, atoms: Sequence[str], fg: FoldedGroups) -> torch.Tensor:
    """This rank's piece of ``t`` along ``dim`` cut over ``atoms``."""
    n = fg.atom_size(atoms)
    if n == 1:
        return t
    step = t.shape[dim] // n
    return t.narrow(dim, fg.atom_index(atoms) * step, step)


# The vocabulary dim of each leaf that has one: the only dim a spec may
# keep whole where its atoms do not divide it.
VOCAB_DIMS = {"embed": 0, "lm_head": 1}


def _checked_spec(name: str, shape: Sequence[int], fg: FoldedGroups, kind: str) -> Spec:
    """:func:`leaf_spec`, raising where a symbol's atoms do not divide its
    dim, but for the vocabulary dim (``VOCAB_DIMS``), which stays whole."""
    spec = leaf_spec(name, shape, fg, kind)
    for dim, (sym, atoms) in enumerate(zip(_symbols(name, len(shape)), spec)):
        want = _resolve(sym, fg, "compute" if kind == "compute" else "store")
        if VOCAB_DIMS.get(name) != dim and want and not set(want) <= set(atoms):
            raise ValueError(f"{name}: dim {dim} of size {shape[dim]} does not split "
                             f"over {fg.atom_size(want)} ranks")
    return spec


def shard_tensor(name: str, t: torch.Tensor, groups: FoldedGroups, kind: str = "compute"
                 ) -> torch.Tensor:
    """This rank's ``kind`` slice of the full leaf ``t`` named ``name`` (a
    parameter, its gradient or a moment), as a contiguous copy."""
    for dim, atoms in enumerate(_checked_spec(name, t.shape, groups, kind)):
        t = _cut(t, dim, atoms, groups)
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


def shard_lm_params(params: nn.Module, groups: FoldedGroups, kind: str = "store"
                    ) -> nn.Module:
    """This rank's slices of a full parameter tree (``LMParams``): by
    default the store layout, the one the train step takes."""
    return map_params(params, lambda n, t: shard_tensor(n, t, groups, kind))


def store_from_compute(params: nn.Module, groups: FoldedGroups,
                       shapes: Mapping[str, Sequence[int]]) -> nn.Module:
    """This rank's store slices from its compute slices (``shapes``: the
    full leaves', ``transformer.param_shapes``): the FSDP leaves cut further
    over DP (a copy; the same tree when nothing is)."""
    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        comp, store = (_checked_spec(name, shapes[name], groups, k)
                       for k in ("compute", "store"))
        for dim, (c, s) in enumerate(zip(comp, store)):
            t = _cut(t, dim, s[len(c):], groups)
        return t.clone().contiguous()
    return map_params(params, cut)


def gather_for_compute(name: str, t: torch.Tensor, groups: Optional[FoldedGroups]
                       ) -> torch.Tensor:
    """The compute slice of a leaf from its store slice ``t``: an FSDP leaf
    is all-gathered over the attention DP ranks along its ``fsdp`` dim
    (``core.comm.all_gather``, whose backward reduce-scatters the gradient,
    so it arrives summed over DP); any other leaf is ``t`` itself."""
    if groups is None or not groups.pcfg.fsdp or groups.dp == 1:
        return t
    sym = _symbols(name, t.dim())
    if "fsdp" not in sym:
        return t
    dp = groups.attn["dp"]
    return comm.all_gather(t, dp, sym.index("fsdp"))


def gather_whole(name: str, t: torch.Tensor, groups: Optional[FoldedGroups],
                 kind: str = "store") -> torch.Tensor:
    """The whole leaf from its ``kind`` slice ``t`` (``store``, or the
    ``compute`` slice that serving holds): :func:`gather_for_compute`'s
    FSDP gather (store slices only), then an all-gather over the attention
    TP ranks along its ``tp`` dim. A recurrent block computes on whole
    leaves, because the reference's TP cut of ``w_in`` runs across its
    concatenated z | x | B | C | dt columns, not along heads; each gather's
    backward reduce-scatters, so the gradient of the rank's slice arrives
    summed over TP (and DP)."""
    if kind == "store":
        t = gather_for_compute(name, t, groups)
    if groups is None or groups.tp == 1:
        return t
    sym = _symbols(name, t.dim())
    if "tp" not in sym:
        return t
    tp = groups.attn["tp"]
    return comm.all_gather(t, tp, sym.index("tp"))


def reduce_axis(name: str) -> Optional[str]:
    """The attention axis whose ranks sum the leaf's gradient after the
    backward. Attention-side leaves (embedding, attention, norms, LM head)
    see their rank's tokens: the ranks that hold the same slice (``dp_cp``
    for those cut on TP, the whole ``stage`` for the replicated ones) sum
    their gradients. ``None`` for the MoE leaves, which the dispatcher sums
    (the router and gate over the token ranks, the shared expert over EP,
    the experts over EDP by the gather's backward)."""
    if re.search(r"(^|\.)moe\.", name):
        return None
    return "dp_cp" if "tp" in symbols(name) else "stage"


# A reduce axis less the attention DP atoms: what is left to sum after a
# reduce-scatter over DP (ZeRO-1) or the FSDP gather's backward.
_WITHOUT_DP = {"dp_cp": "cp", "stage": "cp_tp"}


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One leaf at a fold: its ``state`` spec, ``fsdp`` (stored cut over
    the attention DP atoms, gathered for compute), ``zero_dim``, the dim on
    which the state cuts the store slice further over the ``dp`` axis of
    its side (``None``: the state shard is the store slice), and that axis
    as ``(side, axis)``."""

    state: Spec
    fsdp: bool
    zero_dim: Optional[int]
    dp: Tuple[str, str]


def leaf_layout(name: str, shape: Sequence[int], layout) -> LeafLayout:
    """The :class:`LeafLayout` of the full leaf ``name`` of ``shape``."""
    fg = as_layout(layout)
    store, state = leaf_spec(name, shape, fg, "store"), leaf_spec(name, shape, fg, "state")
    zero_dim = next((i for i, (a, b) in enumerate(zip(store, state)) if a != b), None)
    fsdp = any(sym == "fsdp" and atoms for sym, atoms in zip(_symbols(name, len(shape)), store))
    return LeafLayout(state, fsdp, zero_dim, dp_axis(name))


def layouts_of(params: Iterable[str], groups: FoldedGroups,
               shapes: Mapping[str, Sequence[int]]) -> Dict[str, LeafLayout]:
    """The :class:`LeafLayout` of each leaf named in ``params`` (this rank's
    store slices), from the full leaves' ``shapes``
    (``transformer.param_shapes``)."""
    return {n: leaf_layout(n, shapes[n], groups) for n in params}


def state_view(p: torch.Tensor, lay: LeafLayout, groups: FoldedGroups) -> torch.Tensor:
    """This rank's state shard of its store slice ``p`` (a view where the
    cut is contiguous; the caller writes it back with :func:`gather_state`)."""
    if lay.zero_dim is None:
        return p
    return _cut(p, lay.zero_dim, groups.atoms(*lay.dp), groups).contiguous()


@torch.no_grad()
def gather_state(params: Mapping[str, torch.Tensor], shards: Mapping[str, torch.Tensor],
                 layouts: Mapping[str, LeafLayout], groups: FoldedGroups) -> None:
    """Write each updated state shard back into its store slice: an
    all-gather over the leaf's DP ranks along its ZeRO-1 dim, for the leaves
    whose state cuts the store slice further (ZeRO-1 after the update)."""
    for name, p in params.items():
        lay = layouts[name]
        if lay.zero_dim is not None:
            ax = groups.axis(*lay.dp)
            p.copy_(comm.all_gather(shards[name], ax, lay.zero_dim))


@torch.no_grad()
def reduce_grads(grads: Dict[str, torch.Tensor], groups: FoldedGroups,
                 layouts: Optional[Mapping[str, LeafLayout]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Sum each gradient over the ranks that computed it on other tokens, in
    the gradient's dtype (the reference's backward reduces in the compute
    dtype).

    Without ``layouts``: gradients of compute slices, each all-reduced over
    its :func:`reduce_axis` in place. With ``layouts`` (the train step's
    ZeRO-1): gradients of store slices, each reduced to its state shard. A
    leaf the state cuts on ``zero_dim`` is reduce-scattered over its DP ranks
    there, then all-reduced over the rest of its reduce axis; an FSDP leaf, summed
    over DP by its gather's backward, only over the rest; a MoE leaf (summed
    in the dispatcher) is only cut. Returns the reduced gradients."""
    out = {}
    tp_atoms = set(groups.atoms("attn", "tp"))
    for name, g in grads.items():
        axis = reduce_axis(name)
        lay = None if layouts is None else layouts[name]
        if axis == "dp_cp" and lay is not None and \
                not tp_atoms <= {a for e in lay.state for a in e}:
            axis = "stage"          # a dim TP does not divide: whole, every rank a share
        if lay is not None:
            if lay.zero_dim is not None and axis is None:
                g = _cut(g, lay.zero_dim, groups.atoms(*lay.dp), groups).contiguous()
            elif lay.zero_dim is not None:
                g = comm.reduce_scatter(g, groups.attn["dp"], lay.zero_dim)
            if axis is not None and (lay.zero_dim is not None or lay.fsdp):
                axis = _WITHOUT_DP[axis]
        group = None if axis is None else groups.attn[axis]
        comm.all_reduce_(g, group)
        out[name] = g
    return out


def norm_counted(layouts: Mapping[str, LeafLayout], groups: FoldedGroups) -> Dict[str, bool]:
    """Whether this rank's state shard of each leaf counts in the global
    norm: of the ranks that hold the same shard, the one whose coordinate
    is 0 on every atom that does not cut it. The pipeline atoms do not
    replicate a leaf (each stage holds its own), so they do not count."""
    pp = set(groups.atoms("attn", "pp"))
    coords = {a: groups.atom_index((a,)) for a in groups.atom_names if a not in pp}
    out = {}
    for name, lay in layouts.items():
        cut = {a for e in lay.state for a in e}
        out[name] = all(c == 0 for a, c in coords.items() if a not in cut)
    return out

