"""AdamW with global-norm clipping, warmup + cosine schedule, a skip guard,
an fp32 master copy and ZeRO-1 state specs.

Port of ``repro.optim.adamw`` (``AdamWConfig``, ``AdamWState``,
``schedule``, ``init``, ``global_norm``, ``update``, ``zero1_spec``,
``adamw_state_specs``, ``zero1_state_bytes``), as plain torch functions
over dicts of tensors keyed by parameter name. Not ``torch.optim.AdamW``:
the reference decays only the leaves it treats as matrices, clips by the
global norm first, and can discard a whole step.

The update runs in place, one slice of ``CHUNK`` elements of a leaf at a
time: the fp32 gradient exists only for the slice being stepped, so the
full-width slice needs no fp32 copy of its gradients. The scalars (norm,
learning rate, bias corrections) stay on the device. The guard's flag is
read on the host, once per step: a skipped step issues no update at all,
where the reference selects old or new per leaf inside its compiled step;
both leave the state bit for bit as it was.

With ``master_weights`` the fp32 source of truth is ``AdamWState.master``:
the update steps it and writes its cast into the parameter, which may be
held in the compute dtype. With fp32 parameters that is the same
arithmetic, so the trajectory is bit for bit the one without a master.

Across ranks (ZeRO-1) each rank steps its *state shard* of every leaf:
the store slice (``models.sharding``) further cut over the data-parallel
atoms of the leaf's side, as :func:`zero1_spec` says; the global norm sums
every distinct shard once over the world. A spec is plain data: per
dimension of the full leaf, the tuple of atom names that cut it
(``core.folding.FoldedGroups.atom_names``, the reference mesh's names).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core.folding import as_layout

Tensors = Dict[str, torch.Tensor]
Spec = Tuple[Tuple[str, ...], ...]
CHUNK = 1 << 26          # elements stepped at a time (256 MB per fp32 temporary)

# Leaves whose state is cut over the MoE side's ``edp`` atoms, not the
# attention side's ``dp``: the reference's ``_MOE_SIDE`` (``experts/``,
# ``moe/shared/``) under the port's names (``convert.SHARED_NAMES``). The
# router is an attention-side leaf there, though it sits in the MoE layer.
MOE_SIDE = re.compile(r"moe\.(w[123]|ws[123]|gate)$")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # fp32 master copy in the state; the parameters may then be held in the
    # compute dtype. Off: the parameters are the fp32 masters.
    master_weights: bool = False


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32, on the parameters' device
    mu: Tensors                  # fp32 first moments, by parameter name
    nu: Tensors                  # fp32 second moments
    master: Optional[Tensors] = None   # fp32 master parameters, or None


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: Tensors, *, master_weights: bool = False) -> AdamWState:
    """Zero moments (fp32) shaped like ``params``; with ``master_weights``
    an fp32 copy of them as the master."""
    device = next(iter(params.values())).device
    zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    master = ({n: p.detach().to(torch.float32, copy=True) for n, p in params.items()}
              if master_weights else None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                      nu={n: torch.zeros_like(z) for n, z in zeros.items()}, master=master)


def _chunks(t: torch.Tensor):
    flat = t.reshape(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=g.device)
    for c in _chunks(g):
        total = total + torch.sum(torch.square(c.float()))
    return total


def global_norm(grads: Tensors, *, counted: Optional[Dict[str, bool]] = None,
                group: Optional[dist.ProcessGroup] = None,
                stages: Optional[Tuple[Optional[dist.ProcessGroup], Sequence[str]]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in fp32: each leaf's
    sum of squares, added leaf after leaf.

    Across ranks, ``grads`` are this rank's slices: ``counted[name]`` says
    whether this rank's slice counts (one replica of each distinct slice
    does, ``models.sharding.norm_counted``), and the sum is summed over
    ``group`` (the ranks of one pipeline stage) before the root. At a
    pipelined fold ``stages`` is ``(the pp group, every leaf name of the
    model in the order a pp = 1 rank adds them)``: each leaf lives on one
    stage, so its sums are exchanged over ``pp`` first and added in that
    order, and the norm is the pp = 1 step's bit for bit.
    """
    dev = next(iter(grads.values())).device
    names = list(grads) if stages is None else stages[1]
    sums = [_square_sum(grads[n]) if n in grads and (counted is None or counted[n]) else None
            for n in names]
    if stages is not None:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        vec = torch.stack([zero if s is None else s for s in sums])
        comm.all_reduce_(vec, stages[0], name="norm")
        sums = list(vec)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in sums:
        if s is not None:
            total = total + s
    comm.all_reduce_(total, group, name="norm")
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tensors, state: AdamWState, params: Tensors, *,
           step_ok: Optional[torch.Tensor] = None,
           decay: Optional[Dict[str, bool]] = None,
           counted: Optional[Dict[str, bool]] = None,
           norm_group: Optional[dist.ProcessGroup] = None,
           norm_stages: Optional[Tuple[Optional[dist.ProcessGroup], Sequence[str]]] = None,
           ) -> Tuple[Tensors, AdamWState, Tensors]:
    """One AdamW step → ``(params, state, metrics)``; ``params`` and the
    state's moments (and master) are updated in place and returned.

    With ``state.master`` the master is stepped in fp32 and ``params``
    receive its cast to their dtype; without it ``params`` are the fp32
    masters. Across ranks, every tensor here is this rank's state shard.

    ``decay[name]`` says which leaves take the decoupled weight decay
    (default: ``ndim >= 2``, the reference's "matrices only"). ``step_ok``
    (a bool tensor, or None to disable) is the anomaly guard: the flag is
    ``step_ok & isfinite(grad_norm)``, and where it is False every leaf,
    moment and the step counter keep their old values bit for bit. The
    flag is returned in ``metrics["step_ok"]``. ``counted``,
    ``norm_group`` and ``norm_stages`` make the clipping norm global across
    ranks (:func:`global_norm`); every rank then reads the same flag.
    """
    gnorm = global_norm(grads, counted=counted, group=norm_group, stages=norm_stages)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip
             else torch.ones_like(gnorm))
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    metrics = {"grad_norm": gnorm, "lr": lr}
    if step_ok is not None:
        ok = torch.logical_and(torch.as_tensor(step_ok, device=gnorm.device),
                               torch.isfinite(gnorm))
        metrics["step_ok"] = ok
        if not bool(ok):            # the step's one host synchronisation
            return params, state, metrics
    for name, p in params.items():
        dec = decay[name] if decay is not None else p.dim() >= 2
        masters = itertools.repeat(None) if state.master is None else \
            _chunks(state.master[name])
        for pc, gc, mc, vc, wc in zip(_chunks(p), _chunks(grads[name]), _chunks(state.mu[name]),
                                      _chunks(state.nu[name]), masters):
            g = gc.to(torch.float32, copy=True).mul_(scale)
            mc.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            vc.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            del g
            delta = torch.div(mc, b1c).div_(torch.div(vc, b2c).sqrt_().add_(cfg.eps))
            w = pc if wc is None else wc
            if dec:                 # decoupled weight decay on matrices only
                delta.add_(w, alpha=cfg.weight_decay)
            w.sub_(delta.mul_(lr))
            if wc is not None:      # the parameter is the master's cast
                pc.copy_(wc)
    return params, AdamWState(step, state.mu, state.nu, state.master), metrics


# ---------------------------------------------------------------------------
# ZeRO-1 partition specs
# ---------------------------------------------------------------------------

def dp_axis(name: str) -> Tuple[str, str]:
    """``(side, axis)`` of the data-parallel atoms that cut the state of
    leaf ``name``: the MoE side's ``edp`` for experts and the shared
    expert, the attention side's ``dp`` otherwise."""
    return ("moe", "edp") if MOE_SIDE.search(name) else ("attn", "dp")


def zero1_spec(name: str, spec: Spec, shape: Sequence[int], layout) -> Spec:
    """Compose one store spec with the DP atoms of the leaf's side.

    The atoms are appended to the first dimension they divide, after the
    store atoms already there (so the DP index is the minor one). A leaf
    whose store spec already holds a DP atom (FSDP) passes through, and so
    does one no dimension of which they divide. ``shape`` is the full
    leaf's; the port's leaves are per layer, so the first dimension is
    never the reference's stacked layer axis."""
    fg = as_layout(layout)
    atoms = fg.atoms(*dp_axis(name))
    spec = tuple(spec) + ((),) * (len(shape) - len(spec))
    if not atoms or set(atoms) & {a for e in spec for a in e}:
        return spec
    n = fg.atom_size(atoms)
    for i, dim in enumerate(shape):
        if dim % (fg.atom_size(spec[i]) * n) == 0:
            return spec[:i] + (spec[i] + atoms,) + spec[i + 1:]
    return spec


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """Full leaf shapes by name, from tensors (any device, ``meta`` too) or
    shapes."""
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def adamw_state_specs(params, layout, *, master_weights: bool = False) -> AdamWState:
    """:class:`AdamWState` of specs for the state of the full leaves
    ``params`` (name → tensor or shape) at ``layout`` (a ``FoldedGroups``
    or a ``ParallelConfig``): the store spec (``models.sharding``) composed
    with :func:`zero1_spec`, one per leaf, shared by ``mu``, ``nu`` and
    ``master``; ``step`` is replicated (``()``)."""
    from repro_torch.models.sharding import leaf_spec
    fg = as_layout(layout)
    tree = {n: leaf_spec(n, s, fg, "state") for n, s in _shapes(params).items()}
    return AdamWState(step=(), mu=tree, nu=tree, master=tree if master_weights else None)


def zero1_state_bytes(params, layout, *, master_weights: bool = True) -> Dict[str, int]:
    """Optimizer-state bytes of the full leaves ``params`` (at a pipelined
    fold, a stage's: ``models.transformer.param_shapes(cfg, groups)``)
    under the ZeRO-1 specs: ``global`` (all of it), ``per_device`` (one
    rank's, every cut exact) and ``replicated`` (the leaves no atom cuts,
    which every rank holds whole)."""
    fg = as_layout(layout)
    specs = adamw_state_specs(params, fg, master_weights=master_weights)
    n_state = 3 if master_weights else 2        # mu, nu(, master): all fp32
    acc = {"global": 0, "per_device": 0, "replicated": 0}
    for name, shape in _shapes(params).items():
        nbytes = math.prod(shape) * 4 * n_state
        shard = fg.atom_size([a for e in specs.mu[name] for a in e])
        acc["global"] += nbytes
        acc["per_device"] += nbytes // shard
        if shard == 1:
            acc["replicated"] += nbytes
    return acc


def state_bytes(state: AdamWState) -> int:
    """Bytes of the optimizer-state tensors a rank holds (moments and
    master), counted from the tensors."""
    trees = (state.mu, state.nu) + ((state.master,) if state.master is not None else ())
    return sum(t.numel() * t.element_size() for tree in trees for t in tree.values())
