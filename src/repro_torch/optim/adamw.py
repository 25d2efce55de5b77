"""AdamW with global-norm clipping, warmup + cosine schedule and a skip guard.

Port of ``repro.optim.adamw`` (``AdamWConfig``, ``AdamWState``,
``schedule``, ``init``, ``global_norm``, ``update``), as plain torch
functions over dicts of tensors keyed by parameter name. Across ranks each
rank steps its own slices; the global norm sums every distinct slice once
over the world. Not ``torch.optim.AdamW``: the reference decays only the
leaves it treats as matrices, clips by the global norm first, and can
discard a whole step.

The update runs in place, one slice of ``CHUNK`` elements of a leaf at a
time: the fp32 gradient exists only for the slice being stepped, so the
full-width slice needs no fp32 copy of its gradients. The scalars (norm,
learning rate, bias corrections) stay on the device. The guard's flag is
read on the host, once per step: a skipped step issues no update at all,
where the reference selects old or new per leaf inside its compiled step;
both leave the state bit for bit as it was. ZeRO-1 sharding of the state
(``adamw_state_specs``) and the fp32 master copy (``master_weights``) are
not ported (ROADMAP.md queue 1, 'Sharded training').
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

Tensors = Dict[str, torch.Tensor]
CHUNK = 1 << 26          # elements stepped at a time (256 MB per fp32 temporary)


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
    # ZeRO-1 fp32 master copy in the state: not ported (init/update raise).
    master_weights: bool = False


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32, on the parameters' device
    mu: Tensors                  # fp32 first moments, by parameter name
    nu: Tensors                  # fp32 second moments
    master: Optional[Tensors] = None


def _no_master(flag) -> None:
    if flag:
        raise NotImplementedError("AdamW master_weights (ZeRO-1 fp32 master copy) is "
                                  "not ported (ROADMAP.md queue 1, 'Sharded training')")


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: Tensors, *, master_weights: bool = False) -> AdamWState:
    _no_master(master_weights)
    device = next(iter(params.values())).device
    zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                      nu={n: torch.zeros_like(z) for n, z in zeros.items()})


def _chunks(t: torch.Tensor):
    flat = t.reshape(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(grads: Tensors, *, counted: Optional[Dict[str, bool]] = None,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in fp32.

    Across ranks, ``grads`` are this rank's slices: ``counted[name]`` says
    whether this rank's slice counts (one replica of each distinct slice
    does, ``models.sharding.norm_counted``), and the sum of squares is
    summed over ``group`` (every rank that holds a slice) before the root.
    """
    total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for name, g in grads.items():
        if counted is None or counted[name]:
            for c in _chunks(g):
                total = total + torch.sum(torch.square(c.float()))
    if group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tensors, state: AdamWState, params: Tensors, *,
           step_ok: Optional[torch.Tensor] = None,
           decay: Optional[Dict[str, bool]] = None,
           counted: Optional[Dict[str, bool]] = None,
           norm_group: Optional[dist.ProcessGroup] = None,
           ) -> Tuple[Tensors, AdamWState, Tensors]:
    """One AdamW step → ``(params, state, metrics)``; ``params`` and the
    state's moments are updated in place and returned.

    ``decay[name]`` says which leaves take the decoupled weight decay
    (default: ``ndim >= 2``, the reference's "matrices only"). ``step_ok``
    (a bool tensor, or None to disable) is the anomaly guard: the flag is
    ``step_ok & isfinite(grad_norm)``, and where it is False every leaf,
    moment and the step counter keep their old values bit for bit. The
    flag is returned in ``metrics["step_ok"]``. ``counted`` and
    ``norm_group`` make the clipping norm global across ranks
    (:func:`global_norm`); every rank then reads the same flag.
    """
    _no_master(state.master is not None)
    gnorm = global_norm(grads, counted=counted, group=norm_group)
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
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[name]), _chunks(state.mu[name]),
                                  _chunks(state.nu[name])):
            g = gc.to(torch.float32, copy=True).mul_(scale)
            mc.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            vc.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            del g
            delta = torch.div(mc, b1c).div_(torch.div(vc, b2c).sqrt_().add_(cfg.eps))
            if dec:                 # decoupled weight decay on matrices only
                delta.add_(pc, alpha=cfg.weight_decay)
            pc.sub_(delta.mul_(lr))
    return params, AdamWState(step, state.mu, state.nu), metrics
