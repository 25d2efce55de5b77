"""Training step, on one device or at a folded mapping: mixed precision,
remat, gradient accumulation, MoE aux losses, the loss-scale fault port and
the anomaly guard.

Port of ``repro.train.loop`` (``cast_params``, ``aux_loss_coefs``,
``assemble_loss_metrics``, ``loss_fn``, ``make_train_step``,
``train_state_structs``, ``save_train_state``, ``restore_train_state``:
the reference's elastic checkpoints, which either package reads at any
fold). ``make_train_step`` returns

    step(params, opt_state, batch) -> (params, opt_state, metrics)

* ``params`` (:class:`LMParams`) hold the fp32 masters, or with
  ``AdamWConfig.master_weights`` their compute-dtype casts (the masters are
  then in the optimizer state), and are updated in place by
  :func:`repro_torch.optim.adamw.update`;
* the cast to the compute dtype is hoisted out of the loss: the backward
  runs on the compute copies (the cast's derivative is 1), whose gradients
  the optimizer reads slice by slice in fp32;
* ``remat`` and ``microbatch`` mirror the ``ParallelConfig`` fields of the
  same names;
* with ``groups`` (``core.folding.build_folded_groups``) every rank runs the
  step on its store slices (``models.sharding.shard_lm_params``; FSDP
  leaves are gathered over DP where a layer uses them) and its share of
  the batch (``data.pipeline.shard_batch``): attention over TP and CP, the
  MoE layer over EDP×EP×ETP, the vocabulary-parallel loss. After the
  backward each gradient is reduced to the rank's ZeRO-1 state shard
  (``models.sharding.reduce_grads`` with the leaves' layouts), the
  clipping norm is global, AdamW steps each rank's state shards, and the
  leaves whose state cuts the store slice further are all-gathered over
  DP into it;
* at a fold with pipeline stages (``pp > 1``: 1F1B; ``vpp > 1``:
  interleaved) a rank holds only its stage's leaves
  (``core.pipeline.Stage``) and the forward and backward are
  ``core.pipeline.make_pipeline_grads``: its stage's ops of the schedule
  over ``microbatch`` slices, activations and their gradients sent point
  to point between stages. Gradients and metrics get the pp = 1 loop's
  division by the microbatch count, the clipping norm sums over the
  stages too, and every stage reads the same guard flag, so the step is
  the pp = 1 step's.

The JAX package stacks every layer's parameters over the layer repeats, so
a per-layer norm or router has one axis more there than here. Its cast
("matrices", ``ndim >= 2``) and its weight decay (the same test) read that
rank; :func:`leaf_rank` gives it, so both packages cast and decay the same
leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.folding import FoldedGroups
from repro_torch.models import sharding
from repro_torch.models.transformer import LMParams, apply_lm, leaf_rank, lm_loss, param_shapes
from repro_torch.optim import adamw

Tensors = Dict[str, torch.Tensor]
REMAT = ("full", "none")


def _cast(name: str, t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's cast of one fp32 leaf: matrices (``leaf_rank >= 2``)
    to the compute dtype; other leaves, and leaves already cast, as they are."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return t.to(dt) if t.dtype == torch.float32 and leaf_rank(name, t) >= 2 else t


def cast_params(params: LMParams, cfg: ModelConfig) -> LMParams:
    """fp32 masters → compute copies: the same module tree with new leaf
    parameters (``requires_grad``), matrices (rank >= 2) in the config's
    compute dtype and the rest (the final norm) sharing the fp32 master's
    storage. Gradients land on the copies, not on ``params``. Leaves held
    in the compute dtype already (``master_weights``) share their storage."""
    return sharding.map_params(params, lambda n, t: _cast(n, t, cfg))


def aux_loss_coefs(cfg: ModelConfig) -> Dict[str, float]:
    """Coefficient of each aux output in the loss (0 for metrics-only keys)."""
    coefs = {"moe_aux_loss": 0.0, "moe_z_loss": 0.0, "moe_drop_fraction": 0.0}
    if cfg.moe is not None:
        coefs["moe_aux_loss"] = cfg.moe.aux_loss_coef
        coefs["moe_z_loss"] = cfg.moe.z_loss_coef
    return coefs


def assemble_loss_metrics(ce: torch.Tensor, n_tok: torch.Tensor, aux: Tensors,
                          cfg: ModelConfig) -> Tuple[torch.Tensor, Tensors]:
    """(ce, aux) → (total loss, metric dict); ``aux`` is already averaged
    over the MoE layers."""
    loss = ce
    metrics = {"ce_loss": ce, "tokens": n_tok}
    if cfg.moe is not None:
        coefs = aux_loss_coefs(cfg)
        for k, c in coefs.items():     # ((ce + aux) + z): fixed fp order
            if c:
                loss = loss + c * aux[k]
        metrics.update({k: aux[k] for k in coefs})
    metrics["loss"] = loss
    return loss, metrics


def loss_fn(cparams: LMParams, batch: Tensors, cfg: ModelConfig, *,
            remat: bool = True, groups: Optional[FoldedGroups] = None
            ) -> Tuple[torch.Tensor, Tensors]:
    """The objective on the compute copies (:func:`cast_params`). With
    ``groups``, every rank returns the global loss and metrics and
    back-propagates its own share."""
    logits, aux = apply_lm(cparams, batch, cfg, remat=remat, groups=groups)
    ce, n_tok = lm_loss(cparams, logits, batch["labels"], cfg, groups)
    return assemble_loss_metrics(ce, n_tok, aux, cfg)


def _grads_of(cparams: LMParams, batch: Tensors, cfg: ModelConfig, remat: bool,
              groups: Optional[FoldedGroups]) -> Tuple[Tensors, Tensors]:
    loss, metrics = loss_fn(cparams, batch, cfg, remat=remat, groups=groups)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in cparams.named_parameters()}
    return grads, {k: v.detach() for k, v in metrics.items()}


def loss_and_grads(params: LMParams, batch: Tensors, cfg: ModelConfig, *,
                   remat: bool = True, microbatch: int = 0,
                   groups: Optional[FoldedGroups] = None) -> Tuple[Tensors, Tensors]:
    """The step's forward and backward → (gradients by name, metrics).

    ``microbatch`` > 1 splits the batch into that many slices and averages
    their fp32 gradients and metrics. With ``groups``, ``params`` are the
    rank's store slices and the gradients are then reduced to its ZeRO-1
    state shards (``models.sharding.reduce_grads``): every replica of a
    shard holds the same gradient. At a pipelined fold ``params`` are its
    stage's, and the pipeline schedule runs the ``microbatch`` slices (at
    least one; fp32 gradients)."""
    from repro_torch.core import pipeline as pl
    cparams = cast_params(params, cfg)
    if pl.pipelined(groups):
        n_micro = max(microbatch, 1)
        part = pl.stage_partition_for(cfg, groups.pp_degree, groups.pcfg.vpp)
        grads, metrics = pl.make_pipeline_grads(cfg, groups, part, n_micro,
                                                remat=remat)(cparams, batch)
        grads = {n: t / n_micro for n, t in grads.items()}
        metrics = {k: v / n_micro for k, v in metrics.items()}
    elif microbatch and microbatch > 1:
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} not divisible by microbatch {microbatch}")
        mb = B // microbatch
        grads, metrics = None, None
        for i in range(microbatch):
            g, m = _grads_of(cparams, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()},
                             cfg, remat, groups)
            for p in cparams.parameters():
                p.grad = None
            if grads is None:
                grads = {n: t.float() for n, t in g.items()}
                metrics = m
            else:
                for n, t in g.items():
                    grads[n] += t.float()
                metrics = {k: metrics[k] + m[k] for k in metrics}
            del g
        grads = {n: t / microbatch for n, t in grads.items()}
        metrics = {k: v / microbatch for k, v in metrics.items()}
    else:
        grads, metrics = _grads_of(cparams, batch, cfg, remat, groups)
    del cparams
    if groups is not None:
        grads = sharding.reduce_grads(grads, groups, _layouts(params, groups, cfg))
    return grads, metrics


def grad_norm(grads: Tensors, groups: Optional[FoldedGroups] = None,
              params: Optional[LMParams] = None, cfg: Optional[ModelConfig] = None
              ) -> torch.Tensor:
    """The global gradient norm: across ranks, each distinct state shard
    once (``grads`` from :func:`loss_and_grads`, ``params`` the store
    slices they belong to; ``cfg`` at a pipelined fold)."""
    if groups is None:
        return adamw.global_norm(grads)
    layouts = _layouts(params, groups, cfg)
    norm = _norm_args(layouts, groups, cfg)
    return adamw.global_norm(grads, counted=norm["counted"], group=norm["norm_group"],
                             stages=norm["norm_stages"])


def _layouts(params: LMParams, groups: FoldedGroups, cfg: Optional[ModelConfig]
             ) -> Dict[str, sharding.LeafLayout]:
    """The layout of each of this rank's store slices, from the full leaves'
    shapes: a slice does not tell a cut dim from one kept whole."""
    if cfg is None:
        raise ValueError("a folded step needs cfg: the leaves' layouts come from its shapes")
    return sharding.layouts_of((n for n, _ in params.named_parameters()), groups,
                               param_shapes(cfg, groups))


def _norm_args(layouts, groups: FoldedGroups, cfg: Optional[ModelConfig]) -> Dict:
    """``adamw.update``'s arguments for the global norm at a fold: which
    shards count, the stage's group, and at a pipelined fold the pp group
    with every leaf name in the pp = 1 order (``param_shapes``')."""
    from repro_torch.core.pipeline import pipelined, stage_of
    stages = None
    counted = sharding.norm_counted(layouts, groups)
    if pipelined(groups):
        if cfg is None:
            raise ValueError("grad_norm at a pipelined fold needs cfg (the model's leaf order)")
        stages = (groups.attn["pp"].group, tuple(param_shapes(cfg)))
        if "embed" in counted and not stage_of(cfg, groups).first:
            counted["embed"] = False          # tied: the first stage counts it
    return dict(counted=counted, norm_group=groups.attn["stage"].group, norm_stages=stages)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                    remat: str = "full", microbatch: int = 0, guard: bool = False,
                    with_loss_scale: bool = False,
                    groups: Optional[FoldedGroups] = None) -> Callable:
    """Build the train step (see the module docstring).

    ``remat``: ``"full"`` recomputes each layer's forward in the backward,
    ``"none"`` keeps its activations. ``microbatch`` > 1 splits the batch
    into that many slices and averages their fp32 gradients.
    ``guard=True``: ``step_ok = isfinite(loss) & isfinite(grad_norm)``, and a
    False flag leaves params and optimizer state bit for bit as they were
    (``metrics["step_ok"]``). ``with_loss_scale=True`` requires an fp32
    scalar ``batch["loss_scale"]`` multiplied into the gradients and the
    loss metric after the backward (1.0 is a bitwise no-op; NaN makes a
    guarded skip). ``groups``: the folded mapping; ``params`` (store
    slices, ``models.sharding.shard_lm_params``; of its pipeline stage at
    pp > 1), ``opt_state`` (:func:`init_train_state` with the same
    ``groups``) and ``batch`` (``data.pipeline.shard_batch`` with the same
    ``microbatch``) are then this rank's. A skipped step skips the
    parameter gather on every rank alike: the flag comes from the global
    loss and norm.
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    use_remat = remat != "none"

    def step(params: LMParams, opt_state: adamw.AdamWState, batch: Tensors):
        batch = dict(batch)
        ls = batch.pop("loss_scale", None)
        if with_loss_scale and ls is None:
            raise ValueError("this step was built with_loss_scale: batch needs 'loss_scale'")
        grads, metrics = loss_and_grads(params, batch, cfg, remat=use_remat,
                                        microbatch=microbatch, groups=groups)
        if ls is not None:
            ls = torch.as_tensor(ls, dtype=torch.float32, device=metrics["loss"].device)
            grads = {n: t.float() * ls for n, t in grads.items()}
            metrics["loss"] = metrics["loss"] * ls
        named = dict(params.named_parameters())
        step_ok = torch.isfinite(metrics["loss"]) if guard else None
        decay = {n: leaf_rank(n, p) >= 2 for n, p in named.items()}
        if groups is None:
            shards, norm = named, {}
        else:
            layouts = _layouts(params, groups, cfg)
            shards = {n: sharding.state_view(p.data, layouts[n], groups)
                      for n, p in named.items()}
            norm = _norm_args(layouts, groups, cfg)
        with torch.profiler.record_function("adamw update"):
            _, opt_state, opt_m = adamw.update(opt_cfg, grads, opt_state, shards,
                                               step_ok=step_ok, decay=decay, **norm)
        metrics.update(opt_m)
        # The guard's verdict, read once a step and only with a guard (the
        # dry run and the audit trace the step without one).
        no_guard = step_ok is None
        if groups is not None and (no_guard or bool(opt_m["step_ok"])):  # lint-ok: host-sync-branch
            sharding.gather_state(named, shards, layouts, groups)
        return params, opt_state, metrics

    return step


def init_train_state(params: LMParams, opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                     cfg: Optional[ModelConfig] = None,
                     groups: Optional[FoldedGroups] = None) -> adamw.AdamWState:
    """Zero AdamW state for ``params`` (on their device); with ``groups``
    only this rank's ZeRO-1 state shards of its store slices (of its
    pipeline stage's leaves, which are all ``params`` hold). With
    ``opt_cfg.master_weights`` the state holds an fp32 master of each
    shard, and the matrices of ``params`` (``leaf_rank >= 2``) are cast in
    place to ``cfg``'s compute dtype, the reference's ``cast_params``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    named = dict(params.named_parameters())
    if groups is not None:
        layouts = _layouts(params, groups, cfg)
        named = {n: sharding.state_view(p.detach(), layouts[n], groups)
                 for n, p in named.items()}
    state = adamw.init(named, master_weights=opt_cfg.master_weights)
    if opt_cfg.master_weights:
        if cfg is None:
            raise ValueError("init_train_state(master_weights=True) needs cfg: the params "
                             "are cast to its compute dtype")
        for n, p in params.named_parameters():
            p.data = _cast(n, p.data, cfg)
    return state


def train_state_structs(cfg: ModelConfig, opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                        groups: Optional[FoldedGroups] = None
                        ) -> Tuple[Dict[str, torch.Tensor], adamw.AdamWState]:
    """``(params, opt_state)`` as held at rest, as ``meta`` tensors by name:
    the full leaves, or with ``groups`` this rank's store slices and state
    shards (of its pipeline stage's leaves at pp > 1). With
    ``master_weights`` the params are the compute-dtype casts and the state
    holds the fp32 masters."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def meta(name, shape, kind):
        if groups is not None:
            spec = sharding.leaf_spec(name, shape, groups, kind)
            shape = tuple(d // groups.atom_size(a) for d, a in zip(shape, spec))
        return torch.empty(shape, dtype=torch.float32, device="meta")

    full = param_shapes(cfg, groups)
    params = {n: meta(n, s, "store") for n, s in full.items()}
    if opt_cfg.master_weights:
        params = {n: _cast(n, t, cfg) for n, t in params.items()}
    moments = {n: meta(n, s, "state") for n, s in full.items()}
    return params, adamw.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"), mu=moments, nu=dict(moments),
        master=dict(moments) if opt_cfg.master_weights else None)


# ---------------------------------------------------------------------------
# Elastic checkpoints (checkpoint/store.py's sharded format)
# ---------------------------------------------------------------------------

def _box(name: str, shape: Tuple[int, ...], cfg: ModelConfig, groups: Optional[FoldedGroups],
         kind: str) -> Tuple[Tuple[int, int], ...]:
    """The box of this rank's ``kind`` slice of leaf ``name`` (full
    ``shape``) in the JAX tree's leaf, which stacks the layers."""
    from repro_torch.convert import jax_key
    spec = ((),) * len(shape) if groups is None else sharding.leaf_spec(name, shape, groups, kind)
    box = []
    for d, atoms in zip(shape, spec):
        n, i = groups.atom_size(atoms) if atoms else 1, groups.atom_index(atoms) if atoms else 0
        box.append((i * (d // n), (i + 1) * (d // n)))
    rep = jax_key(name, cfg)[1]
    return (() if rep is None else ((rep, rep + 1),)) + tuple(box)


def _state_leaves(cfg: ModelConfig, master_weights: bool):
    """``(key, part, name, shape, kind, dtype)`` of every piece of the train
    state, all stages': ``part`` is ``params`` or the AdamW field, ``key``
    the checkpoint's (``params/<JAX key>``, ``opt/.mu/<JAX key>``)."""
    from repro_torch.convert import jax_key
    full = param_shapes(cfg)
    for name, shape in full.items():
        dt = torch.float32
        if master_weights:
            dt = _cast(name, torch.empty(shape, dtype=dt, device="meta"), cfg).dtype
        yield "params/" + jax_key(name, cfg)[0], "params", name, shape, "store", dt
    for part in ("mu", "nu") + (("master",) if master_weights else ()):
        for name, shape in full.items():
            yield (f"opt/.{part}/" + jax_key(name, cfg)[0], part, name, shape, "state",
                   torch.float32)


def train_state_tree(cfg: ModelConfig, params: Optional[LMParams] = None,
                     opt_state: Optional[adamw.AdamWState] = None, *,
                     master_weights: Optional[bool] = None,
                     groups: Optional[FoldedGroups] = None) -> Dict[str, "ShardedLeaf"]:
    """``(params, opt_state)`` as ``checkpoint.store``'s tree: every leaf of
    the model under the reference's keys (``params/...``, ``opt/.step``,
    ``opt/.mu/...``, ``opt/.nu/...``, with ``master_weights``
    ``opt/.master/...``), its stacked global shape and dtype at rest, and
    this rank's pieces: the store slice of each parameter and the state
    shard of each moment (a box ``[l, l + 1)`` on the stack axis for layer
    ``l``), of its stage's leaves. Without ``params`` the pieces are the
    ``meta`` tensors of :func:`train_state_structs`: a restore target."""
    from repro_torch.checkpoint.store import ShardedLeaf
    from repro_torch.convert import stacked_shape
    if params is None:
        like_p, opt_state = train_state_structs(
            cfg, adamw.AdamWConfig(master_weights=bool(master_weights)), groups=groups)
    else:
        like_p = dict(params.named_parameters())
    master = opt_state.master is not None
    trees = {"params": like_p, "mu": opt_state.mu, "nu": opt_state.nu,
             "master": opt_state.master}
    out: Dict[str, Any] = {"opt/.step": opt_state.step.detach()}
    for key, part, name, shape, kind, dt in _state_leaves(cfg, master):
        leaf = out.get(key) or ShardedLeaf(stacked_shape(name, shape, cfg), dt, ())
        t = trees[part].get(name)
        if t is not None:
            if len(leaf.shape) > len(shape):      # a layer: one index of the stack axis
                t = t.unsqueeze(0)
            leaf = leaf._replace(pieces=leaf.pieces + ((_box(name, shape, cfg, groups, kind),
                                                        t.detach()),))
        out[key] = leaf
    return out


def save_train_state(directory: str, step: int, params: LMParams,
                     opt_state: adamw.AdamWState, *, cfg: ModelConfig,
                     groups: Optional[FoldedGroups] = None, meta=None, block: bool = True,
                     stats: Optional[Dict[str, float]] = None):
    """Checkpoint (params, opt_state) in the reference's elastic sharded
    format (:func:`train_state_tree`; at a fold, every rank calls it).

    ``block=False`` returns a ``store.PendingSave``: the device→host copies
    are taken before it returns, so the step loop may update the state in
    place at once while a background thread hashes and writes; its
    ``wait()`` commits (every rank). ``stats`` receives this rank's save
    timings and bytes (``store.save_sharded``).
    """
    from repro_torch.checkpoint import store
    return store.save_sharded(directory, step, train_state_tree(cfg, params, opt_state,
                                                                groups=groups),
                              meta=meta, block=block, stats=stats)


def restore_train_state(directory: str, step: int, cfg: ModelConfig,
                        opt_cfg: Optional[adamw.AdamWConfig] = None, *,
                        groups: Optional[FoldedGroups] = None, device=None,
                        verify: bool = False) -> Tuple[LMParams, adamw.AdamWState]:
    """Restore (params, opt_state) onto ``groups``' fold — which may be
    another mapping or world size than the run that saved the checkpoint,
    or the JAX package's — on ``device``.

    The target is what :func:`train_state_structs` gives at that fold, with
    its pipeline stages: each rank's store slices and state shards are
    assembled from the source boxes (``store.restore_sharded``), with no
    collective."""
    from repro_torch.checkpoint import store
    from repro_torch.convert import lm_params
    from repro_torch.device import resolve_device
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    like = train_state_tree(cfg, master_weights=opt_cfg.master_weights, groups=groups)
    got = store.restore_sharded(directory, step, like, verify=verify,
                                device=resolve_device(device))
    trees: Dict[str, Tensors] = {"params": {}, "mu": {}, "nu": {}, "master": {}}
    taken: Dict[str, int] = {}
    held = param_shapes(cfg, groups)          # this rank's stage's leaves
    for key, part, name, shape, _, _ in _state_leaves(cfg, opt_cfg.master_weights):
        if name in held:
            i = taken.get(key, 0)
            t = got[key].pieces[i][1]
            trees[part][name] = t[0] if t.dim() > len(shape) else t
            taken[key] = i + 1
    return lm_params(trees["params"], cfg), adamw.AdamWState(
        step=got["opt/.step"], mu=trees["mu"], nu=trees["nu"],
        master=trees["master"] if opt_cfg.master_weights else None)
