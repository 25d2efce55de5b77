"""Restartable training driver: guards + checkpoints + supervisor glue.

Port of ``repro.resilience.driver``. ``run_training`` is the supervised
train loop ``launch/train.py --supervise`` runs and the chaos tests
exercise, on one device or at a fold (``groups``: every rank calls it with
the same arguments). One *attempt* of the loop:

1. anchor: restore from ``latest_step(ckpt_dir, verified=True)`` (corrupt
   or torn steps get quarantined and skipped), or initialize fresh from
   ``run.seed`` (at a fold each rank builds the full weights in turn and
   keeps its store slices);
2. replay: ``SyntheticTokens.seek`` jumps the deterministic data stream to
   the exact batch the restored step count implies — the failed batch is
   re-fetched, not skipped;
3. step loop: each step consults the chaos injector (data error, hang,
   loss-scale fault port), runs the guarded train step
   (``make_train_step(..., guard=, with_loss_scale=True, groups=)``), and
   feeds the loss to the EMA z-score spike detector. A ``step_ok=False``
   step was already discarded (state bitwise unchanged, batch consumed); a
   spike raises :class:`LossSpikeError` so the supervisor rolls the run
   back to the last verified checkpoint;
4. cadence: every ``ckpt_every`` steps the state is saved (the elastic
   sharded format with per-shard sha256), post-save file faults are
   injected, and the retention GC keeps the newest ``keep`` steps.

Recovery parity: restore is bitwise, the data stream is deterministic and
the step is a pure function of state and batch, so a crash-and-replay run
follows the *bitwise identical* trajectory of the fault-free run
(``tests/test_torch_resilience.py`` holds each fault class to it).

Across ranks the faults are symmetric: every rank runs the same plan,
raises at the same step and restarts with the others (the loss, and so the
spike detector's verdict and the guard's flag, are global). Only rank 0
damages a file, and a barrier follows; only rank 0's incident log writes
its file; the checkpoint store's collectives keep the ranks on one step.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.folding import FoldedGroups
from repro_torch.data.pipeline import (DataConfig, SyntheticTokens, mark_runs,
                                       materialize_batch, shard_batch)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import adamw
from repro_torch.resilience.faults import FaultInjector
from repro_torch.resilience.guard import GuardConfig, LossSpikeError, SpikeDetector
from repro_torch.resilience.supervisor import (IncidentLog, Supervisor,
                                               SupervisorConfig, Watchdog)


@dataclasses.dataclass(frozen=True)
class TrainRunConfig:
    steps: int
    ckpt_dir: str
    ckpt_every: int = 10
    keep: Optional[int] = None        # --ckpt-keep: newest N verified steps
    guard: bool = True                # the step's step_ok anomaly guard
    hang_timeout: Optional[float] = None   # watchdog deadline per step (s)
    seed: int = 0
    seq_len: int = 64
    global_batch: int = 8
    # Reference-run knob for the chaos parity tests: consume the batch at
    # these steps but do not run the update — the ground truth a guarded
    # NaN-skip run must match bitwise.
    skip_steps: Tuple[int, ...] = ()


def init_params(cfg: ModelConfig, seed: int, device: torch.device,
                groups: Optional[FoldedGroups] = None):
    """Fresh parameters from ``seed``: the full model on one device, or at
    a fold each rank's store slices of its stage's leaves, the ranks
    building the full weights one at a time (a barrier after each turn) so
    that one card holds one full copy at a time."""
    from repro_torch.models.sharding import shard_lm_params
    from repro_torch.models.transformer import init_lm
    if groups is None:
        return init_lm(cfg, seed=seed, device=device)
    out = None
    for turn in range(groups.world):
        if turn == groups.rank:
            full = init_lm(cfg, seed=seed, device=device, groups=groups)
            out = shard_lm_params(full, groups)
            del full
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def run_training(cfg: ModelConfig, opt_cfg: Optional[adamw.AdamWConfig],
                 run: TrainRunConfig, *, groups: Optional[FoldedGroups] = None,
                 device: DeviceLike = None,
                 injector: Optional[FaultInjector] = None,
                 guard_cfg: Optional[GuardConfig] = None,
                 sup_cfg: Optional[SupervisorConfig] = None,
                 log: Optional[IncidentLog] = None,
                 on_restore: Optional[Callable] = None) -> Dict:
    """Run ``run.steps`` training steps under the full resilience stack.

    Returns ``{"losses": {step: loss}, "grad_norms": {step: norm},
    "skipped": [steps], "restarts": n, "final_step": n, "params": ...,
    "opt": ..., "incidents": [...], "io": [...]}`` (at a fold: this rank's
    state; ``io``: each save's, verified anchor's and restore's wall
    seconds, and a save's bytes and ``PendingSave.timings`` on this rank).
    Faulted runs converge to the fault-free trajectory: crash-class faults
    by bitwise rollback + replay, guarded skips by matching a reference
    run with the same ``skip_steps``. ``on_restore(step, params, opt)`` is
    called after each restore, before the attempt's first step.
    """
    from repro_torch.checkpoint import store
    from repro_torch.train import loop

    device = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    injector = injector or FaultInjector()
    log = log or IncidentLog()
    rank = 0 if groups is None else groups.rank
    if rank:
        log.path = None               # rank 0 alone writes the incident file
    detector_cfg = guard_cfg or GuardConfig()
    data_cfg = DataConfig(seq_len=run.seq_len, global_batch=run.global_batch,
                          vocab_size=cfg.vocab_size, seed=run.seed)
    micro = 0 if groups is None else groups.pcfg.microbatch
    step_fn = loop.make_train_step(cfg, opt_cfg, microbatch=micro, guard=run.guard,
                                   with_loss_scale=True, groups=groups)
    losses: Dict[int, float] = {}
    grad_norms: Dict[int, float] = {}
    skipped: list = []
    io: list = []

    def save(step, params, opt):
        t0, stats = time.perf_counter(), {}
        loop.save_train_state(run.ckpt_dir, step, params, opt, cfg=cfg, groups=groups,
                              meta={"data_step": step}, block=True, stats=stats)
        io.append(dict(op="save", step=step, seconds=time.perf_counter() - t0, **stats))
        try:
            injector.maybe_corrupt_save(step, run.ckpt_dir, damage=rank == 0)  # may raise
        finally:
            if groups is not None:    # rank 0's damage lands before anyone reads
                dist.barrier()
        if run.keep:
            store.gc_steps(run.ckpt_dir, run.keep)

    def attempt(attempt_no: int):
        if attempt_no:
            gc.collect()              # the failed attempt's state
        detector = SpikeDetector(detector_cfg)
        t0 = time.perf_counter()
        start = store.latest_step(run.ckpt_dir, verified=True)
        io.append(dict(op="latest_verified", step=start, seconds=time.perf_counter() - t0))
        if start is None:
            start = 0
            params = init_params(cfg, run.seed, device, groups)
            opt = loop.init_train_state(params, opt_cfg, cfg=cfg, groups=groups)
            save(0, params, opt)
        else:
            t0 = time.perf_counter()
            params, opt = loop.restore_train_state(run.ckpt_dir, start, cfg, opt_cfg,
                                                   groups=groups, device=device)
            io.append(dict(op="restore", step=start, seconds=time.perf_counter() - t0))
            if on_restore is not None:
                on_restore(start, params, opt)
        log.record("attempt_start", attempt=attempt_no, resume_step=start)

        stream = SyntheticTokens(data_cfg).seek(start)
        for step in range(start, run.steps):
            injector.maybe_data_error(step)           # fetch-time fault
            np_batch = mark_runs(materialize_batch(cfg, next(stream)))
            if step in run.skip_steps:                # reference-run skip
                skipped.append(step)
                continue
            ls = injector.loss_scale(step)
            if groups is not None:
                np_batch = shard_batch(np_batch, groups, microbatch=micro)
            batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}
            batch["loss_scale"] = torch.tensor(np.float32(ls), device=device)
            if run.hang_timeout:
                with Watchdog(run.hang_timeout):
                    injector.maybe_hang(step)
                    params, opt, m = step_fn(params, opt, batch)
                    step_loss = float(m["loss"])      # sync inside the watch
            else:
                injector.maybe_hang(step)
                params, opt, m = step_fn(params, opt, batch)
                step_loss = float(m["loss"])
            if run.guard and not bool(m["step_ok"]):
                # The update was discarded; the batch is consumed.
                skipped.append(step)
                log.record("step_skipped", step=step, loss=step_loss,
                           grad_norm=float(m["grad_norm"]))
                continue
            if detector.observe(step_loss):
                log.record("loss_spike", step=step, loss=step_loss,
                           detector=detector.state())
                raise LossSpikeError(
                    f"loss {step_loss:.4g} at step {step} is a "
                    f">{detector_cfg.z_threshold}σ spike — rolling back")
            losses[step] = step_loss
            grad_norms[step] = float(m["grad_norm"])
            if run.ckpt_every and (step + 1) % run.ckpt_every == 0:
                save(step + 1, params, opt)
        if run.ckpt_every and run.steps % run.ckpt_every != 0:
            save(run.steps, params, opt)
        return params, opt

    sup = Supervisor(sup_cfg or SupervisorConfig(backoff_base=0.0), log=log)
    params, opt = sup.run(attempt)
    return {"losses": losses, "grad_norms": grad_norms, "skipped": sorted(set(skipped)),
            "restarts": sup.restarts, "final_step": run.steps,
            "params": params, "opt": opt, "incidents": log.records, "io": io}
