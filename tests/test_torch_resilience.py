"""The port's resilience stack against the JAX package's, on the CPU.

* The host classes (copies) give the JAX package's outputs on the same
  inputs: ``FaultPlan.random``, the injector firing each fault once, the
  chaos primitives' bytes, the spike detector, the watchdog, the
  supervisor's backoff and budget, the incident log.
* ``run_training`` on a small Mixtral (2 layers, 4 experts, one process):
  each crash fault kind recovers with one restart to losses bit for bit
  equal to the fault-free run's; a ``nan_grad`` step is skipped exactly
  as a ``skip_steps`` run skips it; retention and the restart budget; a
  plan of several faults makes the incident sequence JAX's
  ``run_training`` makes on the same plan and cadence (its own small
  model: the sequence depends on the plan, not the model).
* A gloo world of 4 (attention DP2×TP2 / MoE EDP2×EP2): a corrupt shard
  (rank 0 flips it, every rank restarts, the verify is split) and a hung
  step (each rank's watchdog interrupts its own process) recover to the
  world's fault-free losses bit for bit.

All comparisons are exact. JAX is imported inside the test functions
only: the world's processes import this module to find their worker.
"""
import dataclasses
import os
import shutil
import time
from functools import lru_cache

import numpy as np
import pytest

from repro_torch.resilience import (DataStreamError, Fault, FaultInjector, FaultPlan,
                                    GuardConfig, HungStepError, IncidentLog, SimulatedCrash,
                                    SpikeDetector, Supervisor, SupervisorConfig,
                                    TrainRunConfig, Watchdog, run_training)
from repro_torch.resilience import faults as pfaults

STEPS, EVERY = 8, 3
WORLD_STEPS = 6             # the world of 4's runs: saves at 0, 3, 6; faults at step 4
GUARD = GuardConfig(warmup_obs=1, min_std=1.0)
CRASH_KINDS = ("corrupt_shard", "torn_save", "data_error", "loss_spike", "hung_step")


def _jres():
    import repro.resilience as jres
    return jres


# ---------------------------------------------------------------------------
# Host classes: the same outputs as JAX's
# ---------------------------------------------------------------------------

def _plan_tuple(plan):
    return [(f.kind, f.step, f.spike_scale, f.hang_seconds) for f in plan.faults]


@pytest.mark.parametrize("seed", range(4))
def test_fault_plan_random_matches_jax(seed):
    j = _jres()
    for n in (1, 3):
        mine = FaultPlan.random(seed, steps=STEPS, n_faults=n, hang_seconds=3.0)
        theirs = j.FaultPlan.random(seed, steps=STEPS, n_faults=n, hang_seconds=3.0)
        assert _plan_tuple(mine) == _plan_tuple(theirs)
        assert pfaults.summarize(mine) == j.faults.summarize(theirs)
    for kw in (dict(kind="bogus", step=1), dict(kind="nan_grad", step=-1)):
        with pytest.raises(ValueError) as a:
            Fault(**kw)
        with pytest.raises(ValueError) as b:
            j.Fault(**kw)
        assert str(a.value) == str(b.value)


def _tiny_ckpt(directory):
    from repro_torch.checkpoint import store
    import torch
    for step in range(4):
        store.save_sharded(directory, step, {"w": torch.arange(64, dtype=torch.float32)})


def _drive_injector(inj, directory):
    """Every hook at every step; what each returned or raised."""
    out = []
    for step in range(4):
        out.append(("scale", step, repr(inj.loss_scale(step))))
        for hook in (lambda: inj.maybe_data_error(step), lambda: inj.maybe_hang(step),
                     lambda: inj.maybe_corrupt_save(step, directory)):
            try:
                out.append(("ok", step, hook()))
            except (RuntimeError, OSError) as e:
                out.append((type(e).__name__, step, str(e).replace(directory, "<dir>")))
    return out + [(f.kind, f.step) for f in inj.fired]


def test_injector_fires_each_fault_once_as_jax_does(tmp_path):
    j = _jres()
    faults = [("nan_grad", 0), ("loss_spike", 1), ("data_error", 1), ("corrupt_shard", 1),
              ("torn_save", 2), ("hung_step", 3), ("data_error", 3)]
    mine_dir, their_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _tiny_ckpt(mine_dir)
    _tiny_ckpt(their_dir)
    mine = _drive_injector(FaultInjector(FaultPlan(tuple(Fault(k, s, hang_seconds=0.01)
                                                         for k, s in faults))), mine_dir)
    theirs = _drive_injector(j.FaultInjector(j.FaultPlan(tuple(j.Fault(k, s, hang_seconds=0.01)
                                                              for k, s in faults))), their_dir)
    assert mine == theirs
    for step in range(4):         # the same files damaged the same way
        for f in ("shards_00000.npz",):
            a, b = (os.path.join(d, f"ckpt_{step:08d}", f) for d in (mine_dir, their_dir))
            assert open(a, "rb").read() == open(b, "rb").read()
        assert os.path.exists(os.path.join(mine_dir, f"ckpt_{step:08d}.done")) == \
            os.path.exists(os.path.join(their_dir, f"ckpt_{step:08d}.done"))


def test_chaos_primitives_touch_the_same_bytes(tmp_path):
    j = _jres()
    _tiny_ckpt(str(tmp_path / "a"))
    src = str(tmp_path / "a" / "ckpt_00000000" / "shards_00000.npz")
    copies = [str(tmp_path / f"{i}.npz") for i in range(2)]
    for c in copies:
        shutil.copy(src, c)
    assert pfaults.flip_npz_byte(copies[0]) == j.flip_npz_byte(copies[1])
    assert pfaults.truncate_file(copies[0], 0.3) == j.truncate_file(copies[1], 0.3)
    assert open(copies[0], "rb").read() == open(copies[1], "rb").read()


def test_spike_detector_matches_jax():
    j = _jres()
    rng = np.random.default_rng(0)
    stream = list(5.0 + 0.01 * rng.standard_normal(12)) + [60.0, 5.0, float("nan"), 5.02, 9e3]
    for cfg in (dict(), dict(warmup_obs=1, min_std=1.0), dict(z_threshold=2.0, ema_decay=0.5)):
        mine, theirs = SpikeDetector(GuardConfig(**cfg)), j.SpikeDetector(j.GuardConfig(**cfg))
        assert [mine.observe(x) for x in stream] == [theirs.observe(x) for x in stream]
        assert mine.state() == theirs.state()


def test_watchdog_matches_jax():
    j = _jres()
    for dog, err in ((Watchdog, HungStepError), (j.Watchdog, j.HungStepError)):
        with pytest.raises(err, match="watchdog deadline"):
            with dog(0.05):
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    time.sleep(0.01)
        with dog(5.0):            # a fast step: silent
            pass


def _records(log):
    return [{k: v for k, v in r.items() if k != "time"} for r in log.records]


def test_supervisor_backoff_budget_and_log_match_jax(tmp_path):
    j = _jres()
    cfg = dict(max_restarts=2, backoff_base=0.5, backoff_max=3.0, jitter=0.25, seed=7)
    mine, theirs = Supervisor(SupervisorConfig(**cfg)), j.Supervisor(j.SupervisorConfig(**cfg))
    assert [mine.backoff(a) for a in range(6)] == [theirs.backoff(a) for a in range(6)]

    def flaky(errors):
        def fn(attempt):
            if attempt < len(errors):
                raise errors[attempt]("transient")
            return attempt
        return fn
    quick = dict(max_restarts=2, backoff_base=0.0)
    for errs, jerrs in (((DataStreamError, SimulatedCrash), (j.DataStreamError,
                                                              j.SimulatedCrash)),
                        ((DataStreamError,) * 3, (j.DataStreamError,) * 3),
                        ((KeyError,), (KeyError,))):
        logs = []
        for sup_cls, cfg_cls, log, es in ((Supervisor, SupervisorConfig,
                                           IncidentLog(str(tmp_path / "p.jsonl")), errs),
                                          (j.Supervisor, j.SupervisorConfig,
                                           j.IncidentLog(str(tmp_path / "j.jsonl")), jerrs)):
            sup = sup_cls(cfg_cls(**quick), log=log)
            try:
                logs.append(("returned", sup.run(flaky(es)), sup.restarts, _records(log)))
            except Exception as e:
                logs.append((type(e).__name__, str(e), sup.restarts, _records(log)))
        assert logs[0] == logs[1]
    read = [[{k: v for k, v in r.items() if k != "time"} for r in cls.read(str(tmp_path / f))]
            for cls, f in ((IncidentLog, "p.jsonl"), (j.IncidentLog, "j.jsonl"))]
    assert read[0] == read[1] and len(read[0]) > 4


# ---------------------------------------------------------------------------
# run_training on one device: every crash kind back to the fault-free run
# ---------------------------------------------------------------------------

@lru_cache
def _cfg():
    from repro_torch.launch.train import train_config
    cfg = train_config("mixtral-8x22b", reduce=True)
    return dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                               vocab_size=256,
                               moe=dataclasses.replace(cfg.moe, d_expert=64))


def _opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=STEPS)


def drive(ckpt_dir, *, plan=None, skip=(), hang_timeout=None, sup=None, log=None, keep=None,
          groups=None, steps=STEPS):
    run = TrainRunConfig(steps=steps, ckpt_dir=str(ckpt_dir), ckpt_every=EVERY, keep=keep,
                         hang_timeout=hang_timeout, seq_len=16, global_batch=4 if groups is None
                         else 2, skip_steps=tuple(skip))
    return run_training(_cfg(), _opt(), run, groups=groups, device="cpu",
                        injector=FaultInjector(plan) if plan else None, guard_cfg=GUARD,
                        sup_cfg=sup, log=log)


_REF = {}


def _ref(tmp_path_factory, skip=()):
    """The fault-free trajectory, memoized per skip set."""
    if skip not in _REF:
        _REF[skip] = drive(tmp_path_factory.mktemp("ref"), skip=skip)["losses"]
    return _REF[skip]


def _kind_kw(kind):
    """A hung step's knobs: it blocks 30 s and the watchdog fires at 3 s, a
    deadline no real step of this model nears even on a loaded host."""
    return ({"hang_seconds": 30.0}, 3.0) if kind == "hung_step" else ({}, None)


@pytest.mark.parametrize("kind", CRASH_KINDS)
def test_crash_fault_recovers_bitwise(kind, tmp_path, tmp_path_factory):
    kw, hang = _kind_kw(kind)
    out = drive(tmp_path, plan=FaultPlan.single(kind, 4, **kw), hang_timeout=hang)
    assert out["restarts"] == 1 and out["skipped"] == []
    assert out["losses"] == _ref(tmp_path_factory)        # every step, bit for bit
    kinds = [r["incident"] for r in out["incidents"]]
    assert "restart" in kinds and "recovered" in kinds
    if kind == "corrupt_shard":
        assert any(f.endswith(".quarantined") for f in os.listdir(tmp_path))


def test_nan_grad_skip_matches_a_run_skipping_that_step(tmp_path, tmp_path_factory):
    out = drive(tmp_path, plan=FaultPlan.single("nan_grad", 3))
    assert out["restarts"] == 0 and out["skipped"] == [3]
    assert out["losses"] == _ref(tmp_path_factory, (3,))
    assert any(r["incident"] == "step_skipped" for r in out["incidents"])


def test_retention_and_restart_budget(tmp_path):
    from repro_torch.checkpoint import store
    drive(tmp_path / "keep", keep=2)
    assert len(store.available_steps(str(tmp_path / "keep"))) <= 2
    assert store.latest_step(str(tmp_path / "keep")) == STEPS
    plan = FaultPlan(faults=tuple(Fault("data_error", s) for s in (1, 2, 4)))
    with pytest.raises(DataStreamError):
        drive(tmp_path / "budget", plan=plan,
              sup=SupervisorConfig(max_restarts=2, backoff_base=0.0))


def _sequence(records):
    return [(r["incident"],) + tuple(r.get(k) for k in ("attempt", "resume_step", "step",
                                                         "error", "restarts"))
            for r in records]


def test_incident_sequence_matches_jax_run_training(tmp_path):
    j = _jres()
    from repro.configs import get_config, reduced
    from repro.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro.core.folding import build_folded_mesh
    from repro.optim import adamw as jadamw
    faults = (("data_error", 2), ("nan_grad", 3), ("corrupt_shard", 4), ("loss_spike", 6))
    sup = dict(max_restarts=5, backoff_base=0.0)
    log = str(tmp_path / "port.jsonl")
    mine = drive(tmp_path / "port", plan=FaultPlan(tuple(Fault(k, s) for k, s in faults)),
                 sup=SupervisorConfig(**sup), log=IncidentLog(log))
    jcfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), n_layers=2, d_model=64,
                               n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=256)
    fm = build_folded_mesh(ParallelConfig(attn=PM(2, 1, 1), moe=PM(2, 1, 1)))
    theirs = j.run_training(
        jcfg, fm, jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=STEPS),
        j.TrainRunConfig(steps=STEPS, ckpt_dir=str(tmp_path / "jax"), ckpt_every=EVERY,
                         seq_len=16, global_batch=4),
        injector=j.FaultInjector(j.FaultPlan(tuple(j.Fault(k, s) for k, s in faults))),
        guard_cfg=j.GuardConfig(warmup_obs=1, min_std=1.0), sup_cfg=j.SupervisorConfig(**sup))
    assert _sequence(mine["incidents"]) == _sequence(theirs["incidents"])
    assert mine["restarts"] == theirs["restarts"] == 3
    assert mine["skipped"] == theirs["skipped"] == [3]
    assert sorted(mine["losses"]) == sorted(theirs["losses"])
    assert _sequence(IncidentLog.read(log)) == _sequence(mine["incidents"])
    for d in ("port", "jax"):     # the same steps quarantined and kept
        assert sorted(f for f in os.listdir(tmp_path / d) if not f.endswith(".jsonl")) == \
            sorted(os.listdir(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# A gloo world of 4
# ---------------------------------------------------------------------------

def _world_chaos(rank, world, root):
    from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM
    from repro_torch.core.folding import build_folded_groups
    fg = build_folded_groups(ParallelConfig(attn=PM(2, 1, 2), moe=PM(2, 2, 1)), rank=rank,
                             world=world)
    out = {}
    for kind in (None, "corrupt_shard", "hung_step"):
        kw, hang = _kind_kw(kind)
        res = drive(os.path.join(root, str(kind)), groups=fg, hang_timeout=hang,
                    steps=WORLD_STEPS, plan=FaultPlan.single(kind, 4, **kw) if kind else None,
                    log=IncidentLog(os.path.join(root, f"{kind}.jsonl")))
        out[kind] = dict(losses=res["losses"], restarts=res["restarts"],
                         incidents=_sequence(res["incidents"]))
    return out


def test_crash_faults_recover_bitwise_in_a_world_of_4(tmp_path):
    from repro_torch.launch.world import spawn
    root = str(tmp_path / "runs")
    ranks = spawn(_world_chaos, 4, backend="gloo", device="cpu", args=(root,), timeout_s=300,
                  init_dir=str(tmp_path))
    ref = ranks[0][None]["losses"]
    assert sorted(ref) == list(range(WORLD_STEPS))
    for r in ranks:
        assert r[None]["losses"] == ref and r[None]["restarts"] == 0
        for kind in ("corrupt_shard", "hung_step"):
            assert r[kind]["losses"] == ref and r[kind]["restarts"] == 1, (kind, r[kind])
            assert r[kind]["incidents"] == ranks[0][kind]["incidents"]
    assert any(f.endswith(".quarantined") for f in os.listdir(os.path.join(root,
                                                                           "corrupt_shard")))
    # Only rank 0 wrote the incident file.
    assert _sequence(IncidentLog.read(os.path.join(root, "corrupt_shard.jsonl"))) == \
        ranks[0]["corrupt_shard"]["incidents"]
