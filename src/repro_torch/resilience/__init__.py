"""Fault tolerance of the port's training: chaos harness, anomaly guards,
auto-recovery supervisor (port of ``repro.resilience``).

* :mod:`repro_torch.resilience.faults` — deterministic seeded fault plans
  and the file/step-level injection primitives (a copy);
* :mod:`repro_torch.resilience.guard` — host-side EMA z-score loss-spike
  detection (a copy; the step's ``step_ok`` guard lives in
  ``optim/adamw.py`` / ``train/loop.py``);
* :mod:`repro_torch.resilience.supervisor` — restart budget with
  exponential backoff, per-step watchdog, structured JSONL incident log
  (a copy);
* :mod:`repro_torch.resilience.driver` — the restartable training loop
  gluing the above to the train step, the elastic checkpoints and the
  deterministic data stream, on one device or at a fold.
"""
from repro_torch.resilience.faults import (  # noqa: F401
    DataStreamError,
    Fault,
    FaultInjector,
    FaultPlan,
    SimulatedCrash,
    FAULT_KINDS,
    flip_npz_byte,
    truncate_file,
)
from repro_torch.resilience.guard import GuardConfig, LossSpikeError, SpikeDetector  # noqa: F401
from repro_torch.resilience.supervisor import (  # noqa: F401
    HungStepError,
    IncidentLog,
    Supervisor,
    SupervisorConfig,
    Watchdog,
)
from repro_torch.resilience.driver import run_training, TrainRunConfig  # noqa: F401
