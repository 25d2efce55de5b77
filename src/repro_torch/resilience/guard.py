"""Host-side anomaly guards: the EMA z-score loss-spike detector.

Copy of ``repro.resilience.guard``. Two layers of defense:

* **In the step** (``optim/adamw.py`` + ``train/loop.py``): ``step_ok =
  isfinite(loss) & isfinite(grad_norm)``, read on the host once a step;
  a False flag issues no update at all (the reference discards it by a
  ``where`` select inside its compiled step). Catches *non-finite*
  anomalies.
* **Host-side** (this module): non-finite is not the only failure mode —
  a silently corrupted batch or a bad expert update can send the loss to
  a perfectly finite 50×. The :class:`SpikeDetector` keeps an EMA
  mean/variance of the loss and flags a step whose z-score exceeds the
  threshold; the driver answers by raising :class:`LossSpikeError`, which
  the supervisor turns into rollback-to-last-verified-checkpoint + replay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


class LossSpikeError(RuntimeError):
    """Raised by the driver when the spike detector fires → rollback."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    # EMA decay for the loss mean/variance trackers.
    ema_decay: float = 0.9
    # Flag a step whose |loss - ema_mean| exceeds z_threshold * ema_std.
    z_threshold: float = 6.0
    # Never flag before this many observations (the EMA needs to settle;
    # early training loss legitimately moves fast).
    warmup_obs: int = 5
    # Std floor: a perfectly flat loss history must not make the detector
    # hair-triggered on the first real wiggle.
    min_std: float = 1e-3


class SpikeDetector:
    """EMA z-score spike detection over a scalar loss stream.

    ``observe(loss)`` returns True when the loss is a spike. Spikes are
    *not* folded into the EMA (a detected outlier must not drag the
    baseline toward itself); non-finite values are the in-jit guard's job
    and are ignored here (returns False — the step was already skipped).
    """

    def __init__(self, cfg: Optional[GuardConfig] = None):
        self.cfg = cfg or GuardConfig()
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n_obs: int = 0

    def observe(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return False
        c = self.cfg
        if self.mean is None:
            self.mean, self.n_obs = float(loss), 1
            return False
        std = max(math.sqrt(self.var), c.min_std)
        z = abs(loss - self.mean) / std
        if self.n_obs >= c.warmup_obs and z > c.z_threshold:
            return True
        d = loss - self.mean
        self.mean += (1 - c.ema_decay) * d
        self.var = c.ema_decay * (self.var + (1 - c.ema_decay) * d * d)
        self.n_obs += 1
        return False

    def state(self) -> dict:
        """Snapshot for incident logs."""
        return {"mean": self.mean, "std": math.sqrt(self.var),
                "n_obs": self.n_obs}
