"""Auto-recovery supervisor: restart budget, watchdog, incident log.

Copy of ``repro.resilience.supervisor``. Across ranks every rank runs its
own supervisor over the same attempt function (the faults are symmetric,
so all restart together), its own watchdog (``interrupt_main`` in its own
process), and only rank 0's incident log writes a file.

The supervisor wraps one *attempt function* (the driver's restartable
train body) in a retry loop:

* a **restart budget** (``max_restarts``) bounds how many recoverable
  failures a run may absorb before the original exception propagates;
* **exponential backoff with seeded jitter** spaces the restarts
  (deterministic given the seed — tests run with ``backoff_base=0``);
* every failure and recovery decision is appended to a structured
  **JSONL incident log** — one self-describing record per line, the
  artifact the nightly chaos job publishes;
* the :class:`Watchdog` turns a *hung* step (no progress before the
  deadline) into a :class:`HungStepError` via
  ``_thread.interrupt_main()`` — the only portable way to break a thread
  stuck in host code without killing the process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import _thread
from typing import Callable, List, Optional, Tuple, Type


class HungStepError(RuntimeError):
    """A step exceeded the watchdog deadline."""


class IncidentLog:
    """Append-only JSONL incident log (``path=None`` → in-memory only)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def record(self, incident: str, **fields) -> dict:
        rec = {"seq": len(self.records), "time": time.time(),
               "incident": incident, **fields}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @staticmethod
    def read(path: str) -> List[dict]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


class Watchdog:
    """Per-step hang detector, used as a context manager around the step.

    Arms a timer on ``__enter__``; if the body has not exited when it
    fires, the main thread is interrupted and the resulting
    ``KeyboardInterrupt`` is converted to :class:`HungStepError` on
    ``__exit__``. A real Ctrl-C while armed is indistinguishable from a
    hang by construction — both mean "this step is not finishing".
    """

    def __init__(self, timeout: float):
        self.timeout = timeout
        self._timer: Optional[threading.Timer] = None
        self._fired = False

    def _fire(self):
        self._fired = True
        _thread.interrupt_main()

    def __enter__(self):
        self._fired = False
        self._timer = threading.Timer(self.timeout, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._timer.cancel()
        if self._fired:
            if exc_type is None:
                # The timer fired but the interrupt has not landed yet —
                # absorb it here instead of letting it detonate later.
                try:
                    time.sleep(0.2)
                except KeyboardInterrupt:
                    pass
                raise HungStepError(
                    f"step exceeded the {self.timeout}s watchdog deadline")
            if exc_type is KeyboardInterrupt:
                raise HungStepError(
                    f"step exceeded the {self.timeout}s watchdog deadline"
                ) from exc
        return False


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_restarts: int = 3
    backoff_base: float = 1.0      # seconds; attempt k sleeps base * 2**k
    backoff_max: float = 60.0
    jitter: float = 0.25           # ± fraction of the backoff, seeded
    seed: int = 0


# The failure classes a restart can actually fix. Anything else (a code
# bug, an unrecoverable checkpoint error) propagates immediately.
RECOVERABLE: Tuple[Type[BaseException], ...] = ()


def _default_recoverable() -> Tuple[Type[BaseException], ...]:
    from repro_torch.resilience.faults import DataStreamError, SimulatedCrash
    from repro_torch.resilience.guard import LossSpikeError
    return (SimulatedCrash, DataStreamError, HungStepError, LossSpikeError,
            OSError)


class Supervisor:
    """Run an attempt function under a restart budget.

    ``fn(attempt)`` is called with the 0-based attempt number and must be
    *restartable*: each call is expected to pick up from persistent state
    (the last verified checkpoint) on its own. The supervisor only decides
    *whether* and *when* to call again.
    """

    def __init__(self, cfg: Optional[SupervisorConfig] = None, *,
                 log: Optional[IncidentLog] = None,
                 recoverable: Optional[Tuple[Type[BaseException], ...]] = None):
        self.cfg = cfg or SupervisorConfig()
        self.log = log or IncidentLog()
        self.recoverable = (recoverable if recoverable is not None
                            else _default_recoverable())
        self.restarts = 0

    def backoff(self, attempt: int) -> float:
        """Deterministic backoff-with-jitter for ``attempt`` (0-based)."""
        import numpy as np
        c = self.cfg
        base = min(c.backoff_base * (2 ** attempt), c.backoff_max)
        if base <= 0 or c.jitter <= 0:
            return max(base, 0.0)
        rng = np.random.default_rng(c.seed * 7919 + attempt)
        return float(base * (1 + c.jitter * (2 * rng.random() - 1)))

    def run(self, fn: Callable[[int], object]) -> object:
        attempt = 0
        while True:
            try:
                result = fn(attempt)
                if attempt:
                    self.log.record("recovered", attempt=attempt,
                                    restarts=self.restarts)
                return result
            except self.recoverable as e:
                self.restarts += 1
                rec = self.log.record(
                    "restart", attempt=attempt, error=type(e).__name__,
                    detail=str(e), restarts=self.restarts,
                    budget=self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    self.log.record("budget_exhausted", **{
                        k: rec[k] for k in ("attempt", "error", "detail")})
                    raise
                delay = self.backoff(attempt)
                if delay:
                    time.sleep(delay)
                attempt += 1
