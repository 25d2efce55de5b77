"""Chaos harness: deterministic seeded fault plans + injection primitives.

Copy of ``repro.resilience.faults`` (the same kinds, hooks and messages).
Every recovery path in the resilience stack has a reproducible trigger
here, so the recovery tests (``tests/test_torch_resilience.py``) exercise
the real code paths rather than mocks. A :class:`FaultPlan` is a list of
:class:`Fault` records (kind, step, knobs); :class:`FaultInjector` is the
stateful hook the training driver consults each step. Faults fire **once**
— after a supervisor restart the replayed step sees a clean injector, the
same contract a real transient fault obeys.

Fault taxonomy (docs/resilience.md):

========================  ====================================================
kind                      injected as
========================  ====================================================
``nan_grad``              ``batch["loss_scale"] = NaN`` → non-finite
                          loss/gnorm → the in-jit guard skips the step
``loss_spike``            a large finite ``loss_scale`` → finite but spiked
                          loss → the EMA z-score detector rolls back
``corrupt_shard``         one byte of a committed shard npz bit-flipped →
                          ``verify_checkpoint`` quarantines, restore falls
                          back to the previous verified step
``torn_save``             the just-written step is torn (payload truncated,
                          ``.done`` marker removed) + a simulated kill →
                          the restart never resumes from it
``data_error``            the data stream raises mid-run → restart + replay
``hung_step``             the step blocks past the watchdog deadline →
                          ``HungStepError`` → restart + replay
========================  ====================================================
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
import zipfile
from typing import Dict, List, Optional, Sequence


class SimulatedCrash(RuntimeError):
    """The chaos harness's stand-in for a hard kill (host loss, OOM-kill)."""


class DataStreamError(RuntimeError):
    """Injected data-pipeline failure (a real run: storage blip, bad record)."""


FAULT_KINDS = ("nan_grad", "loss_spike", "corrupt_shard", "torn_save",
               "data_error", "hung_step")


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    # loss_spike: multiplier injected via loss_scale (finite, large).
    spike_scale: float = 1e4
    # hung_step: how long the step blocks; must exceed the watchdog budget.
    hang_seconds: float = 30.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seed-reproducible list of faults for one run."""

    faults: tuple = ()

    @staticmethod
    def single(kind: str, step: int, **kw) -> "FaultPlan":
        return FaultPlan(faults=(Fault(kind, step, **kw),))

    @staticmethod
    def random(seed: int, *, steps: int, n_faults: int = 1,
               kinds: Sequence[str] = FAULT_KINDS,
               min_step: int = 1, **kw) -> "FaultPlan":
        """Deterministic plan: same seed → same faults, forever."""
        import numpy as np
        rng = np.random.default_rng(seed)
        lo = min(min_step, max(steps - 1, 0))
        faults = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(lo, max(steps, lo + 1)))
            faults.append(Fault(kind, step, **kw))
        return FaultPlan(faults=tuple(faults))

    def at(self, step: int) -> List[Fault]:
        return [f for f in self.faults if f.step == step]


class FaultInjector:
    """Stateful per-run injection hooks consulted by the training driver.

    Each fault fires exactly once (``fired`` survives supervisor restarts
    because the driver keeps one injector per run), so a replayed step is
    clean — the transient-fault contract the recovery-parity tests rely on.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.fired: List[Fault] = []

    def _take(self, step: int, kind: str, *, le: bool = False
              ) -> Optional[Fault]:
        for f in self.plan.faults:
            hit = f.step <= step if le else f.step == step
            if hit and f.kind == kind and f not in self.fired:
                self.fired.append(f)
                return f
        return None

    # -- in-step hooks (driver calls these in order) ---------------------

    def loss_scale(self, step: int) -> float:
        """The ``batch["loss_scale"]`` value for this step (1.0 = no fault)."""
        if self._take(step, "nan_grad"):
            return float("nan")
        f = self._take(step, "loss_spike")
        if f:
            return float(f.spike_scale)
        return 1.0

    def maybe_data_error(self, step: int) -> None:
        if self._take(step, "data_error"):
            raise DataStreamError(f"injected data-stream failure at step {step}")

    def maybe_hang(self, step: int) -> None:
        """Block past the watchdog deadline (the watchdog interrupts us)."""
        f = self._take(step, "hung_step")
        if f:
            deadline = time.monotonic() + f.hang_seconds
            while time.monotonic() < deadline:
                time.sleep(0.05)

    # -- post-save hooks -------------------------------------------------

    def maybe_corrupt_save(self, step: int, ckpt_dir: str, *,
                           damage: bool = True) -> None:
        """After a completed save at ``step``: corrupt it, or tear it. Both
        then raise :class:`SimulatedCrash` so the recovery path actually
        runs — a bit flip is only ever *observed* at restore time, and a
        torn save is by definition a kill mid-commit.

        File faults match any pending fault with ``fault.step <= step``
        (saves happen on a cadence; the fault fires at the first save at or
        after its nominal step). Across ranks every rank takes the fault
        and raises, and only the one with ``damage`` (rank 0) touches the
        files.
        """
        stem = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
        if self._take(step, "corrupt_shard", le=True):
            if damage:
                flip_npz_byte(_first_shard(stem))
            raise SimulatedCrash(
                f"injected crash after bit-flipping a shard of step {step}")
        if self._take(step, "torn_save", le=True):
            if damage:
                truncate_file(_first_shard(stem), frac=0.4)
                done = stem + ".done"
                if os.path.exists(done):
                    os.remove(done)
            raise SimulatedCrash(
                f"injected kill during save of step {step} (torn checkpoint)")
        return None


def _first_shard(ckpt_step_dir: str) -> str:
    shards = sorted(f for f in os.listdir(ckpt_step_dir)
                    if f.startswith("shards_") and f.endswith(".npz"))
    if not shards:
        raise FileNotFoundError(f"no shard files under {ckpt_step_dir!r}")
    return os.path.join(ckpt_step_dir, shards[0])


def flip_npz_byte(path: str, member_index: int = 0) -> int:
    """Bit-flip the last *payload* byte of one npz member; return its offset.

    The flip targets actual array bytes — a naive mid-file flip usually
    lands in zip metadata slack (extra-field padding) that no reader looks
    at, which would silently test nothing. The last payload byte of an
    uncompressed ``.npy`` member is always array data (for non-empty
    arrays), so the CRC check and the sha256 digest both catch it.
    """
    with zipfile.ZipFile(path) as z:
        info = z.infolist()[member_index]
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    fn_len, ex_len = struct.unpack_from("<HH", raw, info.header_offset + 26)
    data_start = info.header_offset + 30 + fn_len + ex_len
    off = data_start + info.file_size - 1
    raw[off] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    return off


def truncate_file(path: str, frac: float = 0.5) -> int:
    """Truncate ``path`` to ``frac`` of its size; return the new size."""
    size = os.path.getsize(path)
    keep = max(1, int(size * frac))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def summarize(plan: FaultPlan) -> Dict[str, List[int]]:
    """{kind: [steps]} — convenient for incident-log metadata."""
    out: Dict[str, List[int]] = {}
    for f in plan.faults:
        out.setdefault(f.kind, []).append(f.step)
    return out
