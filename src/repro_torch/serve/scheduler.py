"""Continuous-batching request scheduler (host-side, numpy-only).

Request state machine::

    submit() ──> WAITING ──admit()──> PREFILLING ──chunks done──> DECODING
                    ▲                     │                          │
                    │                     └──────── preempt ─────────┤
                    └──────────── (pages freed, pos = 0) ────────────┘
                                                DECODING ──max_new──> FINISHED

One engine step = ``admit()`` + at most one prefill chunk
(``next_prefill``) + one batched decode over every DECODING slot
(``decode_plan``). Chunked prefill interleaves with decode so a long
prompt never stalls running streams; chunks are **exact-length**
(``[C, C, ..., rem]``) because padded prefill tokens would corrupt
recurrent (SSM) state — the jitted step retraces once per distinct chunk
length instead.

Preemption is recompute-style (vLLM): when the page pool runs dry, the
youngest-admitted victim releases its pages and re-enters the waiting
queue at the front; its already-generated tokens become part of the
re-prefilled prompt, so for greedy decoding the preemption is
output-preserving. Admission reserves nothing but only admits a request
whose whole-lifetime page need fits the current free pool, which keeps
preemption an overflow path rather than the steady state.

Everything here is host-side bookkeeping — device state (pools, block
tables as arrays, recurrent slots) lives in ``serve.engine``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.cache import BlockAllocator, pages_for


class QueueFull(RuntimeError):
    """Submission rejected: the bounded waiting queue is at capacity.

    Explicit backpressure beats unbounded queueing under overload — the
    client can retry elsewhere instead of waiting forever. Preemption
    re-entry is exempt from the bound (an admitted request never loses its
    place because the queue filled behind it)."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request (immutable; lifecycle state lives in _Run)."""

    prompt: np.ndarray            # (S,) int32 token ids
    max_new_tokens: int
    temperature: float = 0.0      # 0 → greedy
    seed: int = 0                 # per-request sampling key (temperature > 0)
    # Deadline in *engine steps* since submission (0 = none). Steps, not
    # wall clock, so timeout behavior is deterministic and testable; a
    # request still unfinished when the budget elapses is evicted with
    # GenerationResult.status == "timeout" and its pages reclaimed.
    deadline_steps: int = 0

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           np.asarray(self.prompt, np.int32).reshape(-1))
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_steps < 0:
            raise ValueError("deadline_steps must be >= 0 (0 = no deadline)")


@dataclasses.dataclass
class StepStats:
    """Per-engine-step observability record."""

    step: int
    admitted: List[int]
    finished: List[int]
    preempted: List[int]
    n_running: int
    n_waiting: int
    prefill_tokens: int
    decode_tokens: int
    pages_in_use: int
    pages_total: int
    kv_bytes_reserved: int
    kv_bytes_dense: int
    # (E,) routed-token assignments this step (prefill + decode), or None
    # for non-MoE archs / dense mode. The MoETuner placement signal.
    expert_load: Optional[np.ndarray] = None
    # Requests evicted this step because their deadline_steps elapsed.
    timed_out: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Run:
    """Scheduler-internal mutable request state."""

    rid: int
    req: Request
    tokens: List[int]             # prompt + generated so far
    prompt_len: int
    pos: int = 0                  # positions already written to the cache
    slot: int = -1                # engine batch slot (-1 = not admitted)
    admit_seq: int = -1           # admission order (preemption picks max)
    submit_step: int = -1         # scheduler.step_count at submission
                                  # (deadline_steps counts from here)
    preemptions: int = 0
    pages: Dict[int, int] = dataclasses.field(default_factory=dict)
    last_prefill_logits: Optional[np.ndarray] = None

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - self.prompt_len

    @property
    def prefill_target(self) -> int:
        # Everything but the newest token is (re-)prefilled; the newest
        # generated token is fed through decode (its KV isn't written yet).
        return len(self.tokens) - (1 if self.n_generated else 0)

    @property
    def prefilling(self) -> bool:
        return self.pos < self.prefill_target

    @property
    def done(self) -> bool:
        return self.n_generated >= self.req.max_new_tokens


class Scheduler:
    """Slot + page bookkeeping for continuous batching.

    ``page_size == 0`` disables paging (dense per-slot caches): admission is
    slot-only and preemption never fires.
    """

    def __init__(self, *, max_batch: int, cache_len: int, prefill_chunk: int,
                 page_size: int = 0, n_pages: int = 0, window: int = 0,
                 preempt: bool = True, max_waiting: int = 0):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if page_size and cache_len % page_size:
            raise ValueError(
                f"cache_len {cache_len} must be a multiple of page_size "
                f"{page_size} (paged/dense attention parity needs equal L)")
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.prefill_chunk = prefill_chunk
        self.page_size = page_size
        self.window = window
        self.preempt_enabled = preempt
        self.max_waiting = max_waiting      # 0 = unbounded
        self.alloc = BlockAllocator(n_pages) if page_size else None
        self.n_slot_pages = cache_len // page_size if page_size else 0
        if self.alloc and self.alloc.n_free < self.n_slot_pages:
            raise ValueError(
                f"n_pages {n_pages} cannot hold one full request "
                f"({self.n_slot_pages} pages + scratch)")
        self.waiting: Deque[_Run] = deque()
        self.slots: List[Optional[_Run]] = [None] * max_batch
        self._seq = 0
        self.step_count = 0

    # ---- queue ---------------------------------------------------------

    def submit(self, run: _Run) -> None:
        total = run.prompt_len + run.req.max_new_tokens
        if not self.window and total > self.cache_len:
            raise ValueError(
                f"request {run.rid}: prompt {run.prompt_len} + max_new "
                f"{run.req.max_new_tokens} exceeds cache_len {self.cache_len}")
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            raise QueueFull(
                f"request {run.rid} rejected: waiting queue at capacity "
                f"({self.max_waiting}) — retry later or raise "
                "EngineConfig.max_waiting")
        run.submit_step = self.step_count
        self.waiting.append(run)

    def _lifetime_pages(self, run: _Run) -> int:
        total = len(run.tokens) + (run.req.max_new_tokens - run.n_generated)
        return pages_for(total, self.cache_len, self.page_size) \
            if self.page_size else 0

    def admit(self) -> List[_Run]:
        admitted = []
        while self.waiting and None in self.slots:
            run = self.waiting[0]
            if self.alloc and self.alloc.n_free < self._lifetime_pages(run):
                break   # FIFO head doesn't fit — don't starve it by skipping
            self.waiting.popleft()
            run.slot = self.slots.index(None)
            run.admit_seq = self._seq
            self._seq += 1
            self.slots[run.slot] = run
            admitted.append(run)
        return admitted

    # ---- pages ---------------------------------------------------------

    def _logical_page(self, pos: int) -> int:
        ls = pos % self.cache_len if self.window else min(pos, self.cache_len - 1)
        return ls // self.page_size

    def _evict_youngest(self, exclude: _Run) -> Optional[_Run]:
        victims = [r for r in self.slots if r and r is not exclude]
        if not victims or not self.preempt_enabled:
            return None
        victim = max(victims, key=lambda r: r.admit_seq)
        self.preempt(victim)
        return victim

    def _ensure_pages(self, run: _Run, positions) -> List[_Run]:
        """Map every logical page covering ``positions``; preempt on dry pool."""
        preempted: List[_Run] = []
        for lp in dict.fromkeys(self._logical_page(p) for p in positions):
            while lp not in run.pages:
                pg = self.alloc.alloc()
                if pg is not None:
                    run.pages[lp] = pg
                    break
                victim = self._evict_youngest(exclude=run)
                if victim is None:
                    raise RuntimeError(
                        f"page pool exhausted for request {run.rid} with no "
                        "preemptable victim — EngineConfig.n_pages too small")
                preempted.append(victim)
        return preempted

    def preempt(self, run: _Run) -> None:
        """Recompute-style eviction back to the waiting queue's front."""
        if self.alloc and run.pages:
            self.alloc.free(run.pages.values())
        run.pages = {}
        self.slots[run.slot] = None
        run.slot = -1
        run.pos = 0
        run.preemptions += 1
        self.waiting.appendleft(run)

    def finish(self, run: _Run) -> None:
        if self.alloc and run.pages:
            self.alloc.free(run.pages.values())
        run.pages = {}
        self.slots[run.slot] = None
        run.slot = -1

    def expire(self) -> List[_Run]:
        """Evict every unfinished run whose ``deadline_steps`` has elapsed.

        Deadlines count engine steps since submission (deterministic — no
        wall clock). Running victims release their slot and pages exactly
        like :meth:`finish`; waiting victims just leave the queue. Evicting
        never touches a survivor's slot, pages, or cache rows, which is
        what keeps surviving outputs bitwise identical to a run where the
        timed-out requests were never submitted.
        """
        def overdue(run: _Run) -> bool:
            d = run.req.deadline_steps
            return bool(d) and run.submit_step >= 0 \
                and self.step_count - run.submit_step > d

        expired: List[_Run] = []
        for run in list(self.slots):
            if run is not None and overdue(run):
                self.finish(run)
                expired.append(run)
        keep: Deque[_Run] = deque()
        for run in self.waiting:
            if overdue(run):
                expired.append(run)
            else:
                keep.append(run)
        self.waiting = keep
        return expired

    # ---- per-step plans ------------------------------------------------

    def next_prefill(self) -> Optional[Tuple[_Run, int, List[_Run]]]:
        """(run, chunk_len, preempted) for the oldest prefilling run."""
        cands = [r for r in self.slots if r and r.prefilling]
        if not cands:
            return None
        run = min(cands, key=lambda r: r.admit_seq)
        c = min(self.prefill_chunk, run.prefill_target - run.pos)
        preempted = []
        if self.alloc:
            preempted = self._ensure_pages(run, range(run.pos, run.pos + c))
        return run, c, preempted

    def decode_plan(self) -> Tuple[List[_Run], List[_Run]]:
        """(decoding runs oldest-first, preempted) with pages ensured for
        each run's next position."""
        cands = sorted((r for r in self.slots if r and not r.prefilling),
                       key=lambda r: r.admit_seq)
        preempted: List[_Run] = []
        out = []
        for run in cands:
            if run.slot < 0:
                continue    # lost its slot to an older run's page demand
            if self.alloc:
                preempted += self._ensure_pages(run, [run.pos])
            out.append(run)
        return [r for r in out if r.slot >= 0], preempted

    def block_row(self, run: _Run) -> np.ndarray:
        """(n_slot_pages,) int32 physical page per logical page (0=scratch)."""
        row = np.zeros((self.n_slot_pages,), np.int32)
        for lp, pg in run.pages.items():
            row[lp] = pg
        return row

    # ---- introspection -------------------------------------------------

    @property
    def n_running(self) -> int:
        return sum(1 for r in self.slots if r)

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def idle(self) -> bool:
        return not self.waiting and not any(self.slots)
