"""Serving engine: continuous batching over a paged KV cache.

Port of ``repro.serve.engine`` at one device, paged cache only. One
``Engine.step()`` = admit new requests + at most one **exact-length prefill
chunk** (a single slot) + one **batched decode** over every active slot,
exactly the JAX engine's schedule (the host-side ``Scheduler`` is a copy).
Each forward runs per layer the paged attention (flash kernel, one launch)
and the MoE FFN (GMM kernel, three launches).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import rmsnorm
from repro_torch.models.transformer import (LMParams, _decode_moe_paged, leaf_rank,
                                            check_supported)
from repro_torch.serve.cache import (init_paged_state, kv_bytes_dense,
                                     kv_bytes_paged)
from repro_torch.serve.scheduler import (QueueFull, Request, Scheduler, StepStats,
                                         _Run)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs, orthogonal to the model config."""

    max_batch: int = 4            # decode slots (continuous-batching width)
    s_max: int = 256              # max context (prompt + generated) per slot
    prefill_chunk: int = 32       # tokens per prefill chunk (exact-length)
    cache: str = "paged"          # only "paged" is ported
    page_size: int = 16           # KV tokens per page
    n_pages: Optional[int] = None  # pool size; default fits max_batch fully
    preempt: bool = True          # recompute-preempt on page-pool pressure
    compute_dtype: str = "bfloat16"
    # Bounded admission queue: submit() raises QueueFull past this many
    # waiting requests (0 = unbounded).
    max_waiting: int = 0


@dataclasses.dataclass
class GenerationResult:
    """Completed request: the generated tokens plus provenance."""

    request_id: int
    tokens: np.ndarray            # (n_generated,) int32, prompt excluded
    prompt_len: int
    finished: bool
    preemptions: int
    # fp32 logits after the last prompt token (first sample's input).
    last_prefill_logits: Optional[np.ndarray] = None
    status: str = "ok"            # "ok" | "timeout"


def _paged_forward(params: LMParams, state: List[Dict[str, torch.Tensor]],
                   tokens: torch.Tensor, positions: torch.Tensor,
                   block_tables: torch.Tensor, token_mask: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of ``tokens`` (B, C) at per-row base ``positions`` (B,) over
    the paged pools (updated in place) → (fp32 logits of each row's last
    token (B, V), routed-assignment counts (E,) summed over layers)."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = params.embed[tokens].to(dt)
    ctx = {"block_tables": block_tables, "token_mask": token_mask}
    counts = torch.zeros(cfg.moe.n_experts, dtype=torch.float32, device=x.device)
    for layer, st in zip(params.layers, state):
        x, _, cnt = _decode_moe_paged(layer, x, st, positions, cfg, ctx)
        counts += cnt
    # Only the last position's logits are read, so only it goes through the head.
    x = rmsnorm(x[:, -1], params.final_norm)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    return (x @ head.to(x.dtype)).float(), counts


def cast_params(params: LMParams, dtype: torch.dtype) -> None:
    """Cast the fp32 leaves of rank >= 2 in the JAX package's tree
    (:func:`leaf_rank`: per-layer norms and biases count the stacked layer
    axis) to ``dtype`` in place, as the JAX engine casts its parameters for
    bf16 compute; the final norm stays fp32."""
    for name, p in params.named_parameters():
        if p.dtype == torch.float32 and leaf_rank(name, p) >= 2 and dtype != torch.float32:
            p.data = p.data.to(dtype)


def _sample_seed(seed: int, rid: int, position: int) -> int:
    return ((seed * 1_000_003 + rid) * 1_000_003 + position) % (2 ** 63)


class Engine:
    """Continuous-batching serving engine on the device that holds ``params``.

    >>> # eng = Engine(cfg, params, EngineConfig(max_batch=4))
    >>> # rid = eng.submit(Request(prompt=ids, max_new_tokens=16))
    >>> # results = eng.drain()            # {rid: GenerationResult}

    The engine casts ``params``' fp32 matrices to ``compute_dtype`` in place
    and updates its KV pools in place. ``timings`` holds, per step, the host
    wall time of its prefill chunk and of its decode, each ending when the
    logits reach the host.
    """

    def __init__(self, cfg: ModelConfig, params: LMParams,
                 ecfg: Optional[EngineConfig] = None):
        ecfg = ecfg or EngineConfig()
        if ecfg.cache == "dense":
            raise NotImplementedError("the dense cache is not ported yet "
                                      "(ROADMAP.md queue 1, 'Serving, rest'); "
                                      "use cache='paged'")
        if ecfg.cache != "paged":
            raise ValueError(f"EngineConfig.cache must be 'paged', got {ecfg.cache!r}")
        if ecfg.compute_dtype not in _DTYPES:
            raise ValueError(f"bad compute_dtype {ecfg.compute_dtype!r}")
        check_supported(cfg)
        if cfg.sliding_window:
            raise NotImplementedError("sliding-window ring caches are not ported "
                                      "yet (ROADMAP.md queue 1, 'Serving, rest')")

        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.device = params.embed.device
        dt = _DTYPES[ecfg.compute_dtype]
        cast_params(params, dt)
        self.cache_len = ecfg.s_max
        n_slot_pages = self.cache_len // ecfg.page_size
        n_pages = (ecfg.n_pages if ecfg.n_pages is not None
                   else ecfg.max_batch * n_slot_pages + 1)
        self._sched = Scheduler(
            max_batch=ecfg.max_batch, cache_len=self.cache_len,
            prefill_chunk=ecfg.prefill_chunk, page_size=ecfg.page_size,
            n_pages=n_pages, window=0, preempt=ecfg.preempt,
            max_waiting=ecfg.max_waiting)
        self.state = init_paged_state(cfg, n_pages=n_pages, page_size=ecfg.page_size,
                                      dtype=dt, device=self.device)
        self._results: Dict[int, GenerationResult] = {}
        self._next_rid = 0
        self.stats: List[StepStats] = []
        self.timings: List[Tuple[float, float]] = []
        self._counters = {"submitted": 0, "rejected": 0, "finished": 0,
                          "timed_out": 0, "preemptions": 0}

    @property
    def scheduler(self) -> Scheduler:
        return self._sched

    def submit(self, request: Request) -> int:
        """Queue a request; returns its id (drain() keys results by it).

        Raises :class:`repro_torch.serve.scheduler.QueueFull` when the
        bounded waiting queue (``EngineConfig.max_waiting``) is full."""
        run = _Run(rid=self._next_rid, req=request,
                   tokens=[int(t) for t in request.prompt],
                   prompt_len=int(request.prompt.size))
        try:
            self._sched.submit(run)
        except QueueFull:
            self._counters["rejected"] += 1
            raise
        self._next_rid += 1
        self._counters["submitted"] += 1
        return run.rid

    def _sample(self, run: _Run, logits_row: np.ndarray) -> int:
        """Greedy argmax (bitwise the JAX engine's choice on equal logits), or
        a temperature sample from a ``torch.Generator`` seeded from
        ``(seed, rid, position)``: invariant to batching and preemption, but
        not the bits ``jax.random`` would draw."""
        if run.req.temperature <= 0:
            return int(np.argmax(logits_row))
        g = torch.Generator()
        g.manual_seed(_sample_seed(run.req.seed, run.rid, run.n_generated))
        probs = torch.softmax(torch.from_numpy(logits_row).double()
                              / run.req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=g))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.inference_mode()
    def step(self) -> StepStats:
        """One scheduler tick; returns the step's observability record."""
        s = self._sched
        s.step_count += 1
        timed_out: List[int] = []
        for r in s.expire():
            timed_out.append(r.rid)
            self._counters["timed_out"] += 1
            self._results[r.rid] = GenerationResult(
                request_id=r.rid,
                tokens=np.asarray(r.tokens[r.prompt_len:], np.int32),
                prompt_len=r.prompt_len, finished=False,
                preemptions=r.preemptions,
                last_prefill_logits=r.last_prefill_logits, status="timeout")
        admitted = [r.rid for r in s.admit()]
        preempted: List[int] = []
        finished: List[int] = []
        counts = None
        prefill_tokens = decode_tokens = 0
        prefill_s = decode_s = 0.0

        pf = s.next_prefill()
        if pf is not None:
            t0 = time.perf_counter()
            run, c, pre = pf
            preempted += [r.rid for r in pre]
            toks = self._tensor(np.asarray(run.tokens[run.pos:run.pos + c], np.int64)[None])
            base = self._tensor(np.asarray([run.pos], np.int64))
            row = self._tensor(s.block_row(run)[None])
            last, counts = _paged_forward(
                self.params, self.state, toks, base, row,
                torch.ones(1, dtype=torch.int32, device=self.device), self.cfg)
            lg = last[0].cpu().numpy()
            prefill_s = time.perf_counter() - t0
            run.pos += c
            prefill_tokens = c
            if not run.prefilling and run.n_generated == 0:
                # First token comes straight off the prefill logits; a
                # preempted run re-prefills but must NOT re-sample.
                run.last_prefill_logits = lg
                run.tokens.append(self._sample(run, lg))

        plan, pre2 = s.decode_plan()
        preempted += [r.rid for r in pre2]
        plan = [r for r in plan if not r.done]
        if plan:
            t0 = time.perf_counter()
            B = self.ecfg.max_batch
            toks = np.zeros((B, 1), np.int64)
            pos = np.zeros((B,), np.int64)
            mask = np.zeros((B,), np.int32)
            rows = np.zeros((B, s.n_slot_pages), np.int32)
            for r in plan:
                toks[r.slot, 0] = r.tokens[r.pos]
                pos[r.slot] = r.pos
                mask[r.slot] = 1
                rows[r.slot] = s.block_row(r)
            logits, cnt = _paged_forward(
                self.params, self.state, self._tensor(toks), self._tensor(pos),
                self._tensor(rows), self._tensor(mask), self.cfg)
            counts = cnt if counts is None else counts + cnt
            lg = logits.cpu().numpy()
            decode_s = time.perf_counter() - t0
            for r in plan:
                r.tokens.append(self._sample(r, lg[r.slot]))
                r.pos += 1
                decode_tokens += 1

        for r in [x for x in s.slots if x]:
            if r.done and not r.prefilling:
                finished.append(r.rid)
                self._results[r.rid] = GenerationResult(
                    request_id=r.rid,
                    tokens=np.asarray(r.tokens[r.prompt_len:], np.int32),
                    prompt_len=r.prompt_len, finished=True,
                    preemptions=r.preemptions,
                    last_prefill_logits=r.last_prefill_logits)
                s.finish(r)
                self._counters["finished"] += 1

        dtype_bytes = 2 if self.ecfg.compute_dtype == "bfloat16" else 4
        self._counters["preemptions"] += len(preempted)
        st = StepStats(
            step=s.step_count, admitted=admitted, finished=finished,
            preempted=preempted, n_running=s.n_running, n_waiting=s.n_waiting,
            prefill_tokens=prefill_tokens, decode_tokens=decode_tokens,
            pages_in_use=s.alloc.in_use, pages_total=s.alloc.n_pages - 1,
            kv_bytes_reserved=kv_bytes_paged(self.cfg, s.alloc.n_pages, s.page_size,
                                             dtype_bytes=dtype_bytes),
            kv_bytes_dense=kv_bytes_dense(self.cfg, self.ecfg.max_batch,
                                          self.cache_len, dtype_bytes=dtype_bytes),
            expert_load=counts.cpu().numpy() if counts is not None else None,
            timed_out=timed_out)
        self.stats.append(st)
        self.timings.append((prefill_s, decode_s))
        return st

    def health(self) -> Dict[str, int]:
        """Cumulative counters (``submitted``, ``rejected``, ``finished``,
        ``timed_out``, ``preemptions``) and gauges (``steps``, ``running``,
        ``waiting``, ``pages_in_use``, ``pages_free``, ``results_pending``)."""
        s = self._sched
        out = dict(self._counters)
        out.update(steps=s.step_count, running=s.n_running, waiting=s.n_waiting,
                   pages_in_use=s.alloc.in_use, pages_free=s.alloc.n_free,
                   results_pending=len(self._results))
        return out

    def drain(self, max_steps: int = 100_000) -> Dict[int, GenerationResult]:
        """Step until every submitted request finishes; results by id."""
        n = 0
        while not self._sched.idle:
            self.step()
            n += 1
            if n > max_steps:
                raise RuntimeError(f"drain exceeded {max_steps} steps — "
                                   "scheduler wedged?")
        return dict(self._results)
