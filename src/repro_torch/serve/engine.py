"""Serving engine: continuous batching over a paged or dense KV cache, at one
device or across the ranks of a pp = 1 fold.

Port of ``repro.serve.engine``. One ``Engine.step()`` = admit new requests
+ at most one **exact-length prefill chunk** (a single slot) + one
**batched decode** over every active slot, exactly the JAX engine's
schedule (the host-side ``Scheduler`` is a copy). Each forward runs per
layer the attention (flash kernel: one launch, or one per CP rank of a
ring-CP prefill chunk) and the MoE FFN (GMM kernel, three launches a
dispatcher chunk).

A sliding-window config keeps ``cache_len = min(window, s_max)`` slots a
request in either cache, as a ring (position p in slot ``p % cache_len``),
so a context of any length takes O(window) memory; the attention gives the
flash kernel each slot's position (``models.attention``).

The recurrent kinds (xLSTM, Zamba2's Mamba2 layers) keep O(1) state a slot
beside the KV pools, in either mode: zeroed when a request starts (its
first prefill chunk, the reference's ``_reset_fresh_request``), advanced by
its chunks and decode steps, frozen on the padded rows of a decode batch.
At a fold a slot's state lives on the DP rank that computes its decode row
(whole there, on every TP and CP rank); a prefill chunk, which every rank
computes, gathers it from that owner and writes it back there. Zamba2's
shared block keeps a dense K/V cache per cycle repeat, so a paged
engine refuses it, as the reference's does.

Across ranks (``groups``, a ``FoldedGroups`` at pp = 1) every rank runs the
same engine on its compute slices of the parameters: the same scheduler,
the same sampling from the same gathered fp32 logits, so every rank takes
the same decisions and the collectives stay in step.

Kept for the v0 surface: ``make_prefill_step``, ``make_serve_step`` and the
deprecated ``ServeSession`` / ``build_session`` shims over :class:`Engine`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups
from repro_torch.models import ssm_blocks
from repro_torch.models.sharding import map_params, shard_lm_params
from repro_torch.models.transformer import (LMParams, apply_lm, check_supported,
                                            decode_rows, decode_step, init_decode_state,
                                            init_lm, leaf_rank, model_cycle, paged_forward,
                                            whole_attention, whole_recurrent)
from repro_torch.serve.cache import (init_paged_state, kv_bytes_dense,
                                     kv_bytes_paged)
from repro_torch.serve.scheduler import (QueueFull, Request, Scheduler, StepStats,
                                         _Run)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def reject_pipelined_mapping(pcfg, what: str) -> None:
    """Serve/decode paths are pp = 1 / vpp = 1 only (``pcfg``: a
    ``ParallelConfig``), as in the reference: they have no pipeline
    executor, so a pipelined mapping is refused, naming pp and vpp."""
    if pcfg.pipeline_stages > 1 or pcfg.vpp > 1:
        raise ValueError(
            f"{what} supports pp=1/vpp=1 mappings only, got pp={pcfg.pp}, "
            f"vpp={pcfg.vpp}, pods={pcfg.pods} (pod_role={pcfg.pod_role!r} → "
            f"{pcfg.pipeline_stages} pipeline stages). The serve/decode path "
            "has no pipeline executor. Use a pp=1 mapping for serving (fold the "
            "freed factor into DP/CP), or train-side entry points for pipelined "
            "mappings.")


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """KV slots needed to serve ``seq_len`` context: ``window`` ring slots
    for sliding-window attention, the whole context otherwise."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _compute_cast(params: LMParams, dtype: torch.dtype) -> LMParams:
    """A copy of ``params`` whose fp32 leaves of rank >= 2 in the JAX tree
    (:func:`leaf_rank`) are cast to ``dtype`` — the reference step
    builders' cast; the input is left as it was."""
    if dtype == torch.float32:
        return params
    return map_params(params, lambda n, t: t.to(dtype)
                      if t.dtype == torch.float32 and leaf_rank(n, t) >= 2 else t)


def make_prefill_step(cfg: ModelConfig, groups: Optional[FoldedGroups] = None):
    """Full-sequence logits-only forward: ``prefill(params, batch)`` → fp32
    logits of every row's last token (B, V), with the parameters cast to
    bf16 as the reference casts them. It never fills a decode cache
    (cache-fill prefill is :func:`decode_step` with C > 1, which
    :class:`Engine` and ``ServeSession.prefill`` run).

    With ``groups``: ``params`` and ``batch`` are the rank's store slices
    and batch share, as :func:`repro_torch.models.transformer.apply_lm`
    takes them; the last token's logits (on the last CP rank, the rank's
    vocabulary slice, its DP rows) are gathered so that every rank returns
    the whole (B, V)."""
    if groups is not None:
        reject_pipelined_mapping(groups.pcfg, "make_prefill_step")

    @torch.inference_mode()
    def prefill(params: LMParams, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = apply_lm(_compute_cast(params, torch.bfloat16), batch, cfg, remat=False,
                             groups=groups)
        last = logits[:, -1].float()
        if groups is not None:
            a = groups.attn
            last = comm.gather_rows(last, a["tp"], "logits_gather", dim=1)
            last = comm.gather_rows(last[None], a["cp"], "logits_gather")[-1]
            last = comm.gather_rows(last, a["dp"], "logits_gather")
        return last
    return prefill


def make_serve_step(cfg: ModelConfig, groups: Optional[FoldedGroups] = None):
    """``serve(params, state, tokens)`` → (fp32 logits (B, C, V), state):
    :func:`decode_step` over the dense cache of :func:`init_decode_state`
    with the parameters cast to bf16 as the reference casts them. With
    ``groups``: the rank's compute slices and cache piece (a recurrent
    layer's leaves, and attention's where K/V is replicated over TP,
    gathered whole at each call: ``transformer.whole_recurrent``,
    ``whole_attention``); every rank gets the whole batch's logits."""
    if groups is not None:
        reject_pipelined_mapping(groups.pcfg, "make_serve_step")

    @torch.inference_mode()
    def serve(params: LMParams, state: Dict, tokens: torch.Tensor):
        whole = whole_recurrent(_compute_cast(params, torch.bfloat16), groups)
        logits, state = decode_step(whole_attention(whole, cfg, groups), state, tokens, cfg,
                                    groups=groups)
        return logits.float(), state
    return serve


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs, orthogonal to the model config."""

    max_batch: int = 4            # decode slots (continuous-batching width)
    s_max: int = 256              # max context (prompt + generated) per slot
    prefill_chunk: int = 32       # tokens per prefill chunk (exact-length)
    cache: str = "paged"          # "paged" | "dense"
    page_size: int = 16           # KV tokens per page (paged mode)
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
    and updates its KV cache in place. ``timings`` holds, per step, the host
    wall time of its prefill chunk and of its decode, each ending when the
    logits reach the host.

    ``groups``: the rank's ``FoldedGroups`` at a pp = 1 fold (pipelined
    mappings are refused); ``params`` are then the rank's compute slices
    (``models.sharding.shard_lm_params(full, groups, "compute")``), the
    paged pools hold its TP heads of every page
    (``serve.cache.init_paged_state``) and the dense cache its
    ``(dp, tp, cp)`` piece (``transformer.init_decode_state``); the
    recurrent layers' state is per slot on the slot's DP rank, and they
    compute on leaves gathered whole once, at construction. Every rank of
    the fold runs the same requests in the same order.
    """

    def __init__(self, cfg: ModelConfig, params: LMParams,
                 ecfg: Optional[EngineConfig] = None,
                 groups: Optional[FoldedGroups] = None):
        ecfg = ecfg or EngineConfig()
        if groups is not None:
            reject_pipelined_mapping(groups.pcfg, "Engine")
        if ecfg.cache not in ("paged", "dense"):
            raise ValueError(f"EngineConfig.cache must be 'paged' or 'dense', "
                             f"got {ecfg.cache!r}")
        if ecfg.compute_dtype not in _DTYPES:
            raise ValueError(f"bad compute_dtype {ecfg.compute_dtype!r}")
        check_supported(cfg)
        if cfg.is_encoder_decoder:
            raise ValueError(
                "Engine serves decoder-only models; enc-dec (whisper) needs "
                "an encoder pass + cross-KV prefill that lives in apply_lm")
        if ecfg.cache == "paged" and cfg.shared_attention_every:
            raise ValueError(
                "paged KV does not support shared_attention_every (zamba2): "
                "the shared block's cache is per-repeat, not per-layer — "
                "use EngineConfig(cache='dense')")
        if groups is not None:
            vocab = cfg.vocab_size // groups.tp if cfg.vocab_size % groups.tp == 0 \
                else cfg.vocab_size
            want = (vocab, cfg.d_model)
            if tuple(params.embed.shape) != want:
                raise ValueError(f"Engine(groups=...): embed {tuple(params.embed.shape)} is "
                                 f"not the rank's compute slice {want} "
                                 "(models.sharding.shard_lm_params(..., kind='compute'))")

        self.cfg, self.params, self.ecfg, self.groups = cfg, params, ecfg, groups
        self.paged = ecfg.cache == "paged"
        self.device = params.embed.device
        dt = _DTYPES[ecfg.compute_dtype]
        self.cache_len = cache_len_for(cfg, ecfg.s_max)
        if cfg.sliding_window and ecfg.prefill_chunk > self.cache_len:
            # The chunk's tokens are written before they attend: a chunk
            # longer than the ring would write some slots twice, in no order
            # the reference defines.
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} exceeds the ring of cache_len "
                f"{self.cache_len} slots (sliding_window {cfg.sliding_window}, s_max "
                f"{ecfg.s_max}): a chunk would overwrite its own slots")
        cast_params(params, dt)
        self.params = whole_attention(whole_recurrent(params, groups), cfg, groups)
        page_size = ecfg.page_size if self.paged else 0
        n_slot_pages = self.cache_len // page_size if self.paged else 0
        n_pages = (ecfg.n_pages if ecfg.n_pages is not None
                   else ecfg.max_batch * n_slot_pages + 1)
        self._sched = Scheduler(
            max_batch=ecfg.max_batch, cache_len=self.cache_len,
            prefill_chunk=ecfg.prefill_chunk, page_size=page_size,
            n_pages=n_pages if self.paged else 0, window=cfg.sliding_window or 0,
            preempt=ecfg.preempt,
            max_waiting=ecfg.max_waiting)
        if self.paged:
            self.state = init_paged_state(cfg, n_pages=n_pages, page_size=page_size,
                                          dtype=dt, device=self.device, groups=groups,
                                          max_batch=ecfg.max_batch)
        else:
            self.state = init_decode_state(cfg, ecfg.max_batch, self.cache_len, dtype=dt,
                                           device=self.device, groups=groups)
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

    def _reset_slot(self, layers: List[Dict[str, torch.Tensor]], kinds, fresh: bool) -> None:
        """Zero the recurrent state of a slot's rows ``layers`` (views, or
        the row gathered from its owner, which the chunk writes back there)
        when its request starts (``fresh``: the chunk at position 0); K/V
        are overwritten position by position before they are read."""
        if not fresh:
            return
        for kind, st in zip(kinds, layers):
            if kind in ssm_blocks.KINDS:
                init = ssm_blocks.init_state(kind, self.cfg, 1, device=self.device)
                for k, t in st.items():          # copy_ casts to the state's dtype
                    t.copy_(init[k])

    def _slot_rows(self, layers: List[Dict[str, torch.Tensor]], slot: int):
        """A slot's row of each per-row state in ``layers`` → (rows, owner).
        Views where this rank holds every row (``owner`` None: written
        through in place); where the rows are cut over DP the owner's row,
        gathered over DP (the reference slices the slot out of the
        DP-sharded state), which :meth:`_write_back` returns to the owner."""
        B = self.ecfg.max_batch
        _, b = decode_rows(B, self.groups)
        if b == B:
            return [{k: t[slot:slot + 1] for k, t in st.items()} for st in layers], None
        owner, local = divmod(slot, b)
        dp = self.groups.attn["dp"]
        return [{k: comm.gather_rows(t[local:local + 1], dp, "slot_gather")
                 [owner:owner + 1].clone() for k, t in st.items()} for st in layers], \
            (owner, local)

    def _write_back(self, layers: List[Dict[str, torch.Tensor]], rows, owner) -> None:
        """The owner's copy of :meth:`_slot_rows`' gathered rows, after the chunk."""
        if owner is None or self.groups.attn["dp"].index != owner[0]:
            return
        for st, row in zip(layers, rows):
            for k, t in st.items():
                t[owner[1]:owner[1] + 1].copy_(row[k])

    def _dense_prefill(self, toks: torch.Tensor, base: torch.Tensor, slot: int, fresh: bool
                       ) -> torch.Tensor:
        """One slot's prefill chunk over the dense cache → fp32 last logits
        (1, V), on the slot's rows of every layer's K/V or recurrent state
        (:meth:`_slot_rows`)."""
        layers = self.state["layers"] + self.state.get("shared", [])
        rows, owner = self._slot_rows(layers, slot)
        self._reset_slot(rows, model_cycle(self.cfg)[0], fresh)
        n = len(self.state["layers"])
        sliced = {"layers": rows[:n], "step": 0}
        if "shared" in self.state:
            sliced["shared"] = rows[n:]
        logits, _ = decode_step(self.params, sliced, toks, self.cfg, positions=base,
                                groups=self.groups, last_only=True)
        self._write_back(layers, rows, owner)
        return logits[:, 0].float()

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
            if self.paged:
                row = self._tensor(s.block_row(run)[None])
                kinds = model_cycle(self.cfg)[0]
                recurrent = [st for kind, st in zip(kinds, self.state)
                             if kind in ssm_blocks.KINDS]
                rows, owner = self._slot_rows(recurrent, run.slot)
                self._reset_slot(rows, [k for k in kinds if k in ssm_blocks.KINDS],
                                 run.pos == 0)
                it = iter(rows)
                state = [next(it) if kind in ssm_blocks.KINDS else st
                         for kind, st in zip(kinds, self.state)]
                last, counts = paged_forward(
                    self.params, state, toks, base, row,
                    torch.ones(1, dtype=torch.int32, device=self.device), self.cfg,
                    self.groups)
                self._write_back(recurrent, rows, owner)
            else:
                last = self._dense_prefill(toks, base, run.slot, run.pos == 0)
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
            if not self.paged:
                # Inactive dense rows write garbage K/V at their own next
                # position, overwritten by their next prefill chunk before the
                # slot is ever attended to (as in the reference).
                for r in s.slots:
                    if r is not None:
                        pos[r.slot] = r.pos
            rows = np.zeros((B, s.n_slot_pages), np.int32)
            for r in plan:
                toks[r.slot, 0] = r.tokens[r.pos]
                pos[r.slot] = r.pos
                mask[r.slot] = 1
                if self.paged:
                    rows[r.slot] = s.block_row(r)
            if self.paged:
                logits, cnt = paged_forward(
                    self.params, self.state, self._tensor(toks), self._tensor(pos),
                    self._tensor(rows), self._tensor(mask), self.cfg, self.groups)
                counts = cnt if counts is None else counts + cnt
            else:
                logits, self.state = decode_step(
                    self.params, self.state, self._tensor(toks), self.cfg,
                    positions=self._tensor(pos), token_mask=self._tensor(mask),
                    groups=self.groups, last_only=True)
                logits = logits[:, 0].float()
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
        dense_bytes = kv_bytes_dense(self.cfg, self.ecfg.max_batch, self.cache_len,
                                     dtype_bytes=dtype_bytes)
        if self.paged:
            reserved = kv_bytes_paged(self.cfg, s.alloc.n_pages, s.page_size,
                                      dtype_bytes=dtype_bytes)
            pages_in_use, pages_total = s.alloc.in_use, s.alloc.n_pages - 1
        else:
            reserved, pages_in_use, pages_total = dense_bytes, 0, 0
        self._counters["preemptions"] += len(preempted)
        st = StepStats(
            step=s.step_count, admitted=admitted, finished=finished,
            preempted=preempted, n_running=s.n_running, n_waiting=s.n_waiting,
            prefill_tokens=prefill_tokens, decode_tokens=decode_tokens,
            pages_in_use=pages_in_use, pages_total=pages_total,
            kv_bytes_reserved=reserved, kv_bytes_dense=dense_bytes,
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
                   pages_in_use=s.alloc.in_use if s.alloc else 0,
                   pages_free=s.alloc.n_free if s.alloc else 0,
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


# ---------------------------------------------------------------------------
# Deprecated v0 surface (thin shims over Engine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeSession:
    """Deprecated: use :class:`Engine` (``EngineConfig`` + ``Request`` +
    ``submit()``/``step()``/``drain()``). ``prefill`` runs one cache-fill
    :func:`decode_step` over the session's own dense cache; ``generate``
    drives a dense-cache Engine (and so leaves ``state`` as it was).
    ``params`` are the compute slices at ``groups`` (default one rank)."""

    cfg: ModelConfig
    params: LMParams
    s_max: int
    batch: int
    state: Optional[Dict] = None
    groups: Optional[FoldedGroups] = None

    def __post_init__(self):
        warnings.warn(
            "ServeSession is deprecated; use repro_torch.serve.engine.Engine "
            "(EngineConfig + submit()/step()/drain()) instead.",
            DeprecationWarning, stacklevel=2)
        if self.groups is not None:
            reject_pipelined_mapping(self.groups.pcfg, "ServeSession")
        if self.state is None:
            self.state = init_decode_state(self.cfg, self.batch, self.s_max,
                                           device=self.params.embed.device,
                                           groups=self.groups)
        self._step_fn = make_serve_step(self.cfg, self.groups)

    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        """Batched cache-fill prefill: one chunked decode step over (B, S_p);
        the fp32 logits of the last position (B, 1, V)."""
        toks = torch.as_tensor(np.asarray(prompts), device=self.params.embed.device)
        logits, self.state = self._step_fn(self.params, self.state, toks)
        return logits[:, -1:]

    def generate(self, prompts: np.ndarray, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        prompts = np.asarray(prompts, np.int32)
        eng = Engine(self.cfg, self.params, EngineConfig(
            max_batch=self.batch, s_max=self.s_max, cache="dense",
            prefill_chunk=max(1, int(prompts.shape[1]))), groups=self.groups)
        rids = [eng.submit(Request(prompt=prompts[b], max_new_tokens=n_tokens,
                                   temperature=temperature, seed=seed))
                for b in range(prompts.shape[0])]
        res = eng.drain()
        return np.stack([res[r].tokens for r in rids], axis=0)


def build_session(seed: int, cfg: ModelConfig, *, batch: int, s_max: int,
                  groups: Optional[FoldedGroups] = None, device=None) -> ServeSession:
    """Deprecated: random parameters from ``seed`` (``transformer.init_lm``;
    the reference takes a PRNG key, whose threefry draws torch does not
    reproduce) wrapped in a :class:`ServeSession`; with ``groups``, this
    rank's compute slices of them."""
    params = init_lm(cfg, seed=seed, device=device)
    if groups is not None:
        params = shard_lm_params(params, groups, "compute")
    return ServeSession(cfg=cfg, params=params, s_max=s_max, batch=batch, groups=groups)
