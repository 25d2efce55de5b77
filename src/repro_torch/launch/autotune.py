"""5-D mapping autotuner — cost-model search over folded parallelism mappings.

Port of ``repro.launch.autotune``, priced for the card: every function
takes ``hardware=`` (a ``roofline.analysis.Hardware``, default
``roofline.analysis.H100_SXM``), whose ``hbm_bytes`` is the memory budget
the search prunes against. The cost model keeps the reference's form:
every collective is priced at the one ``link_bw`` (the reference prices
all of them at ICI), so a group that spans nodes is priced as if it stayed
on NVLink (a node-aware model is parked, ROADMAP.md).

The paper's central claim is that *choosing* heterogeneous mappings — an
attention ``(DP, CP, TP)`` and an independent MoE ``(EDP, EP, ETP)`` folded
over the same devices, plus ``pp × vpp`` pipeline stages and a microbatch
count — is what buys MFU at scale.  This module replaces the hand-maintained
``launch/mappings._TABLE`` as the source of truth: it enumerates every
divisibility-valid folded mapping for a given (arch, shape, world size),
prunes by per-device memory and the shared ``mapping_problems`` /
``validate_pipeline`` rules, scores each survivor with a composed analytic
cost model, and emits a ranked list with a per-term cost breakdown.
``pcfg_for(tuned=True)`` takes its winner (:func:`tuned_mapping`).

Cost model — every term in seconds per step per device, composed from the
cost entry points the rest of the codebase already owns:

* ``compute`` / ``gmm``   — dense and routed-expert FLOP time from the
  roofline accounting (``roofline.analysis.model_flops``, peak FLOPs).
* ``tp`` / ``cp`` / ``a2a`` / ``etp`` / ``dp_reduce`` — α-β ring-collective
  times (``roofline.analysis.collective_time``: per-hop latency + wire
  bytes over ``hardware.link_bw``), with bytes derived from the mapping exactly as the
  dispatcher/attention paths shard them.
* ``moe_overlap``         — the chunked A2A↔GMM ladder's overlap-adjusted
  bound ``max(comm, gmm) + ramp`` (``core.overlap.overlap_adjusted_time``),
  applied to the pair the ladder can actually hide.
* ``bubble``              — the *measured* pipeline bubble of the real
  1F1B/interleaved schedule timeline (``core.pipeline.pipeline_cost``),
  not the closed form.
* ``memory``              — device-memory traffic bound; candidates whose
  estimated per-device residency exceeds ``hardware.hbm_bytes`` are pruned
  before scoring.

Winners are validated by tracing the port's real step on fake tensors —
:func:`validate_by_tracing` and the ``--autotune`` mode of
``python -m repro_torch.launch.dryrun``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --autotune mixtral-8x22b \
        train_4k --world 256            # ranked table + top-k tracing
    PYTHONPATH=src python -m repro_torch.launch.autotune --arch mixtral-8x22b \
        --shape train_4k                # ranked table
    PYTHONPATH=src python -m repro_torch.launch.autotune --write-golden PATH
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ParallelConfig, \
    ParallelMappingSpec as PM
from repro_torch.configs.shapes import InputShape, get_shape
from repro_torch.core.overlap import overlap_adjusted_time, resolve_chunks
from repro_torch.core.pipeline import pipeline_cost
from repro_torch.launch.mappings import (_TABLE, mapping_problems, model_for,
                                         validate_pipeline)
from repro_torch.roofline.analysis import H100_SXM, Hardware, model_flops
from repro_torch.roofline.analysis import collective_time as _collective_time

# Candidates whose modeled step times differ by less than this relative
# margin are ties: the analytic model's error bars are far wider than 2%,
# so ranking within the margin would be noise, not signal.
RANK_REL_TOL = 0.02
# Enumeration caps: model parallelism beyond one pod row is never optimal
# on this topology (and the paper's finding 1 is "minimal model
# parallelism"), so the search does not bother with tp/etp > 16.
MAX_TP = 16
MAX_ETP = 16
MAX_PP = 8
MAX_VPP = 4
# HBM round trips per activation element per layer (reads + writes across
# norm/attn/ffn/residual) — only the relative weight vs parameter traffic
# matters for ranking.
ACT_RW = 12.0


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _split_params(cfg: ModelConfig) -> Tuple[float, float]:
    """(dense_params, routed_expert_params) — routed experts are the part
    sharded over (EDP, EP, ETP); everything else (attention, shared
    experts, router, embeddings, dense FFNs) follows the attention fold."""
    routed = 0.0
    if cfg.moe is not None:
        e = cfg.moe
        n_act = 3 if cfg.activation in ("swiglu", "geglu") else 2
        per_layer = e.n_experts * n_act * cfg.d_model * e.d_expert
        routed = per_layer * sum(1 for b in cfg.blocks() if b == "moe")
    return float(cfg.param_count()) - routed, routed


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the 5-D search space.

    ``attn``/``moe`` are per-pipeline-stage mappings (their size times
    ``pp`` is the world size), matching ``ParallelConfig`` semantics.
    """
    attn: Tuple[int, int, int]          # (dp, cp, tp)
    moe: Tuple[int, int, int]           # (edp, ep, etp)
    pp: int = 1
    vpp: int = 1
    microbatch: int = 0

    @property
    def world(self) -> int:
        return self.pp * self.attn[0] * self.attn[1] * self.attn[2]

    def pcfg(self) -> ParallelConfig:
        return ParallelConfig(
            attn=PM(dp=self.attn[0], inner=self.attn[1], tp=self.attn[2]),
            moe=PM(dp=self.moe[0], inner=self.moe[1], tp=self.moe[2]),
            pp=self.pp, vpp=self.vpp, microbatch=self.microbatch, fsdp=True)

    def label(self) -> str:
        a, m = self.attn, self.moe
        s = f"dp{a[0]}cp{a[1]}tp{a[2]}/edp{m[0]}ep{m[1]}etp{m[2]}"
        if self.pp > 1 or self.vpp > 1:
            s += f"/pp{self.pp}v{self.vpp}"
        if self.microbatch:
            s += f"/m{self.microbatch}"
        return s


@dataclasses.dataclass(frozen=True)
class Scored:
    """A candidate with its modeled step time, MFU bound and breakdown."""
    candidate: Candidate
    total_s: float
    mfu: float
    mem_bytes: int
    breakdown: Dict[str, float]


def enumerate_candidates(cfg: ModelConfig, shape: InputShape, world: int, *,
                         pp: Optional[int] = None,
                         vpp: Optional[int] = None) -> Iterator[Candidate]:
    """All divisibility-valid candidates for (cfg, shape) on ``world`` chips.

    Rules enforced (shared with the import-time ``_TABLE`` check via
    ``mappings.mapping_problems``): head/KV-head % TP, seq % CP·TP and
    seq % 2·CP, experts % EP, d_expert % ETP, foldability of the two
    factorizations, whole sequences per DP rank, whole tokens per
    (EDP·EP) rank, and — for pipeline candidates — the stage partition and
    microbatch rules of ``validate_pipeline``. ``pp``/``vpp`` restrict the
    pipeline dimensions when given (the ``pcfg_for(tuned=True)`` path).
    """
    train = shape.kind == "train"
    batch, seq = shape.global_batch, shape.seq_len
    pp_opts = [p for p in _divisors(world) if p <= MAX_PP] if train else [1]
    if pp is not None:
        pp_opts = [p for p in pp_opts if p == pp]
    for pp_ in pp_opts:
        vpp_opts = [1] if pp_ == 1 else [v for v in range(1, MAX_VPP + 1)]
        if vpp is not None:
            vpp_opts = [v for v in vpp_opts if v == vpp]
        # Validate the stage partition once per (pp, vpp); models the
        # partitioner rejects (encoder-decoder, shared attention,
        # layers % pp·vpp) simply contribute no candidates at that depth.
        ok_vpps = []
        for v in vpp_opts:
            try:
                pipeline_cost(cfg, pp_, v, max(pp_ * v, 1))
            except (ValueError, RuntimeError):
                continue
            ok_vpps.append(v)
        if not ok_vpps:
            continue
        ws = world // pp_
        attns = []
        for tp in _divisors(ws):
            # As the reference's search: TP that does not divide the heads
            # (K/V replicated over TP) buys attention nothing.
            if tp > MAX_TP or cfg.n_heads % tp or cfg.n_kv_heads % tp:
                continue
            for cp in _divisors(ws // tp):
                if seq % (2 * cp) or seq % (cp * tp):
                    continue
                dp = ws // (tp * cp)
                if batch % dp:
                    continue            # whole sequences per DP rank
                attns.append((dp, cp, tp))
        moes: List[Tuple[int, int, int]]
        if cfg.moe is None:
            pairs = [(a, a) for a in attns]
        else:
            moes = []
            for etp in _divisors(ws):
                if etp > MAX_ETP or cfg.moe.d_expert % etp:
                    continue
                for ep in _divisors(ws // etp):
                    if cfg.moe.n_experts % ep:
                        continue
                    moes.append((ws // (etp * ep), ep, etp))
            pairs = [(a, m) for a in attns for m in moes
                     if not mapping_problems(cfg, seq, a, m)]
        for attn, moe in pairs:
            dp = attn[0]
            if train:
                m_opts = [m for m in _divisors(batch // dp)
                          if (pp_ == 1 or m % pp_ == 0)]
            else:
                m_opts = [0]
            for v in ok_vpps:
                for m in m_opts:
                    if v > 1 and m % pp_:
                        continue
                    yield Candidate(attn=attn, moe=moe, pp=pp_, vpp=v,
                                    microbatch=m)


# ---------------------------------------------------------------------------
# Memory estimate (pruning)
# ---------------------------------------------------------------------------

def estimate_memory_bytes(cfg: ModelConfig, shape: InputShape,
                          cand: Candidate) -> int:
    """Analytic per-device residency of a candidate, in bytes.

    Train: FSDP-sharded train state (bf16 params + fp32 grads + two fp32
    Adam moments = 18 B/param over dp×tp, experts over edp×ep×etp), the
    double-buffered per-layer gathered working weights, the remat-boundary
    activation stash scaled by the schedule's in-flight bound, and the
    fp32 logits buffer. Serve: world-sharded stored params, gathered
    per-layer weights, and the KV cache over (dp, cp, tp).
    """
    (dp, cp, tp), (edp, ep, etp) = cand.attn, cand.moe
    pp_ = cand.pp
    train = shape.kind == "train"
    dense, routed = _split_params(cfg)
    L = cfg.n_layers
    dense_stage = dense / pp_
    routed_stage = routed / pp_
    dense_layer = dense / L
    routed_layer = routed / max(1, sum(1 for b in cfg.blocks() if b == "moe"))
    gathered = 2 * 2.0 * (dense_layer / tp + routed_layer / (ep * etp))
    if train:
        m = max(cand.microbatch, 1)
        state = 18.0 * (dense_stage / (dp * tp)
                        + routed_stage / (edp * ep * etp))
        tok_dev = shape.global_batch * shape.seq_len / (m * dp * cp * tp)
        in_flight = pipeline_cost(cfg, pp_, cand.vpp, m).max_in_flight
        stash = tok_dev * cfg.d_model * 2.0 * (L / pp_) * in_flight
        logits = tok_dev * cfg.vocab_size * 4.0
        return int(state + gathered + stash + logits)
    stored = 2.0 * (dense + routed) / cand.world
    kv = (2.0 * shape.global_batch * shape.seq_len * cfg.kv_dim * 2.0
          / (dp * cp * tp))
    if cfg.family == "ssm":
        kv = 0.0
    act = 0.0
    if shape.kind == "prefill":
        act = (shape.global_batch * shape.seq_len / (dp * cp * tp)
               * cfg.d_model * 2.0 * 4.0)
    return int(stored + gathered + kv + act)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def score(cfg: ModelConfig, shape: InputShape, cand: Candidate, *,
          hardware: Hardware = H100_SXM) -> Scored:
    """Model the per-step time of one candidate; see the module docstring
    for the term-by-term derivation. All terms are per device."""
    PEAK_FLOPS, HBM_BW = hardware.peak_flops, hardware.hbm_bw
    LINK_BW, LINK_LATENCY = hardware.link_bw, hardware.link_latency

    def collective_time(kind, nbytes, group):
        return _collective_time(kind, nbytes, group, hardware=hardware)
    (dp, cp, tp), (edp, ep, etp) = cand.attn, cand.moe
    pp_, world = cand.pp, cand.world
    train = shape.kind == "train"
    fb = 3.0 if train else 1.0          # bwd ≈ 2× fwd
    m = max(cand.microbatch, 1) if train else 1
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    d = cfg.d_model
    L = cfg.n_layers
    Ls = L / pp_
    dense, routed = _split_params(cfg)

    # -- compute ---------------------------------------------------------
    mf = model_flops(cfg, shape)
    gmm_flops = 0.0
    if cfg.moe is not None:
        e = cfg.moe
        n_act = 3 if cfg.activation in ("swiglu", "geglu") else 2
        n_moe = sum(1 for b in cfg.blocks() if b == "moe")
        gmm_flops = (tokens * e.top_k * n_moe * n_act * 2.0 * d
                     * e.d_expert * fb)
    t_gmm = gmm_flops / world / PEAK_FLOPS
    t_dense = max(mf - gmm_flops, 0.0) / world / PEAK_FLOPS

    # -- attention-side collectives -------------------------------------
    # Sequence-parallel TP: 2×AG + 2×RS per layer on the full activation a
    # rank materializes inside its tp group (same wire bytes each way).
    act_bytes = tokens / m / (dp * cp) * d * 2.0
    t_tp = (fb * m * Ls * 4.0 * collective_time("all-gather", act_bytes, tp)
            if tp > 1 else 0.0)
    # Ring CP: (cp-1) rotations of the local KV block per layer; decode
    # rings carry the per-step query/partials instead of the cache.
    t_cp = 0.0
    if cp > 1:
        if shape.kind == "decode":
            blk = shape.global_batch / dp * d * 2.0
        else:
            blk = tokens / m / (dp * cp) * cfg.kv_dim * 2.0 * 2.0
        t_cp = fb * m * Ls * (cp - 1) * (LINK_LATENCY + blk / LINK_BW)

    # -- MoE collectives + overlap --------------------------------------
    t_a2a = t_etp = 0.0
    t_moe = t_gmm
    oc = 1
    if cfg.moe is not None:
        n_moe_s = n_moe / pp_
        local = tokens / m / (edp * ep)         # tokens entering the layer
        r_bytes = local * cfg.moe.top_k * d * 2.0
        if ep > 1:
            t_a2a = (fb * m * n_moe_s * 2.0
                     * collective_time("all-to-all", r_bytes, ep))
        if etp > 1:
            t_etp = (fb * m * n_moe_s
                     * (collective_time("all-gather", r_bytes * etp, etp)
                        + collective_time("reduce-scatter", r_bytes, etp)))
        oc = resolve_chunks(max(int(local), 1), cfg.moe.overlap_chunks)
        t_moe = overlap_adjusted_time(t_a2a + t_etp, t_gmm, oc)

    # -- DP gradient reduce / FSDP param gather (once per step) ---------
    t_dp = 0.0
    if train:
        dshard = dense / pp_ * 2.0 / tp          # bf16 working copy
        eshard = routed / pp_ * 2.0 / (ep * etp)
        for shard, g in ((dshard, dp), (eshard, edp)):
            if g > 1 and shard:
                t_dp += (2.0 * collective_time("all-gather", shard, g)
                         + collective_time("reduce-scatter",
                                           2.0 * shard / g, g))

    # -- HBM traffic -----------------------------------------------------
    wread = (dense / pp_ * 2.0 / tp + routed / pp_ * 2.0 / (ep * etp))
    if train:
        hbm = m * 2.0 * wread + (tokens / (dp * cp * tp) * d * 2.0
                                 * Ls * ACT_RW * fb / 3.0)
    elif shape.kind == "prefill":
        hbm = wread + tokens / (dp * cp * tp) * d * 2.0 * Ls * ACT_RW
    else:
        kv = (2.0 * shape.global_batch * shape.seq_len * cfg.kv_dim * 2.0
              / (dp * cp * tp))
        if cfg.family == "ssm":
            kv = 0.0
        hbm = wread + kv
    t_mem = hbm / HBM_BW

    # -- pipeline bubble -------------------------------------------------
    bubble = pipeline_cost(cfg, pp_, cand.vpp, m).bubble if train else 0.0

    core = t_dense + t_moe + t_tp + t_cp
    total = max(core, t_mem) / (1.0 - bubble) + t_dp
    mfu = mf / (total * PEAK_FLOPS * world) if total > 0 else 0.0
    breakdown = {
        "compute": t_dense, "gmm": t_gmm, "tp": t_tp, "cp": t_cp,
        "a2a": t_a2a, "etp": t_etp, "moe_overlap": t_moe,
        "overlap_chunks": float(oc), "dp_reduce": t_dp, "memory": t_mem,
        "bubble": bubble, "total": total,
    }
    return Scored(candidate=cand, total_s=total, mfu=mfu,
                  mem_bytes=estimate_memory_bytes(cfg, shape, cand),
                  breakdown=breakdown)


def collective_byte_budget(cfg: ModelConfig, shape: InputShape,
                           cand: Candidate, *, hardware: Hardware = H100_SXM) -> List[Dict]:
    """Analytic per-device wire-byte budget, one entry per collective family.

    The byte side of :func:`score`'s collective terms (which turn these
    same derivations into α-β times), exposed for the collective audit
    (``analysis.audit``): each entry names the logical axes a family is
    *allowed* to communicate over, the collective kinds it may use, and the
    analytic per-step per-device wire bytes. A collective of the traced
    step that matches no entry is unbudgeted — the stray-collective bug
    class.

    Entries (``side``/``logical`` resolve to mesh atoms via ``FoldedMesh``):

    * ``seqpar`` — sequence-parallel activation AG/RS (and fused AR /
      layout all-to-alls) over the combined (cp · tp) sequence atoms.
    * ``cp``   — ring-CP KV rotations (permutes) or allgather-KV.
    * ``a2a``  — EP token dispatch/combine all-to-alls (+ the ragged path's
      count-exchange all-gathers).
    * ``etp``  — AG-V/RS-V around the expert FFN inside the etp group.
    * ``dp`` / ``edp`` — FSDP param gathers + gradient reduce-scatter
      (train), or stored-weight gathers (serve) over each side's full
      data-parallel axis.
    """
    (dp, cp, tp), (edp, ep, etp) = cand.attn, cand.moe
    pp_ = cand.pp
    train = shape.kind == "train"
    fb = 3.0 if train else 1.0
    m = max(cand.microbatch, 1) if train else 1
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    d = cfg.d_model
    Ls = cfg.n_layers / pp_
    dense, routed = _split_params(cfg)
    entries: List[Dict] = []

    # Sequence-parallel activation layout: activations enter each layer
    # sharded over the (cp · tp) sequence atoms, so the AG/RS (and fused
    # AR / layout all-to-all) resharding family spans *both* axes — at
    # tp=1, cp>1 the same collectives simply lower over the cp atoms.
    act_dp = tokens / m / dp * d * 2.0      # activation bytes per dp rank
    if cp * tp > 1:
        entries.append(dict(
            name="seqpar", side="attn", logical=("cp", "tp"),
            kinds=("all-gather", "reduce-scatter", "all-reduce",
                   "all-to-all"),
            bytes=fb * m * Ls * 4.0 * act_dp))
    if cp > 1:
        if shape.kind == "decode":
            blk = shape.global_batch / dp * d * 2.0
        else:
            blk = tokens / m / (dp * cp) * cfg.kv_dim * 2.0 * 2.0
        # GSPMD fuses dp batch-resharding into the ring rotation, so the
        # permutes can span the (dp · cp) atoms jointly.
        entries.append(dict(
            name="cp", side="attn", logical=("cp", "dp"),
            kinds=("collective-permute", "all-gather", "all-to-all"),
            bytes=fb * m * Ls * (cp - 1) * blk))
    n_ssm_s = sum(1 for b in cfg.blocks()
                  if b not in ("dense", "moe")) / pp_
    if n_ssm_s and dp * cp * tp > 1:
        # Sequence stays unsharded inside recurrent blocks, so every ssm
        # layer reshards the cp-sharded activations on entry/exit, carries
        # its state (per-head hd×hd matrices dwarf the activations at
        # decode), and exchanges conv halos / sLSTM heads over tp — all
        # lowered as permute chains over the whole attn fold.
        hd = cfg.resolved_head_dim
        state = shape.global_batch / dp * cfg.n_heads * hd * (hd + 2) * 4.0
        entries.append(dict(
            name="ssm-reshard", side="attn", logical=("cp", "dp", "tp"),
            kinds=("collective-permute", "all-gather",
                   "reduce-scatter", "all-to-all"),
            bytes=fb * m * n_ssm_s * 2.0 * (act_dp + state)))
    if cfg.moe is not None:
        n_moe_s = sum(1 for b in cfg.blocks() if b == "moe") / pp_
        local = tokens / m / (edp * ep)
        r_bytes = local * cfg.moe.top_k * d * 2.0
        if ep > 1:
            # GSPMD fuses the dp→(edp·ep) batch resharding and the etp
            # layout change into the dispatch exchange (so the family may
            # span the edp and etp atoms too) and is free to lower
            # small-group exchanges as permute chains.
            entries.append(dict(
                name="a2a", side="moe", logical=("ep", "edp", "etp"),
                kinds=("all-to-all", "all-gather", "collective-permute"),
                bytes=fb * m * n_moe_s * 2.0 * r_bytes))
        if etp > 1:
            entries.append(dict(
                name="etp", side="moe", logical=("etp",),
                kinds=("all-gather", "reduce-scatter", "all-reduce"),
                bytes=fb * m * n_moe_s
                * (r_bytes * etp * (etp - 1) / etp + r_bytes * (etp - 1))))
    # Data-parallel / FSDP weight+grad traffic. Serve paths gather the
    # world-sharded stored weights once per step; train adds the gradient
    # reduce-scatter and runs the gather per microbatch.
    dshard = dense / pp_ * 2.0 / tp
    eshard = routed / pp_ * 2.0 / (ep * etp)
    dp_logical = ("dp",) if train else ("dp", "cp", "tp")
    for name, side, logical, shard, g in (
            ("dp", "attn", dp_logical, dshard,
             dp if train else dp * cp * tp),
            ("edp", "moe", ("edp",), eshard, edp)):
        if g > 1 and shard:
            per_gather = shard * (g - 1) / g
            nbytes = (m * 2.0 * per_gather + 2.0 * per_gather if train
                      else per_gather)
            entries.append(dict(
                name=name, side=side, logical=logical,
                kinds=("all-gather", "reduce-scatter", "all-reduce"),
                bytes=nbytes))
    return entries


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def search_mappings(arch: str, shape_name: str, world: int = 256, *,
                    pp: Optional[int] = None, vpp: Optional[int] = None,
                    mem_limit: Optional[int] = None,
                    top: Optional[int] = None,
                    hardware: Hardware = H100_SXM) -> List[Scored]:
    """Enumerate, prune, score and rank every valid mapping.

    Returns candidates sorted by modeled step time (best first), pruned to
    those whose estimated per-device memory fits ``mem_limit`` (default
    ``hardware.hbm_bytes``). ``top`` truncates the returned list (the full
    space is still searched).

    If *no* mapping fits — a model whose train state (18 B a parameter)
    oversubscribes the world's aggregate device memory at every
    sharding — the prune is
    waived rather than failing the search: the ranking is still the
    honest relative ordering, callers see ``mem_bytes > mem_limit`` and
    know the row needs offload/recompute machinery the model doesn't
    cost. Raises only when enumeration itself is empty.
    """
    mem_limit = hardware.hbm_bytes if mem_limit is None else mem_limit
    cfg = model_for(arch, shape_name)
    shape = get_shape(shape_name)
    out: List[Scored] = []
    for cand in enumerate_candidates(cfg, shape, world, pp=pp, vpp=vpp):
        out.append(score(cfg, shape, cand, hardware=hardware))
    if not out:
        raise ValueError(
            f"no divisibility-valid mapping for ({arch!r}, {shape_name!r}) "
            f"at world={world}")
    fits = [s for s in out if s.mem_bytes <= mem_limit]
    out = fits or out
    out.sort(key=lambda s: (s.total_s, s.candidate.label()))
    return out[:top] if top else out


def rank_of(scored: Sequence[Scored], attn: Tuple[int, int, int],
            moe: Tuple[int, int, int], microbatch: Optional[int] = None, *,
            rel_tol: float = RANK_REL_TOL) -> Tuple[int, Scored]:
    """(rank, entry) of a specific mapping within a scored list.

    Rank counts candidates whose modeled time beats the mapping by more
    than ``rel_tol`` (near-ties share a rank — the model's resolution is
    coarser than its float output). Raises if the mapping was never
    enumerated — a committed row the search space excludes is a bug.
    """
    match = [s for s in scored
             if s.candidate.attn == attn and s.candidate.moe == moe
             and (microbatch is None or s.candidate.microbatch == microbatch)
             and s.candidate.pp == 1 and s.candidate.vpp == 1]
    if not match:
        raise ValueError(
            f"mapping attn={attn} moe={moe} m={microbatch} not in the "
            f"searched space ({len(scored)} candidates)")
    best = min(match, key=lambda s: s.total_s)
    better = sum(1 for s in scored
                 if s.total_s < best.total_s * (1.0 - rel_tol))
    return better + 1, best


@functools.lru_cache(maxsize=256)
def tuned_mapping(arch: str, shape_name: str, world: int, *, pp: int = 1,
                  vpp: int = 1, hardware: Hardware = H100_SXM
                  ) -> Tuple[Tuple[int, int, int],
                                         Tuple[int, int, int], int]:
    """Search winner in ``_TABLE`` row convention for ``pcfg_for(tuned=)``.

    Returns ``(attn, moe, microbatch)`` with the pipeline factor folded
    back into dp on both sides (``pcfg_for`` carves it out again), so the
    tuned path slots into the existing table machinery unchanged.
    """
    best = search_mappings(arch, shape_name, world, pp=pp, vpp=vpp, top=1,
                           hardware=hardware)[0]
    c = best.candidate
    return ((c.attn[0] * pp, c.attn[1], c.attn[2]),
            (c.moe[0] * pp, c.moe[1], c.moe[2]), c.microbatch)


# ---------------------------------------------------------------------------
# Reporting / golden snapshot / tracing validation
# ---------------------------------------------------------------------------

_BREAKDOWN_KEYS = ("compute", "gmm", "tp", "cp", "a2a", "etp", "dp_reduce",
                   "memory", "bubble")


def _round(x: float) -> float:
    return float(f"{x:.6g}")


def _row(s: Scored) -> Dict:
    return {
        "mapping": s.candidate.label(),
        "attn": list(s.candidate.attn), "moe": list(s.candidate.moe),
        "pp": s.candidate.pp, "vpp": s.candidate.vpp,
        "microbatch": s.candidate.microbatch,
        "step_ms": _round(s.total_s * 1e3), "mfu": _round(s.mfu),
        "mem_gib": _round(s.mem_bytes / 2 ** 30),
        "breakdown_ms": {k: _round(s.breakdown[k] * 1e3)
                         for k in _BREAKDOWN_KEYS if k != "bubble"},
        "bubble": _round(s.breakdown["bubble"]),
    }


def table_report(arch: str, shape_name: str,
                 world: Optional[int] = None, *, hardware: Hardware = H100_SXM) -> Dict:
    """Rank the committed ``_TABLE`` row inside the searched space.

    One dict per row with the committed mapping's rank and both cost
    breakdowns (committed vs search winner); at the reference's constants
    it equals the reference's ``tests/autotune_golden.json`` row.

    Ranks within the ``pp=1, vpp=1`` slice: a ``_TABLE`` row is
    pp-agnostic (``pcfg_for`` carves pipeline stages out of its dp), so
    the fair comparison set is the slice the row is actually used at by
    default. The pipeline dimensions are searched by the unrestricted
    ``dryrun --autotune`` CLI.
    """
    attn, moe, nm = _TABLE[(arch, shape_name)]
    if world is None:
        world = attn[0] * attn[1] * attn[2]
    scored = search_mappings(arch, shape_name, world, pp=1, vpp=1, hardware=hardware)
    rank, committed = rank_of(scored, attn, moe, nm)
    return {
        "arch": arch, "shape": shape_name, "world": world,
        "n_candidates": len(scored), "rank": rank,
        "fits_memory": committed.mem_bytes <= hardware.hbm_bytes,
        "committed": _row(committed), "best": _row(scored[0]),
    }


def golden_report(world: Optional[int] = None, *, hardware: Hardware = H100_SXM) -> Dict:
    """Every table row's :func:`table_report` (the reference's
    ``tests/autotune_golden.json`` payload at its constants)."""
    rows = {}
    for arch, shape_name in sorted(_TABLE):
        rows[f"{arch}|{shape_name}"] = table_report(arch, shape_name, world,
                                                    hardware=hardware)
    return {"rel_tol": RANK_REL_TOL, "max_rank": 3, "rows": rows}


def format_markdown(scored: Sequence[Scored], top: int = 10,
                    title: str = "", *, hardware: Hardware = H100_SXM) -> str:
    """Ranked-mapping markdown table (CLI, nightly step summary)."""
    lines = []
    if title:
        lines += [f"### {title}", ""]
    lines += ["| rank | mapping | step ms | MFU | mem GiB | fits | "
              + " | ".join(_BREAKDOWN_KEYS) + " |",
              "|" + "---|" * (6 + len(_BREAKDOWN_KEYS))]
    n_over = 0
    for i, s in enumerate(scored[:top], 1):
        b = s.breakdown
        fits = s.mem_bytes <= hardware.hbm_bytes
        n_over += not fits
        terms = [f"{b['bubble']:.3f}" if k == "bubble" else f"{b[k]*1e3:.2f}"
                 for k in _BREAKDOWN_KEYS]
        lines.append(
            f"| {i} | `{s.candidate.label()}` | {s.total_s*1e3:.2f} | "
            f"{s.mfu:.3f} | {s.mem_bytes/2**30:.2f} | "
            f"{'yes' if fits else '**NO**'} | " + " | ".join(terms) + " |")
    if n_over:
        lines += ["", f"**{n_over} of {min(top, len(scored))} shown "
                  f"mappings exceed the {hardware.hbm_bytes/2**30:.0f} GiB HBM "
                  "budget** — the memory prune was waived because no "
                  "candidate fits (see `search_mappings`)."]
    return "\n".join(lines) + "\n"


def validate_by_tracing(arch: str, shape_name: str, scored: Sequence[Scored],
                        k: int = 3, *, device: str = "cpu") -> List[Dict]:
    """Trace the top-``k`` candidates' real step on fake tensors
    (``launch.dryrun.trace_pair``, rank 0 of each candidate's world), so a
    candidate that passed every analytic rule but whose step does not run
    (a batch that ``data.pipeline.shard_batch`` cannot cut, a pipeline the
    layers do not split into) is caught before it is used. K/V heads that
    TP does not divide and hand-offs across DP ranks run since they are
    ported; the search still leaves the former out, as the reference's
    does."""
    from repro_torch.launch.dryrun import trace_pair
    out = []
    for s in scored[:k]:
        pcfg = s.candidate.pcfg()
        rec = {"mapping": s.candidate.label(), "world": pcfg.world_size}
        try:
            validate_pipeline(arch, pcfg)
            trace_pair(arch, shape_name, pcfg=pcfg, device=device)
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001 — report, caller decides
            rec.update(ok=False, error=f"{type(e).__name__}: {e}")
        out.append(rec)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--write-golden", default=None, metavar="PATH",
                    help="write the full-table report at H100_SXM and exit")
    args = ap.parse_args()
    if args.write_golden:
        rep = golden_report(args.world)
        with open(args.write_golden, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
            f.write("\n")
        bad = {k: r["rank"] for k, r in rep["rows"].items() if r["rank"] > 3}
        print(f"wrote {args.write_golden}: {len(rep['rows'])} rows"
              + (f"; OUT-OF-TOP-3: {bad}" if bad else "; all rows in top-3"))
        raise SystemExit(1 if bad else 0)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --write-golden")
    scored = search_mappings(args.arch, args.shape, args.world or 256)
    print(format_markdown(scored, args.top,
                          title=f"{args.arch} x {args.shape} x "
                                f"{args.world or 256} ranks at {H100_SXM.name} "
                                f"({len(scored)} candidates)"))


if __name__ == "__main__":
    main()
