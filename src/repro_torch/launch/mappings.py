"""Per-(architecture × shape) parallelism mappings: the paper's tuning surface.

Port of ``repro.launch.mappings``, as data and the same checks. Attention
gets (DP, CP, TP); the MoE layer gets an independent folded (EDP, EP,
ETP). The choices follow the paper's findings: minimal model parallelism,
EP over ETP (§4.4 finding 4), EP folded into the attention TP/CP atoms so
that the All-to-All stays within the fast links.

Every row covers a world of 256 ranks (one pod). ``multi_pod`` doubles the
world through the pod axis: extra DP for train/prefill/decode batches,
extra CP (KV-cache sharding) for ``long_500k``. ``pipeline`` stages are
carved out of DP (``pcfg_for(pp=)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelMappingSpec as PM
from repro_torch.configs.shapes import get_shape

SWA_WINDOW = 8192  # sliding window used to run long_500k on full-attention archs


# (arch, shape) -> (attn (dp,cp,tp), moe (edp,ep,etp), microbatch)
# The reference's rows, which its cost-model search (``launch/autotune.py``,
# at the reference's constants) reproduces. Every row satisfies each divisibility rule
# (``mapping_problems``, checked at import).
_TABLE: Dict[Tuple[str, str], Tuple[Tuple[int, int, int], Tuple[int, int, int], int]] = {
    # ---- train_4k: B=256, S=4096 --------------------------------------
    # FSDP makes wide DP cheap (grad wire bytes are dp-invariant) while
    # unoverlapped TP collectives scale with tokens: tp<=2 for dense archs,
    # and the MoE fold goes to wide EP.
    ("llama3.2-1b", "train_4k"):   ((128, 1, 2), (128, 1, 2), 1),
    ("xlstm-125m", "train_4k"):    ((128, 1, 2), (128, 1, 2), 1),
    ("codeqwen1.5-7b", "train_4k"): ((128, 1, 2), (128, 1, 2), 1),
    ("zamba2-2.7b", "train_4k"):   ((256, 1, 1), (256, 1, 1), 1),
    ("dbrx-132b", "train_4k"):     ((256, 1, 1), (16, 16, 1), 1),
    ("qwen3-moe-30b-a3b", "train_4k"): ((256, 1, 1), (2, 128, 1), 1),
    ("whisper-small", "train_4k"): ((128, 1, 2), (128, 1, 2), 1),
    ("qwen1.5-4b", "train_4k"):    ((128, 1, 2), (128, 1, 2), 1),
    ("gemma-7b", "train_4k"):      ((64, 1, 4), (64, 1, 4), 1),
    ("qwen2-vl-7b", "train_4k"):   ((128, 1, 2), (128, 1, 2), 1),
    # paper models (benchmarks): mixtral keeps dp/edp divisible by 4 so
    # pcfg_for can carve pp in {2, 4} out of DP.
    ("mixtral-8x22b", "train_4k"): ((128, 2, 1), (16, 8, 2), 2),
    ("mixtral-8x22b-g8t8", "train_4k"): ((256, 1, 1), (4, 64, 1), 1),
    ("qwen2-57b-a14b", "train_4k"): ((128, 1, 2), (4, 64, 1), 1),
    ("llama3-8x70b", "train_4k"):  ((256, 1, 1), (16, 8, 2), 1),
    # ---- prefill_32k: B=32, S=32768 ------------------------------------
    # Prefill is throughput-bound like train but with no optimizer state:
    # CP spreads the 32k quadratic term without TP's per-layer collectives.
    ("llama3.2-1b", "prefill_32k"):   ((32, 8, 1), (32, 8, 1), 0),
    ("xlstm-125m", "prefill_32k"):    ((32, 4, 2), (32, 4, 2), 0),
    ("codeqwen1.5-7b", "prefill_32k"): ((32, 8, 1), (32, 8, 1), 0),
    ("zamba2-2.7b", "prefill_32k"):   ((32, 2, 4), (32, 2, 4), 0),
    ("dbrx-132b", "prefill_32k"):     ((32, 8, 1), (256, 1, 1), 0),
    ("qwen3-moe-30b-a3b", "prefill_32k"): ((32, 8, 1), (256, 1, 1), 0),
    ("whisper-small", "prefill_32k"): ((32, 2, 4), (32, 2, 4), 0),
    ("qwen1.5-4b", "prefill_32k"):    ((32, 2, 4), (32, 2, 4), 0),
    ("gemma-7b", "prefill_32k"):      ((32, 8, 1), (32, 8, 1), 0),
    ("qwen2-vl-7b", "prefill_32k"):   ((32, 8, 1), (32, 8, 1), 0),
    # ---- decode_32k: B=128, S_cache=32768 -------------------------------
    # Decode is bound by weight reads from device memory: TP (and ETP for
    # the MoE side) divides the per-device stream, so big tp wins where
    # heads allow.
    ("llama3.2-1b", "decode_32k"):   ((16, 2, 8), (16, 2, 8), 0),
    ("xlstm-125m", "decode_32k"):    ((64, 2, 2), (64, 2, 2), 0),
    ("codeqwen1.5-7b", "decode_32k"): ((16, 1, 16), (16, 1, 16), 0),
    ("zamba2-2.7b", "decode_32k"):   ((16, 4, 4), (16, 4, 4), 0),
    ("dbrx-132b", "decode_32k"):     ((32, 2, 4), (2, 16, 8), 0),
    ("qwen3-moe-30b-a3b", "decode_32k"): ((64, 1, 4), (4, 16, 4), 0),
    ("whisper-small", "decode_32k"): ((16, 4, 4), (16, 4, 4), 0),
    ("qwen1.5-4b", "decode_32k"):    ((16, 4, 4), (16, 4, 4), 0),
    ("gemma-7b", "decode_32k"):      ((16, 1, 16), (16, 1, 16), 0),
    ("qwen2-vl-7b", "decode_32k"):   ((16, 4, 4), (16, 4, 4), 0),
    # ---- long_500k: B=1, S_cache=524288 ---------------------------------
    ("llama3.2-1b", "long_500k"):   ((1, 32, 8), (1, 32, 8), 0),
    ("xlstm-125m", "long_500k"):    ((1, 128, 2), (1, 128, 2), 0),
    ("codeqwen1.5-7b", "long_500k"): ((1, 32, 8), (1, 32, 8), 0),
    ("zamba2-2.7b", "long_500k"):   ((1, 64, 4), (1, 64, 4), 0),
    ("dbrx-132b", "long_500k"):     ((1, 32, 8), (2, 16, 8), 0),
    ("qwen3-moe-30b-a3b", "long_500k"): ((1, 64, 4), (8, 8, 4), 0),
    ("whisper-small", "long_500k"): ((1, 64, 4), (1, 64, 4), 0),
    ("qwen1.5-4b", "long_500k"):    ((1, 64, 4), (1, 64, 4), 0),
    ("gemma-7b", "long_500k"):      ((1, 32, 8), (1, 32, 8), 0),
    ("qwen2-vl-7b", "long_500k"):   ((1, 64, 4), (1, 64, 4), 0),
}


def mapping_problems(cfg: ModelConfig, seq: int,
                     attn: Tuple[int, int, int],
                     moe: Optional[Tuple[int, int, int]] = None) -> list:
    """Every divisibility rule one folded mapping must satisfy.

    Returns a list of human-readable violations (empty = valid): attention
    head/sequence divisibility, MoE expert/hidden divisibility, and
    foldability of the two factorizations over one device block (paper
    §3.2, ``core.folding.common_refinement``). The import-time ``_TABLE``
    check uses it. The head rules are the table's, as the reference's: a
    fold whose TP does not divide the K/V heads runs (every TP rank keeps
    them whole, ``models.attention.kv_replicated``), but spends TP on
    nothing there, so no table row takes it.
    """
    from repro_torch.core.folding import common_refinement
    adp, acp, atp = attn
    problems = []
    checks = [
        (cfg.n_heads % atp == 0,
         f"n_heads {cfg.n_heads} not divisible by tp={atp}"),
        (cfg.n_kv_heads % atp == 0,
         f"n_kv_heads {cfg.n_kv_heads} not divisible by tp={atp}"),
        (seq % (acp * atp) == 0,
         f"seq_len {seq} not divisible by cp*tp={acp * atp} "
         "(sequence-parallel entry layout)"),
        (seq % (2 * acp) == 0,
         f"seq_len {seq} not divisible by 2*cp={2 * acp} "
         "(load-balanced ring-CP chunking)"),
    ]
    if moe is not None and cfg.moe is not None:
        edp, ep, etp = moe
        checks += [
            (edp * ep * etp == adp * acp * atp,
             f"moe mapping size {edp * ep * etp} != attention mapping "
             f"size {adp * acp * atp} (must cover the same devices)"),
            (cfg.moe.n_experts % ep == 0,
             f"n_experts {cfg.moe.n_experts} not divisible by ep={ep}"),
            (cfg.moe.d_expert % etp == 0,
             f"d_expert {cfg.moe.d_expert} not divisible by etp={etp}"),
        ]
        if edp * ep * etp == adp * acp * atp:
            try:
                common_refinement([adp, acp, atp], [edp, ep, etp])
            except ValueError as e:
                checks.append((False, str(e)))
    for ok, msg in checks:
        if not ok:
            problems.append(msg)
    return problems


def _validate_table() -> None:
    """Import-time check of every ``_TABLE`` row: a bad row (heads not
    divisible by TP, sequence not divisible by the CP×TP sequence-parallel
    layout or the 2·CP zigzag chunking, experts not divisible by EP,
    unfoldable factorizations) fails here, naming the (arch, shape) row and
    the violated constraint, not deep inside a step."""
    problems = []
    for (arch, shape_name), (attn, moe, _nm) in _TABLE.items():
        try:
            cfg = get_config(arch)
            seq = get_shape(shape_name).seq_len
        except KeyError as e:
            problems.append(f"({arch!r}, {shape_name!r}): {e}")
            continue
        for msg in mapping_problems(cfg, seq, attn, moe):
            problems.append(f"({arch!r}, {shape_name!r}): {msg}")
    if problems:
        raise ValueError(
            "invalid parallelism mapping row(s) in launch.mappings._TABLE:\n  "
            + "\n  ".join(problems))


_validate_table()


def model_for(arch: str, shape_name: str) -> ModelConfig:
    """Arch config, with the long_500k sub-quadratic variant applied."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        # The sliding-window variant makes decode O(window).
        cfg = dataclasses.replace(cfg, sliding_window=SWA_WINDOW)
    return cfg


def validate_pipeline(arch: str, pcfg: ParallelConfig) -> ParallelConfig:
    """Check the pp/vpp stage partition divides the arch's layer stack.

    ``n_layers`` must split into ``pp·vpp`` equal chunks of whole
    layer-cycle repeats (``layers % (pp·vpp) == 0`` for cycle length 1);
    the interleaved schedule also needs ``microbatch % pipeline_stages``.
    Both raise here, naming the arch.
    """
    if pcfg.pipeline_stages > 1 or pcfg.vpp > 1:
        from repro_torch.core.pipeline import stage_partition_for
        try:
            stage_partition_for(get_config(arch),
                                pcfg.pipeline_stages, pcfg.vpp)
        except ValueError as e:
            raise ValueError(f"invalid pipeline mapping for {arch!r}: {e}") \
                from None
        # microbatch=0 means no accumulation → the schedule runs m=1,
        # which the interleaved variant rejects; validate that here too.
        m = max(pcfg.microbatch, 1)
        if pcfg.vpp > 1 and m % pcfg.pipeline_stages:
            raise ValueError(
                f"invalid pipeline mapping for {arch!r}: interleaved "
                f"schedule needs microbatch % pp == 0 "
                f"(microbatch={m}, pp={pcfg.pipeline_stages})")
    return pcfg


def pcfg_for(arch: str, shape_name: str, *, multi_pod: bool = False,
             ep_override: Optional[Tuple[int, int, int]] = None,
             attn_override: Optional[Tuple[int, int, int]] = None,
             microbatch: Optional[int] = None,
             pp: int = 1, vpp: int = 1,
             tuned: bool = False, hardware=None) -> ParallelConfig:
    """Production ParallelConfig for one (arch, shape): the ``_TABLE`` row
    (or the overrides), adapted to two pods (``multi_pod``) and with ``pp``
    stages carved out of DP on both sides, then checked by
    :func:`validate_pipeline`. ``tuned=True`` takes the row from the
    cost-model search instead (``launch.autotune.tuned_mapping`` over the
    row's world at ``hardware``, default ``roofline.analysis.H100_SXM``).
    """
    key = (arch, shape_name)
    if key not in _TABLE:
        known = sorted(s for (a, s) in _TABLE if a == arch)
        if not known:
            raise ValueError(
                f"no mapping for unknown arch {arch!r}; archs with "
                f"mappings: {sorted({a for (a, _) in _TABLE})}")
        raise ValueError(
            f"no mapping for ({arch!r}, {shape_name!r}); known shapes for "
            f"{arch!r}: {known}")
    if tuned:
        from repro_torch.launch.autotune import tuned_mapping
        from repro_torch.roofline.analysis import H100_SXM
        attn, _, _ = _TABLE[key]
        row = tuned_mapping(arch, shape_name, attn[0] * attn[1] * attn[2], pp=pp, vpp=vpp,
                            hardware=hardware or H100_SXM)
    else:
        row = _TABLE[key]
    (adp, acp, atp), (edp, ep, etp), nmicro = row
    if attn_override:
        adp, acp, atp = attn_override
    if ep_override:
        edp, ep, etp = ep_override
    if microbatch is not None:
        nmicro = microbatch
    shape = get_shape(shape_name)
    pod_role = "dp"
    if multi_pod and shape.kind == "decode" and shape.global_batch < 2:
        pod_role = "cp"  # B=1: shard the KV cache across pods instead
    if multi_pod and pod_role == "dp" and shape.global_batch % (2 * adp):
        # Batch can't absorb the pod factor — move it into CP instead.
        if adp % 2 == 0 and shape.global_batch % adp == 0:
            adp //= 2
            acp *= 2
        else:
            pod_role = "cp"
    if pp > 1:
        # Pipeline stages subdivide the per-stage device block: keep the
        # world fixed by pulling the pp factor out of DP on both sides.
        if adp % pp or edp % pp:
            raise ValueError(
                f"({arch!r}, {shape_name!r}): cannot carve pp={pp} out of "
                f"dp={adp}/edp={edp}")
        adp //= pp
        edp //= pp
    return validate_pipeline(arch, ParallelConfig(
        attn=PM(dp=adp, inner=acp, tp=atp),
        moe=PM(dp=edp, inner=ep, tp=etp),
        pp=pp,
        vpp=vpp,
        pods=2 if multi_pod else 1,
        pod_role=pod_role,
        microbatch=nmicro,
        fsdp=True,
    ))


def unfolded_pcfg_for(arch: str, shape_name: str, **kw) -> ParallelConfig:
    """Baseline: MoE forced to the attention mapping (no folding) —
    EP limited to a sub-group of DP, as in pre-folding Megatron."""
    p = pcfg_for(arch, shape_name, **kw)
    cfg = get_config(arch)
    if cfg.moe is None:
        return p
    # EP must divide both DP and n_experts; ETP = attention TP.
    ep = 1
    for cand in (16, 8, 4, 2):
        if p.attn.dp % cand == 0 and cfg.moe.n_experts % cand == 0:
            ep = cand
            break
    return dataclasses.replace(
        p, moe=PM(dp=p.attn.dp // ep * p.attn.inner, inner=ep, tp=p.attn.tp))
