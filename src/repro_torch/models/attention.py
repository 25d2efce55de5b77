"""GQA attention: the train/prefill forward, one rank or across TP and CP
ranks, and serving's decode steps and prefill chunks against a paged or
dense KV cache, one rank or across the TP and CP ranks of a fold.

Port of ``repro.models.attention``: ``attention`` (training; with
``groups``, tensor parallelism over heads with Megatron sequence
parallelism between layers, and context parallelism by all-gathered K/V or
the load-balanced ring, ``ParallelConfig.cp_mode``) and
``attention_decode_paged`` / ``attention_decode`` → ``_cache_attend`` (at
a fold: the rank's TP heads, its CP slice of the cache, LSE-merged partials
or the ring-CP prefill). Where TP does not divide the K/V heads, every TP
rank keeps q and K/V at all heads (:func:`kv_replicated`), as the
reference does. A sliding-window config keeps a ring of ``L``
slots (position p in slot ``p % L``) whose positions wrap inside the view,
so its attention gives the flash kernel each slot's position
(:func:`_cache_kv_positions`). The page scatter and the
page gather into a contiguous ``(B, Hkv, L, hd)`` view are plain torch
indexing, as in JAX; the attention itself is the flash kernel (with its
backward in ``attn_core``).
"""
from __future__ import annotations

import types
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups, zigzag_runs
from repro_torch.kernels.flash.ops import flash
from repro_torch.models.attn_core import _merge_partials, blockwise_attention, ring_attention
from repro_torch.models.common import apply_mrope, apply_rope, dense_init, mrope_sections
from repro_torch.roofline import trace_cost


class AttentionParams(nn.Module):
    """``wq`` (D, H·hd), ``wk``/``wv`` (D, Hkv·hd), ``wo`` (H·hd, D), and the
    qkv biases when the config has them — the JAX package's layout."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("bq", bq), ("bk", bk), ("bv", bv)):
            if t is not None:
                setattr(self, name, nn.Parameter(t))


def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> AttentionParams:
    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype=dtype, device=device)

    wq, wk, wv = w(cfg.d_model, cfg.q_dim), w(cfg.d_model, cfg.kv_dim), w(cfg.d_model, cfg.kv_dim)
    wo = w(cfg.q_dim, cfg.d_model)
    biases = {}
    if cfg.qkv_bias:
        biases = {name: torch.zeros(n, dtype=dtype, device=device)
                  for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim))}
    return AttentionParams(wq, wk, wv, wo, **biases)


def _apply_positional(x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RoPE or M-RoPE of x (B, S, H, hd) at ``pos``: (B, S) ids, or for
    M-RoPE (B, S, 3) streams (plain ids are the same stream three times, as
    decode gives them); x as it is for ``rope_kind="none"``."""
    if cfg.rope_kind == "rope":
        return apply_rope(x, pos, cfg.rope_theta)
    if cfg.rope_kind == "mrope":
        if pos.dim() == x.dim() - 2:
            pos = pos[..., None].expand(*pos.shape, 3)
        return apply_mrope(x, pos, cfg.rope_theta, sections=mrope_sections(x.shape[-1]))
    if cfg.rope_kind != "none":
        raise ValueError(f"unknown rope_kind {cfg.rope_kind!r}")
    return x


def mask_positions(pos: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The positions the mask reads: M-RoPE's temporal stream ``pos[..., 0]``
    of (B, S, 3) streams (``repro.models.attention``: "the temporal stream
    for M-RoPE, the ids otherwise"), the (B, S) ids as they are."""
    if pos is None or pos.dim() == 2:
        return pos
    return pos[..., 0]


class RunPositions(NamedTuple):
    """Positions whose mask stream is a run on every row, as the host found
    them (``data.pipeline.mark_runs``): the layers rotate at ``pos`` and
    mask as the default layout does, at scalar offsets."""
    pos: torch.Tensor


class PaddedKeys(NamedTuple):
    """The positions of a sequence padded at its end to split over the
    ranks (the encoder's frames at a fold, :func:`_folded_attention`): the
    default layout's, with the rows at and after ``n`` pads that no query
    sees as keys. The attention is not causal over the real rows; the pads
    are masked by the causal mask at a stream of 0 for each real row and 1
    for each pad, which the K/V carry on the all-gather path and around the
    ring alike: a real query (0) sees the real keys only, a pad query sees
    every key (its row is dropped)."""
    n: int


def split_positions(pos: Union[None, torch.Tensor, RunPositions]
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(rotary positions, mask positions) of the layers' ``pos``: ``None``
    for both by default, a tensor's own mask stream, none for
    :class:`RunPositions`."""
    if isinstance(pos, RunPositions):
        return pos.pos, None
    return pos, mask_positions(pos)


def kv_replicated(cfg: ModelConfig, groups: Optional[FoldedGroups]) -> bool:
    """Whether attention TP does not divide the K/V heads at this fold. The
    reference then keeps q and K/V whole on every TP rank (``tp_q = None``
    whenever ``tp_kv`` is ``None``: ``repro.models.attention._decode_axes``
    and ``_ring_self_attention``), so every TP rank computes the attention
    of its CP chunk at all heads."""
    return groups is not None and groups.tp > 1 and cfg.n_kv_heads % groups.tp != 0


def kv_heads_per_rank(cfg: ModelConfig, groups: Optional[FoldedGroups]) -> int:
    """The K/V heads a rank's caches hold: its TP slice, or all of them where
    they are replicated over TP (:func:`kv_replicated`)."""
    if groups is None or kv_replicated(cfg, groups):
        return cfg.n_kv_heads
    return cfg.n_kv_heads // groups.tp


# Each attention leaf's TP-cut dim and its whole size.
_TP_DIMS = {"wq": (1, "q_dim"), "wk": (1, "kv_dim"), "wv": (1, "kv_dim"),
            "wo": (0, "q_dim"), "bq": (0, "q_dim"), "bk": (0, "kv_dim"), "bv": (0, "kv_dim")}


def whole_heads(name: str, t: torch.Tensor, cfg: ModelConfig,
                groups: Optional[FoldedGroups]) -> torch.Tensor:
    """The attention leaf ``name`` (``wq`` ... ``bv``, or a path ending in
    one) at all heads: its compute slice ``t`` all-gathered over TP where
    the slice is column-cut (``core.comm.all_gather``, whose backward
    reduce-scatters the gradient: each TP rank's share of it, summed once),
    ``t`` itself where it is whole."""
    dim, size = _TP_DIMS[name.rsplit(".", 1)[-1]]
    if groups is None or t.shape[dim] == getattr(cfg, size):
        return t
    return comm.all_gather(t, groups.attn["tp"], dim)


def _all_heads(p, cfg: ModelConfig, groups: FoldedGroups):
    """``p``'s leaves at all heads (:func:`whole_heads`)."""
    return types.SimpleNamespace(**{n: whole_heads(n, getattr(p, n), cfg, groups)
                                    for n in _TP_DIMS if getattr(p, n, None) is not None})


def _project_qkv(p: AttentionParams, x: torch.Tensor, x_kv: torch.Tensor,
                 pos: torch.Tensor, kv_pos: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, D) → q (B, S, H, hd), k/v (B, S_kv, Hkv, hd), RoPE or M-RoPE
    applied (:func:`_apply_positional`); H and Hkv are the heads of the
    weights given (a TP rank's slice)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x_kv @ p.wk.to(x.dtype)
    v = x_kv @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, x_kv.shape[1], -1, hd)
    v = v.reshape(B, x_kv.shape[1], -1, hd)
    return _apply_positional(q, pos, cfg), _apply_positional(k, kv_pos, cfg), v


def attention(p: AttentionParams, x: torch.Tensor,
              pos: Union[None, torch.Tensor, RunPositions],
              cfg: ModelConfig, *, causal: bool = True, window: int = 0,
              block_kv: int = 1024, groups: Optional[FoldedGroups] = None,
              cross_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self- or cross-attention over whole sequences: x (B, S, D) → (B, S, D).

    ``pos`` are the tokens' positions: ``None`` for the default ``arange(S)``
    on every row (the flash kernel at offset 0, no position tensor), or any
    (B, S) ids, or for M-RoPE (B, S, 3) streams, as the reference's
    ``attention`` takes them: RoPE at them, and the mask by them
    (:func:`mask_positions`: M-RoPE's temporal stream), so packed rows whose
    positions restart, per-row offsets and an image's patches that share one
    temporal id attend as the reference's do; :class:`RunPositions` rotate
    and mask at the layout's offsets. ``causal=False`` is the
    encoder's. ``cross_x`` (B, T, D): the keys and values come from it (the
    encoder's output, whole), not causal, with no ring, as the reference
    runs cross-attention; the keys sit at positions ``arange(T)``.

    With ``groups``, ``x`` is this rank's sequence-parallel rows (B, S /
    (cp·tp), D), ``p`` its TP slice (``models.sharding``), ``pos`` ``None``
    (the positions are the default ones, placed by the layout) or the
    rank's CP chunk of the positions (B, S / cp) or (B, S / cp, 3), and the
    result is in the same layout: see :func:`_folded_attention`.
    """
    window = window or cfg.sliding_window
    if cross_x is not None:
        causal = False
    if groups is not None:
        return _folded_attention(p, x, cfg, groups, causal=causal, window=window,
                                 block_kv=block_kv, pos=pos, cross_x=cross_x)
    x_kv = x if cross_x is None else cross_x
    pos, mask = split_positions(pos)
    if cross_x is not None:
        mask = None
    if pos is None:
        pos = torch.arange(x.shape[1], dtype=torch.long,
                           device=x.device).expand(x.shape[0], -1)
    kv_pos = pos
    if cross_x is not None:
        kv_pos = torch.arange(x_kv.shape[1], dtype=torch.long,
                              device=x.device).expand(x.shape[0], -1)
    q, k, v = _project_qkv(p, x, x_kv, pos, kv_pos, cfg)
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              mask, mask, causal=causal, window=window, block_kv=block_kv)
    return _attn_output(out, p, cfg)


def _folded_attention(p: AttentionParams, x: torch.Tensor, cfg: ModelConfig,
                      groups: FoldedGroups, *, causal: bool, window: int,
                      block_kv: int, pos: Union[None, torch.Tensor, RunPositions] = None,
                      cross_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention across the TP and CP ranks of ``groups`` (the reference's
    all-gather path and ``_ring_self_attention``).

    1. SP all-gather over TP: the rank's CP chunk of the sequence, in
       natural order (chunk ``cp_index`` of cp).
    2. ``"ring"`` (cp > 1, self-attention): the chunk goes to the zigzag
       layout over CP (chunks i and 2·cp − 1 − i of 2·cp), and the given
       positions ``pos`` (the chunk's) with it.
    3. Column-parallel ``wq/wk/wv`` (+ biases) over this rank's heads, RoPE
       at the tokens' positions (``pos``, or the layout's).
    4. ``"allgather"``: K/V all-gathered over CP, one flash launch with the
       queries at the chunk's offset, or with given positions (not
       :class:`RunPositions`) the mask's (:func:`mask_positions`) gathered
       over CP with the K/V.
       ``"ring"``: :func:`ring_attention` (given positions travel the ring
       with the K/V), then the output back to natural order — the zigzag order lives only
       inside attention, so the MoE router sees the same tokens per shard.
       Cross-attention (``cross_x``, the encoder's whole output): K/V
       projected from it at the rank's heads, one flash launch, not causal
       (the reference runs it without the ring whatever ``cp_mode`` says).
    5. Row-parallel ``wo``; its partial sums reduce-scattered over TP back
       to the SP layout.

    Where TP does not divide the K/V heads (:func:`kv_replicated`), step 3
    projects all heads from the leaves gathered whole over TP
    (:func:`whole_heads`), step 4 runs at all heads on every TP rank, and
    step 5 applies the whole ``wo`` and keeps the rank's SP rows: every TP
    rank computes the same attention, each rank's loss reads only its own
    rows, and the gathers' backward (reduce-scatters) sums the ranks'
    shares of each gradient once.
    """
    tp_ax, cp_ax = groups.attn["tp"], groups.attn["cp"]
    tp, cp = tp_ax.size, cp_ax.size
    replicated = kv_replicated(cfg, groups)
    if replicated:
        p = _all_heads(p, cfg, groups)
    B, S_sp, _ = x.shape
    S_cp = S_sp * tp
    S = S_cp * cp
    dev = x.device
    ring = cp > 1 and groups.pcfg.cp_mode == "ring" and cross_x is None
    pad = pos.n if isinstance(pos, PaddedKeys) else None
    if pad is not None and (causal or window or cross_x is not None):
        raise ValueError("PaddedKeys: a non-causal self-attention without a window")
    pos, mask = split_positions(None if pad is not None else pos)
    given, masked = pos is not None, mask is not None and cross_x is None
    xg = comm.sp_gather(x, tp_ax)                         # (B, S/cp, D)
    if ring:
        runs = zigzag_runs(S, cp)
        xg = comm.to_zigzag(xg, cp_ax, dim=1)
        if given:
            pos = comm.to_zigzag(pos, cp_ax, dim=1)
        else:
            half = torch.arange(S_cp // 2, dtype=torch.int32, device=dev)
            pos = torch.cat([half + o for o in runs[cp_ax.index]])
    elif not given:
        pos = cp_ax.index * S_cp + torch.arange(S_cp, dtype=torch.int32, device=dev)
    if not given:
        pos = pos.expand(B, S_cp)
    mask = mask_positions(pos) if masked else None
    if pad is not None:
        mask, causal = (pos >= pad).to(torch.int32), True
    if cross_x is not None:
        T = cross_x.shape[1]
        q, k, v = _project_qkv(p, xg, cross_x, pos,
                               torch.arange(T, dtype=torch.long, device=dev).expand(B, T), cfg)
    else:
        q, k, v = _project_qkv(p, xg, xg, pos, pos, cfg)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)   # (B, heads, S/cp, hd)
    if ring:
        out = ring_attention(q, k, v, runs, ring=cp_ax, index=cp_ax.index, causal=causal,
                             window=window, block_kv=block_kv, pos=mask)
        out = comm.from_zigzag(out.transpose(1, 2).reshape(B, S_cp, -1), cp_ax, dim=1)
    elif cross_x is not None:
        out = blockwise_attention(q, k, v, causal=False, window=window, block_kv=block_kv)
        out = out.transpose(1, 2).reshape(B, S_cp, -1)
    else:
        k = comm.all_gather(k, cp_ax, 2)                  # (B, Hkv/tp, S, hd)
        v = comm.all_gather(v, cp_ax, 2)
        if mask is None:
            out = blockwise_attention(q, k, v, causal=causal, window=window,
                                      block_kv=block_kv, q_offset=cp_ax.index * S_cp,
                                      kv_offset=0)
        else:
            out = blockwise_attention(q, k, v, mask, comm.all_gather(mask, cp_ax, 1),
                                      causal=causal, window=window, block_kv=block_kv)
        out = out.transpose(1, 2).reshape(B, S_cp, -1)
    if replicated:
        return (out @ p.wo.to(out.dtype))[:, tp_ax.index * S_sp:(tp_ax.index + 1) * S_sp]
    return comm.sp_scatter(out @ p.wo.to(out.dtype), tp_ax)


def cp_kv_stats(cfg: ModelConfig, seq_len: int, batch_per_rank: int, cp: int,
                *, dtype_bytes: int = 2) -> Dict[str, float]:
    """Per-rank K/V residency and ring payload of one attention layer's
    forward (``repro.models.attention.cp_kv_stats``; the context-scaling
    figure reads it).

    * ``kv_bytes_allgather`` — K+V resident per rank after the CP all-gather
      (the full sequence, independent of ``cp``).
    * ``kv_bytes_ring`` — K+V resident per rank under ring CP (one S/cp
      shard; the visiting shard is the same size again at peak).
    * ``ring_payload_bytes`` — bytes each rank sends over the ``cp − 1``
      forward rotations (K + V + the keys' positions).
    """
    hd = cfg.resolved_head_dim
    kv_row = 2 * cfg.n_kv_heads * hd * dtype_bytes          # K+V per token
    full = float(batch_per_rank * seq_len * kv_row)
    shard = full / cp
    pos_bytes = batch_per_rank * (seq_len / cp) * 4
    return {
        "kv_bytes_allgather": full,
        "kv_bytes_ring": shard,
        "ring_payload_bytes": (cp - 1) * (shard + pos_bytes),
    }


def _positions_for(step: Union[int, torch.Tensor], B: int, C: int,
                   device=None) -> torch.Tensor:
    """(B, C) absolute positions from a scalar or (B,) base ``step``."""
    base = torch.as_tensor(step, dtype=torch.long, device=device)
    if base.dim() == 0:
        base = base.expand(B)
    return base[:, None] + torch.arange(C, dtype=torch.long, device=base.device)[None, :]


def _cache_kv_positions(pos: torch.Tensor, L: int) -> torch.Tensor:
    """Absolute position of every slot of a sliding-window ring of ``L``
    slots, per batch row → (B, L) (the reference's ``_cache_kv_positions``
    with a window). ``pos`` (B, C): the rows' query positions, whose tokens
    are already written. A slot holds the most recent position congruent to
    it mod ``L`` up to the row's newest one, ``pos[:, -1]``; a slot not yet
    written gets ``newest + 1``, which the causal mask hides."""
    slots = torch.arange(L, dtype=torch.long, device=pos.device)
    last = pos[:, -1:]                                   # (B, 1): each row wraps at its own
    cand = last - (last - slots[None, :]) % L
    return torch.where(cand >= 0, cand, last + 1)


def ring_kv_positions(step: torch.Tensor, B: int, C: int, L: int,
                      groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """The positions of this rank's CP slice of a ring of ``L`` slots,
    (B, L / cp) int32 (:func:`_cache_kv_positions`; the slice by slot, as
    the caches are cut), for the C queries of each row from base ``step`` (B,).
    They are the same in every layer of a forward: a stack computes them
    once and hands them to each layer's :func:`attention_decode` or
    :func:`attention_decode_paged` as ``kv_pos``."""
    cp = 1 if groups is None else groups.cp
    lo = (0 if groups is None else groups.attn["cp"].index) * (L // cp)
    pos = _positions_for(step, B, C, device=step.device)
    return _cache_kv_positions(pos, L)[:, lo:lo + L // cp].to(torch.int32).contiguous()


def _require_ring_positions(window: int, kv_pos: Optional[torch.Tensor]) -> None:
    if window and kv_pos is None:
        raise ValueError("a sliding-window ring needs its slots' positions (kv_pos, "
                         "ring_kv_positions)")


def _cache_attend(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, *, window: int, groups: Optional[FoldedGroups] = None,
                  kv_offset: int = 0, kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C query tokens against a realized (B, Hkv, L, hd) cache view.

    ``q``: (B, H, C, hd); ``pos``: (B, C) contiguous query positions. A
    full-attention cache holds position s at slot s, so the keys of the
    view start at position ``kv_offset`` and the causal mask hides the
    slots not yet written; a ring cache passes ``kv_pos`` (B, L_view), the
    position of each slot of the view (:func:`ring_kv_positions`), and
    ``kv_offset`` is unused. At one rank (or CP 1) the view is the whole
    cache: one flash launch, normalized output.

    With ``groups`` at CP > 1 the view is this rank's ``L / cp`` slice of
    the cache, at ``kv_offset = cp_index · L / cp`` (or with that slice of
    the slots' positions: the slice is cut by slot, so on a ring it may
    straddle the wrap), as the reference cuts it
    (``repro.models.attention._cache_attend``):

    * C == 1 (decode) or C % cp != 0: every CP rank runs flash in partial
      mode for all C queries against its slice, and the partials are
      LSE-merged over CP (``comm.cp_merge``).
    * C > 1 with C % cp == 0 (ring-CP prefill): the queries are cut into
      cp contiguous chunks, rank i starting with chunk i. Each hop runs one
      flash partial of the chunk held against the resident slice, and the
      chunk (with its running ``(m, l, acc)``) moves one rank on around the
      CP ring (``comm.ring_shift_``), merged online as it arrives (with its
      queries' positions; the slice's ``kv_pos`` stays resident); a last
      rotation brings each chunk's accumulators back to its owner, and the
      normalized chunks are all-gathered over CP along C.
    """
    keys = dict(kv_offset=kv_offset, kv_pos=kv_pos, causal=True, window=window)
    cp_ax = None if groups is None else groups.attn["cp"]
    if cp_ax is None or cp_ax.size == 1:
        return flash(q, cache_k, cache_v, q_offset=pos[:, 0], **keys)
    cp, C = cp_ax.size, q.shape[2]
    if C == 1 or C % cp:
        acc, m, l = flash(q, cache_k, cache_v, q_offset=pos[:, 0], return_partial=True, **keys)
        acc, l = comm.cp_merge(acc, m, l, cp_ax)
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    n, i = C // cp, cp_ax.index

    def partial(qc, chunk):
        return flash(qc, cache_k, cache_v, q_offset=pos[:, chunk * n], return_partial=True,
                     **keys)

    def shift(*parts):
        """One ring hop of the chunk's tensors, packed into one fp32 buffer
        (a bf16 chunk of queries is exact in fp32)."""
        buf = comm.ring_shift_(torch.cat([t.float() for t in parts], dim=-1), cp_ax)
        return buf.split([t.shape[-1] for t in parts], dim=-1)

    qc = q[:, :, i * n:(i + 1) * n].contiguous()
    acc, m, l = partial(qc, i)
    for hop in range(1, cp):
        qc, acc, m, l = shift(qc, acc, m[..., None], l[..., None])
        qc, m, l = qc.to(q.dtype).contiguous(), m[..., 0], l[..., 0]
        acc_s, m_s, l_s = partial(qc, (i - hop) % cp)
        m, l, acc = _merge_partials(m, l, acc, m_s, l_s, acc_s)
    acc, m, l = shift(acc, m[..., None], l[..., None])
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return comm.gather_rows(out.contiguous(), cp_ax, "cp_gather", dim=2)


def _attn_output(out: torch.Tensor, p: AttentionParams, cfg: ModelConfig,
                 groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """(B, H, C, hd) attention output → (B, C, D) through the out-proj; at a
    fold ``out`` holds the rank's TP heads and ``wo`` their rows, and the
    partial sums are all-reduced over TP (row parallel); with K/V
    replicated over TP, ``out`` and ``wo`` hold all heads and the product
    is whole on every rank."""
    B, _, C, _ = out.shape
    out = out.transpose(1, 2).reshape(B, C, -1)
    if groups is None or groups.tp == 1 or kv_replicated(cfg, groups):
        return out @ p.wo.to(out.dtype)
    # The partial sums stay fp32 through the sum over TP and are rounded
    # once, as one rank's product rounds its fp32 accumulation once: a bf16
    # round of each partial would part the residual stream from one rank's
    # by an ulp here and there, enough to flip near-tie expert choices.
    y = out.float() @ p.wo.float()
    return comm.all_reduce(y, groups.attn["tp"], name="tp_reduce").to(out.dtype)


def attention_decode_paged(p: AttentionParams, x: torch.Tensor,
                           pool_k: torch.Tensor, pool_v: torch.Tensor,
                           block_tables: torch.Tensor,
                           step: Union[int, torch.Tensor], cfg: ModelConfig, *,
                           window: int = 0, groups: Optional[FoldedGroups] = None,
                           kv_pos: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step / prefill chunk against a paged (block) KV pool.

    ``x``: (B, C, D); ``pool_k/v``: (P, Hkv, page, hd) pages shared by all
    requests; ``block_tables``: (B, n_pg) physical page per logical page
    (page 0 is the scratch page); ``step``: scalar or (B,) base positions.
    The view's ``L = n_pg · page`` logical slots hold position p at slot
    ``min(p, L − 1)``, or with a window at ``p % L`` (a ring; ``kv_pos``:
    its :func:`ring_kv_positions`, which the caller makes once a forward). The new K/V
    are written into the pools in place (the JAX version returns updated
    copies); the pools are returned for the same call shape.

    With ``groups``: ``x`` is the rank's decode rows (replicated over CP
    and TP), ``p`` its compute slice (its TP heads) and the pools hold its
    TP heads of every page (whole over DP and CP, as the reference shards
    them): each rank writes its rows' new tokens, reads its CP slice of
    their view (:func:`_cache_attend`) and the output projection is
    all-reduced over TP.
    """
    window = window or cfg.sliding_window
    if kv_replicated(cfg, groups):
        p = _all_heads(p, cfg, groups)
    B, C, _ = x.shape
    page = pool_k.shape[2]
    n_pg = block_tables.shape[1]
    L = n_pg * page
    pos = _positions_for(step, B, C, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, pos, pos, cfg)
    q = q.transpose(1, 2).contiguous()                   # (B, H, C, hd)

    # Scatter the new tokens into their pages: logical slot → (page, offset).
    bt = block_tables.long()
    lslot = pos % L if window else torch.clamp(pos, max=L - 1)
    phys = torch.gather(bt, 1, lslot // page)            # (B, C)
    off = lslot % page
    pool_k[phys, :, off, :] = k_new.to(pool_k.dtype)     # value (B, C, Hkv, hd)
    pool_v[phys, :, off, :] = v_new.to(pool_v.dtype)

    cp = 1 if groups is None else groups.cp
    if L % cp:
        raise ValueError(f"a cache view of {L} slots does not split over CP {cp}")
    lo = (0 if groups is None else groups.attn["cp"].index) * (L // cp)
    whole_pages = n_pg % cp == 0
    if cp > 1 and whole_pages:                           # only this slice's pages
        bt = bt[:, lo // page:(lo + L // cp) // page]

    def view(pool):
        g = pool[bt]                                     # (B, n_pg, Hkv, page, hd)
        g = g.permute(0, 2, 1, 3, 4).reshape(B, pool.shape[1], -1, pool.shape[-1])
        return g if whole_pages else g[:, :, lo:lo + L // cp].contiguous()

    _require_ring_positions(window, kv_pos)
    out = _cache_attend(q, view(pool_k), view(pool_v), pos, window=window, groups=groups,
                        kv_offset=lo, kv_pos=kv_pos)
    return _attn_output(out, p, cfg, groups), pool_k, pool_v


def attention_decode(p: AttentionParams, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, step: Union[int, torch.Tensor],
                     cfg: ModelConfig, *, window: int = 0,
                     groups: Optional[FoldedGroups] = None,
                     kv_pos: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step / prefill chunk against a contiguous per-slot cache.

    ``x``: (B, C, D) — C = 1 for decode, C > 1 for a chunked-prefill
    segment; ``cache_k/v``: (B, Hkv, S_max, hd); ``step``: scalar or (B,)
    base positions — token c of row b sits at position ``step[b] + c``, in
    slot ``min(step[b] + c, S_max - 1)``, or with a window in slot
    ``(step[b] + c) % S_max`` (a ring of ``S_max`` slots; ``kv_pos``: its
    :func:`ring_kv_positions`, which the caller makes once a forward). The new K/V are
    written in place; returns ``(y, cache_k, cache_v)``.

    With ``groups`` the cache is this rank's piece of the reference's
    ``(dp, tp, cp)`` layout (``transformer.init_decode_state``): its rows,
    its TP heads and its ``S_max / cp`` slots from ``cp_index · S_max / cp``.
    A new token's K/V land only on the CP rank that owns its slot; the
    attention is :func:`_cache_attend` over the rank's slots.
    """
    window = window or cfg.sliding_window
    if kv_replicated(cfg, groups):
        p = _all_heads(p, cfg, groups)
    B, C, _ = x.shape
    S_loc = cache_k.shape[2]
    cp_ax = None if groups is None else groups.attn["cp"]
    cp, idx = (1, 0) if cp_ax is None else (cp_ax.size, cp_ax.index)
    lo = idx * S_loc
    pos = _positions_for(step, B, C, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, pos, pos, cfg)
    q = q.transpose(1, 2).contiguous()                   # (B, H, C, hd)

    slots = pos % (S_loc * cp) if window else torch.clamp(pos, max=S_loc * cp - 1)   # (B, C)
    rows = torch.arange(B, dtype=torch.long, device=x.device)[:, None].expand(B, C)
    if cp > 1 and trace_cost.is_fake(slots):
        # A dry run cannot read which tokens land in its slots: it writes
        # them all (B·C rows, the most a rank writes).
        trace_cost.RECORDER.assume("every new token's K/V written on each CP rank")
        rows, slots = rows.reshape(-1), torch.clamp(slots - lo, 0, S_loc - 1).reshape(-1)
        k_new, v_new = (t.reshape(B * C, *t.shape[2:]) for t in (k_new, v_new))
    elif cp > 1:                                         # the tokens of my slots
        mine = (slots >= lo) & (slots < lo + S_loc)
        rows, slots, k_new, v_new = rows[mine], slots[mine] - lo, k_new[mine], v_new[mine]
    cache_k[rows, :, slots, :] = k_new.to(cache_k.dtype)
    cache_v[rows, :, slots, :] = v_new.to(cache_v.dtype)

    _require_ring_positions(window, kv_pos)
    out = _cache_attend(q, cache_k, cache_v, pos, window=window, groups=groups, kv_offset=lo,
                        kv_pos=kv_pos)
    return _attn_output(out, p, cfg, groups), cache_k, cache_v


def attention_decode_cross(p: AttentionParams, x: torch.Tensor, cache_xk: torch.Tensor,
                           cache_xv: torch.Tensor, cfg: ModelConfig, *,
                           groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Cross-attention of decode rows x (B, C, D) against the cross K/V
    cache (B, Hkv, T, hd): every key visible, no positional rotation of the
    queries (the reference's ``_decode_dense_x``). With ``groups``, ``p`` and
    the cache hold the rank's TP heads and the output projection is summed
    over TP, or all heads where K/V is replicated over TP."""
    if kv_replicated(cfg, groups):
        p = _all_heads(p, cfg, groups)
    B, C, _ = x.shape
    q = x @ p.wq.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
    q = q.reshape(B, C, -1, cfg.resolved_head_dim).transpose(1, 2).contiguous()
    out = flash(q, cache_xk, cache_xv, causal=False)
    return _attn_output(out, p, cfg, groups)
