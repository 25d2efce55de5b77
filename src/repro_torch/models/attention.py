"""GQA attention: the train/prefill forward, one rank or across TP and CP
ranks, and serving's decode steps and prefill chunks against a paged KV pool.

Port of ``repro.models.attention``: ``attention`` (training; with
``groups``, tensor parallelism over heads with Megatron sequence
parallelism between layers, and context parallelism by all-gathered K/V or
the load-balanced ring, ``ParallelConfig.cp_mode``) and
``attention_decode_paged`` → ``_cache_attend``. The page scatter and the
page gather into a contiguous ``(B, Hkv, L, hd)`` view are plain torch
indexing, as in JAX; the attention itself is the flash kernel (with its
backward in ``attn_core``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups, zigzag_runs
from repro_torch.kernels.flash.ops import flash
from repro_torch.models.attn_core import blockwise_attention, ring_attention
from repro_torch.models.common import apply_rope, dense_init


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


def _project_qkv(p: AttentionParams, x: torch.Tensor, x_kv: torch.Tensor,
                 pos: torch.Tensor, kv_pos: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, D) → q (B, S, H, hd), k/v (B, S_kv, Hkv, hd), RoPE applied;
    H and Hkv are the heads of the weights given (a TP rank's slice)."""
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
    if cfg.rope_kind == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    elif cfg.rope_kind != "none":
        raise NotImplementedError(f"rope_kind={cfg.rope_kind!r} is not ported yet "
                                  "(ROADMAP.md queue 1, 'Remaining block kinds')")
    return q, k, v


def attention(p: AttentionParams, x: torch.Tensor, pos: Optional[torch.Tensor],
              cfg: ModelConfig, *, causal: bool = True, window: int = 0,
              block_kv: int = 1024, groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Self-attention over whole sequences: x (B, S, D) → (B, S, D).

    ``pos`` (B, S) are the tokens' RoPE positions and must be the default
    ``arange(S)`` on every row (``transformer.lm_positions``): the mask is
    the flash kernel's at offset 0 (``attn_core.blockwise_attention``).

    With ``groups``, ``x`` is this rank's sequence-parallel rows (B, S /
    (cp·tp), D), ``p`` its TP slice (``models.sharding``), ``pos`` must be
    ``None`` (the positions are the default ones, placed by the layout) and
    the result is in the same layout: see :func:`_folded_attention`.
    """
    window = window or cfg.sliding_window
    if groups is not None:
        if pos is not None:
            raise ValueError("attention(groups=...): positions come from the layout; "
                             "pass pos=None")
        return _folded_attention(p, x, cfg, groups, causal=causal, window=window,
                                 block_kv=block_kv)
    q, k, v = _project_qkv(p, x, x, pos, pos, cfg)
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, block_kv=block_kv)
    return _attn_output(out, p, cfg)


def _folded_attention(p: AttentionParams, x: torch.Tensor, cfg: ModelConfig,
                      groups: FoldedGroups, *, causal: bool, window: int,
                      block_kv: int) -> torch.Tensor:
    """Attention across the TP and CP ranks of ``groups`` (the reference's
    all-gather path and ``_ring_self_attention``).

    1. SP all-gather over TP: the rank's CP chunk of the sequence, in
       natural order (chunk ``cp_index`` of cp).
    2. ``"ring"`` (cp > 1): the chunk goes to the zigzag layout over CP
       (chunks i and 2·cp − 1 − i of 2·cp).
    3. Column-parallel ``wq/wk/wv`` (+ biases) over this rank's heads, RoPE
       at the tokens' positions.
    4. ``"allgather"``: K/V all-gathered over CP, one flash launch with the
       queries at the chunk's offset. ``"ring"``: :func:`ring_attention`,
       then the output back to natural order — the zigzag order lives only
       inside attention, so the MoE router sees the same tokens per shard.
    5. Row-parallel ``wo``; its partial sums reduce-scattered over TP back
       to the SP layout.
    """
    tp_ax, cp_ax = groups.attn["tp"], groups.attn["cp"]
    tp, cp = tp_ax.size, cp_ax.size
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise NotImplementedError(
            f"attention TP {tp} over {cfg.n_heads} query / {cfg.n_kv_heads} KV heads: "
            "heads that do not split over TP (replicated KV) are not ported")
    tp_ax.require_rank_order("the attention TP collectives")
    cp_ax.require_rank_order("the attention CP collectives")
    B, S_sp, _ = x.shape
    S_cp = S_sp * tp
    S = S_cp * cp
    dev = x.device
    ring = cp > 1 and groups.pcfg.cp_mode == "ring"
    xg = comm.sp_gather(x, tp_ax.group)                   # (B, S/cp, D)
    if ring:
        runs = zigzag_runs(S, cp)
        xg = comm.to_zigzag(xg, cp_ax, dim=1)
        half = torch.arange(S_cp // 2, dtype=torch.int32, device=dev)
        pos = torch.cat([half + o for o in runs[cp_ax.index]])
    else:
        pos = cp_ax.index * S_cp + torch.arange(S_cp, dtype=torch.int32, device=dev)
    pos = pos.expand(B, S_cp)
    q, k, v = _project_qkv(p, xg, xg, pos, pos, cfg)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)   # (B, heads, S/cp, hd)
    if ring:
        out = ring_attention(q, k, v, runs, ring=cp_ax, index=cp_ax.index, causal=causal,
                             window=window, block_kv=block_kv)
        out = comm.from_zigzag(out.transpose(1, 2).reshape(B, S_cp, -1), cp_ax, dim=1)
    else:
        k = comm.all_gather(k, cp_ax.group, 2)            # (B, Hkv/tp, S, hd)
        v = comm.all_gather(v, cp_ax.group, 2)
        out = blockwise_attention(q, k, v, causal=causal, window=window, block_kv=block_kv,
                                  q_offset=cp_ax.index * S_cp, kv_offset=0)
        out = out.transpose(1, 2).reshape(B, S_cp, -1)
    return comm.sp_scatter(out @ p.wo.to(out.dtype), tp_ax.group)


def _positions_for(step: Union[int, torch.Tensor], B: int, C: int,
                   device=None) -> torch.Tensor:
    """(B, C) absolute positions from a scalar or (B,) base ``step``."""
    base = torch.as_tensor(step, dtype=torch.long, device=device)
    if base.dim() == 0:
        base = base.expand(B)
    return base[:, None] + torch.arange(C, dtype=torch.long, device=base.device)[None, :]


def _cache_attend(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, *, window: int) -> torch.Tensor:
    """C query tokens against a realized (B, Hkv, L, hd) cache at one rank.

    ``q``: (B, H, C, hd); ``pos``: (B, C) contiguous query positions. A
    full-attention cache holds position s at slot s, so keys start at
    position 0 and the causal mask hides the slots not yet written.
    """
    return flash(q, cache_k, cache_v, q_offset=pos[:, 0], kv_offset=0,
                 causal=True, window=window)


def _attn_output(out: torch.Tensor, p: AttentionParams, cfg: ModelConfig) -> torch.Tensor:
    """(B, H, C, hd) attention output → (B, C, D) through the out-proj."""
    B, _, C, _ = out.shape
    out = out.transpose(1, 2).reshape(B, C, cfg.q_dim)
    return out @ p.wo.to(out.dtype)


def attention_decode_paged(p: AttentionParams, x: torch.Tensor,
                           pool_k: torch.Tensor, pool_v: torch.Tensor,
                           block_tables: torch.Tensor,
                           step: Union[int, torch.Tensor], cfg: ModelConfig, *,
                           window: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step / prefill chunk against a paged (block) KV pool.

    ``x``: (B, C, D); ``pool_k/v``: (P, Hkv, page, hd) pages shared by all
    requests; ``block_tables``: (B, n_pg) physical page per logical page
    (page 0 is the scratch page); ``step``: scalar or (B,) base positions.
    The new K/V are written into the pools in place (the JAX version
    returns updated copies); the pools are returned for the same call shape.
    """
    window = window or cfg.sliding_window
    if window:
        raise NotImplementedError(
            "sliding-window ring caches are not ported yet: their wrapped slot "
            "positions are not contiguous (ROADMAP.md queue 1, 'Serving, rest')")
    B, C, _ = x.shape
    page = pool_k.shape[2]
    L = block_tables.shape[1] * page
    pos = _positions_for(step, B, C, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, pos, pos, cfg)
    q = q.transpose(1, 2).contiguous()                   # (B, H, C, hd)

    # Scatter the new tokens into their pages: logical slot → (page, offset).
    lslot = torch.clamp(pos, max=L - 1)
    phys = torch.gather(block_tables.long(), 1, lslot // page)   # (B, C)
    off = lslot % page
    pool_k[phys, :, off, :] = k_new.to(pool_k.dtype)     # value (B, C, Hkv, hd)
    pool_v[phys, :, off, :] = v_new.to(pool_v.dtype)

    def view(pool):
        g = pool[block_tables.long()]                    # (B, n_pg, Hkv, page, hd)
        return g.permute(0, 2, 1, 3, 4).reshape(B, pool.shape[1], L, pool.shape[-1])

    out = _cache_attend(q, view(pool_k), view(pool_v), pos, window=window)
    return _attn_output(out, p, cfg), pool_k, pool_v
