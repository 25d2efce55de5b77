"""GQA attention: the train/prefill forward, and serving's decode steps and
prefill chunks against a paged KV pool.

Port of the one-rank paths of ``repro.models.attention``: ``attention``
(training, no context parallelism) and ``attention_decode_paged`` →
``_cache_attend``. The page scatter and the page gather into a contiguous
``(B, Hkv, L, hd)`` view are plain torch indexing, as in JAX; the attention
itself is the flash kernel, one launch per call (with its backward in
``attn_core.blockwise_attention``).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash.ops import flash
from repro_torch.models.attn_core import blockwise_attention
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
    """(B, S, D) → q (B, S, H, hd), k/v (B, S_kv, Hkv, hd), RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x_kv @ p.wk.to(x.dtype)
    v = x_kv @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, x_kv.shape[1], cfg.n_kv_heads, hd)
    v = v.reshape(B, x_kv.shape[1], cfg.n_kv_heads, hd)
    if cfg.rope_kind == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    elif cfg.rope_kind != "none":
        raise NotImplementedError(f"rope_kind={cfg.rope_kind!r} is not ported yet "
                                  "(ROADMAP.md queue 1, 'Remaining block kinds')")
    return q, k, v


def attention(p: AttentionParams, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
              *, causal: bool = True, window: int = 0, block_kv: int = 1024) -> torch.Tensor:
    """Self-attention over a whole sequence: x (B, S, D) → (B, S, D).

    ``pos`` (B, S) are the tokens' RoPE positions and must be the default
    ``arange(S)`` on every row (``transformer.lm_positions``): the mask is
    the flash kernel's at offset 0 (``attn_core.blockwise_attention``).
    """
    q, k, v = _project_qkv(p, x, x, pos, pos, cfg)
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal,
                              window=window or cfg.sliding_window, block_kv=block_kv)
    return _attn_output(out, p, cfg)


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
