"""Attention core helpers: the partial merge, block choice and the naive
O(S²) oracle.

Port of the parts of ``repro.models.attn_core`` the serving slice uses. The
blockwise forward itself is the flash kernel (``repro_torch.kernels.flash``),
whose plain version mirrors ``_fwd_scan``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask_block(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                window: int) -> torch.Tensor:
    """(..., Sq) x (..., block) -> (..., Sq, block) boolean visibility."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window:
        m &= d < window
    return m


def _pick_block(skv: int, want: int) -> int:
    for b in range(min(want, skv), 0, -1):
        if skv % b == 0:
            return b
    return skv


def _merge_partials(m, l, acc, m_s, l_s, acc_s):
    """Online-softmax merge of two unnormalized ``(m, l, acc)`` partials."""
    m_new = torch.maximum(m, m_s)
    c0 = torch.exp(m - m_new)
    c1 = torch.exp(m_s - m_new)
    return m_new, l * c0 + l_s * c1, acc * c0[..., None] + acc_s * c1[..., None]


def naive_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    sm_scale=None) -> torch.Tensor:
    """O(S²)-memory oracle for tests. q: (B, H, Sq, hd); k/v: (B, Hkv, Skv,
    hd); positions (B, S*)."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qg = q.reshape(B, Hkv, rep, Sq, hd).float()
    s = torch.einsum("bgrsd,bgtd->bgrst", qg, k.float()) * scale
    vis = _mask_block(q_pos[:, None, None, :], kv_pos[:, None, None, :],
                      causal=causal, window=window)
    s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(vis, p, 0.0)
    out = torch.einsum("bgrst,bgtd->bgrsd", p, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
