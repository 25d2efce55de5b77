"""Plain PyTorch version of the flash kernel (``kernels/csrc/flash.cu``).

A blockwise online-softmax loop that mirrors the JAX package's
``repro.models.attn_core._fwd_scan``: bf16 (or fp32) operands with fp32
products and sums, masks from absolute positions, ``p`` rounded to
``v.dtype`` before the PV product.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attn_core import NEG_INF, _pick_block


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: Optional[torch.Tensor], *, kv_offset: int = 0,
              q_pos: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None, causal: bool = True,
              window: int = 0, sm_scale: float | None = None,
              return_partial: bool = False, block_kv: int = 1024):
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Skv, hd); q_offset: (B,) int —
    query row i of batch row b sits at ``q_offset[b] + i``, or at
    ``q_pos[b, i]`` when the (B, Sq) query positions are given; key j at
    ``kv_offset + j``, or at ``kv_pos[b, j]`` when the (B, Skv) key
    positions are given.

    Returns the normalized output in ``q.dtype``, or with ``return_partial``
    the fp32 ``(acc, m, l)`` triple; a row that sees no key gives 0, or m =
    -1e30, l = 0, acc = 0.
    """
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    dev = q.device
    if q_pos is None:
        q_pos = q_offset.to(dev).long()[:, None] + torch.arange(Sq, dtype=torch.long, device=dev)
    q_pos = q_pos.to(dev).long()                                             # (B, Sq)
    if kv_pos is None:
        kv_pos = (kv_offset + torch.arange(Skv, dtype=torch.long, device=dev)).expand(B, Skv)
    kv_pos = kv_pos.to(dev).long()                                           # (B, Skv)
    block = _pick_block(Skv, block_kv)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    qf = q.float()
    for start in range(0, Skv, block):
        kb = k[:, :, start:start + block].float()
        vb = v[:, :, start:start + block]
        s = (qf @ kb.transpose(-1, -2)) * scale                             # (B, H, Sq, t)
        d = q_pos[:, None, :, None] - kv_pos[:, None, None, start:start + block]   # (B, 1, Sq, t)
        vis = torch.ones_like(d, dtype=torch.bool)
        if causal:
            vis &= d >= 0
        if window:
            vis &= d < window
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(vb.dtype).float() @ vb.float()
        m = m_new
    if return_partial:
        return acc, m, l
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
