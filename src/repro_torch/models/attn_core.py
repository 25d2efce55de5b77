"""Attention core: blockwise attention with a flash backward, the partial
merge, block choice and the naive O(S²) oracle.

Port of the parts of ``repro.models.attn_core`` the serving and training
slices use. The blockwise forward is the flash kernel
(``repro_torch.kernels.flash``), whose plain version mirrors ``_fwd_scan``;
the backward is ``_bwd_scan`` in torch ops, as the JAX package has no
backward kernel either.
"""
from __future__ import annotations

from typing import Optional

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


def _bwd_scan(q, k, v, lse, dout, delta, *, causal: bool, window: int, block_kv: int,
              scale: float):
    """Flash-style backward over flat heads (``H == Hkv``), given the LSE, at
    the default positions (query i and key j at positions i and j).

    Recomputes each KV block's probabilities from ``lse`` and accumulates
    ``(dq, dk, dv)`` in fp32, as ``repro.models.attn_core._bwd_scan``: the
    products of bf16 operands are taken in fp32, ``ds`` is rounded to
    ``k.dtype`` before the ``dq`` product. The query rows that see no key
    of a block are left out of its products (they would add exact zeros).
    """
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    dev = q.device
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, H, Skv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, H, Skv, hd), dtype=torch.float32, device=dev)
    qf, do = q.float(), dout.float()
    for s0 in range(0, Skv, block_kv):
        s1 = min(s0 + block_kv, Skv)
        r0 = min(s0, Sq) if causal else 0               # row i sees keys <= i
        r1 = min(Sq, s1 - 1 + window) if window else Sq  # and keys > i - window
        if r0 >= r1:
            continue
        qp = torch.arange(r0, r1, device=dev)[None]
        kp = torch.arange(s0, s1, device=dev)[None]
        kb, vb = k[:, :, s0:s1].float(), v[:, :, s0:s1].float()
        qs, dos = qf[:, :, r0:r1], do[:, :, r0:r1]
        s = (qs @ kb.transpose(-1, -2)) * scale                        # (B, H, r, t)
        vis = _mask_block(qp[:, None, :], kp[:, None, :], causal=causal, window=window)
        p = torch.where(vis, torch.exp(s - lse[:, :, r0:r1, None]), 0.0)
        del s
        dv[:, :, s0:s1] = p.transpose(-1, -2) @ dos
        dp = dos @ vb.transpose(-1, -2)
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        del p, dp
        dk[:, :, s0:s1] = ds.transpose(-1, -2) @ qs
        dq[:, :, r0:r1] += ds.to(k.dtype).float() @ kb
    return dq, dk, dv


def _is_default_positions(pos: Optional[torch.Tensor], S: int) -> bool:
    """``pos`` is ``None`` or ``arange(S)`` on every batch row."""
    if pos is None:
        return True
    return pos.shape[-1] == S and torch.equal(
        pos, torch.arange(S, dtype=pos.dtype, device=pos.device).expand_as(pos))


class FlashAttention(torch.autograd.Function):
    """Flat-head attention ``(q, k, v) -> out`` at the default positions:
    forward through the flash kernel's partial mode, backward through
    :func:`_bwd_scan` (``repro.models.attn_core._flash_flat``'s VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_kv, scale):
        from repro_torch.kernels.flash.flash import flash_attention
        B = q.shape[0]
        q_off = torch.zeros((B,), dtype=torch.int32, device=q.device)
        acc, m, l = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), q_off,
                                    causal=causal, window=window, sm_scale=scale,
                                    return_partial=True)
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                          torch.full_like(m, 1e30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, block_kv, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, block_kv, scale = ctx.cfg
        B, H, _, _ = q.shape
        Hkv = k.shape[1]
        rep = H // Hkv
        with torch.profiler.record_function("attention backward"):
            delta = torch.sum(dout.float() * out.float(), dim=-1)        # (B, H, Sq)
            kr = k.repeat_interleave(rep, dim=1) if rep > 1 else k
            vr = v.repeat_interleave(rep, dim=1) if rep > 1 else v
            dq, dk, dv = _bwd_scan(q, kr, vr, lse, dout, delta, causal=causal,
                                   window=window, block_kv=block_kv, scale=scale)
            if rep > 1:       # fold the repeated heads' grads back onto their KV head
                dk = dk.reshape(B, Hkv, rep, *dk.shape[2:]).sum(dim=2)
                dv = dv.reshape(B, Hkv, rep, *dv.shape[2:]).sum(dim=2)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: Optional[torch.Tensor] = None,
                        kv_pos: Optional[torch.Tensor] = None, *, causal: bool = True,
                        window: int = 0, block_kv: int = 1024,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Skv, hd); *_pos: (B, S*) or ``None``.

    Differentiable attention through the flash kernel (:class:`FlashAttention`).
    Only the default positions (``arange`` on every row, i.e. the kernel's
    offsets 0) are ported; others raise ``NotImplementedError``. The JAX
    function's ``return_partial`` is the kernel's own partial mode
    (``repro_torch.kernels.flash.ops.flash``).
    """
    Sq, hd = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    if not (_is_default_positions(q_pos, Sq) and _is_default_positions(kv_pos, Skv)):
        raise NotImplementedError(
            "blockwise_attention: only the default positions arange(S) are ported "
            "(ROADMAP.md queue 1, 'Attention, rest': explicit positions)")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                _pick_block(Skv, block_kv), float(scale))
