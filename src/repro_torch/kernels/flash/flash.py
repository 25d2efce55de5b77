"""Blockwise (flash) attention forward: the wrapper of ``csrc/flash.cu``.

The contract of the JAX package's Pallas kernel
``repro.kernels.flash.flash.flash_attention``, with one generalisation:
``q_offset`` is a ``(B,)`` int32 tensor, one base position per batch row
(a uniform vector is exactly the TPU kernel's scalar), so the batched
decode step can use it. For a CUDA tensor it launches the kernel or raises;
only a CPU tensor takes the plain version (``ref.flash_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.flash.ref import flash_ref

HEAD_DIMS = (64, 128)   # head sizes the kernel is instantiated for


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k", k), ("v", v), ("q_offset", q_offset)):
        if t.device != q.device:
            raise ValueError(f"flash: q on {q.device}, {name} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, {name} is {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash: {name} must be 4-D, got {tuple(t.shape)}")
    B, H, Sq, hd = q.shape
    Bk, Hkv, Skv, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd:
        raise ValueError(f"flash: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % Hkv:
        raise ValueError(f"flash: {H} query heads not a multiple of {Hkv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, got {hd}")
    if min(Sq, Skv) < 1:
        raise ValueError("flash: empty query or key sequence")
    if q_offset.dtype != torch.int32 or tuple(q_offset.shape) != (B,):
        raise ValueError(f"flash: q_offset must be ({B},) int32, got "
                         f"{tuple(q_offset.shape)} {q_offset.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_offset", q_offset)):
        if not t.is_contiguous():
            raise ValueError(f"flash: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash: {name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: torch.Tensor, *, kv_offset: int = 0,
                    causal: bool = True, window: int = 0,
                    sm_scale: float | None = None, return_partial: bool = False):
    """q: (B, H, Sq, hd); k/v: (B, Hkv, Skv, hd); q_offset: (B,) int32.

    Returns the normalized output in ``q.dtype`` (``l`` floored at 1e-30),
    or with ``return_partial`` the fp32 ``(acc, m, l)`` triple, acc
    (B, H, Sq, hd) and m, l (B, H, Sq).
    """
    if q.device.type == "cpu":
        return flash_ref(q, k, v, q_offset, kv_offset=kv_offset, causal=causal,
                         window=window, sm_scale=sm_scale,
                         return_partial=return_partial)
    _validate(q, k, v, q_offset)
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    if return_partial:
        acc = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=q.device)
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out_ptr, ptrs, result = None, (acc.data_ptr(), m.data_ptr(), l.data_ptr()), (acc, m, l)
    else:
        out = torch.empty_like(q)
        out_ptr, ptrs, result = out.data_ptr(), (None, None, None), out
    with torch.cuda.device(q.device):
        rc = load_library().repro_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offset.data_ptr(), out_ptr,
            *ptrs, B, H, Hkv, Sq, Skv, hd, int(kv_offset), int(bool(causal)),
            int(window), float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "flash_attention")
    flash_attention.launches += 1
    return result


flash_attention.launches = 0   # kernel launches since the count was last set to 0
