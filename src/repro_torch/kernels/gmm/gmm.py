"""Grouped matmul (GMM): the wrapper of the CUDA kernel ``csrc/gmm.cu``.

``gmm(x, w, block_expert)`` computes ``y[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm]
@ w[block_expert[i]]`` — the contract of the JAX package's Pallas kernel
``repro.kernels.gmm.gmm.gmm``. For a CUDA tensor it launches the kernel or
raises; only a CPU tensor takes the plain version (``ref.gmm_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.gmm.ref import gmm_ref

BLOCK_M = 128      # the kernel's row tile: bm must be a multiple of it
BLOCK_K = 32
BLOCK_N = 128


def _validate(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
              bm: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"gmm kernel needs CUDA tensors, got {x.device}")
    if w.device != x.device or block_expert.device != x.device:
        raise ValueError(f"gmm: x on {x.device}, w on {w.device}, "
                         f"block_expert on {block_expert.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gmm kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"block_expert must be int32, got {block_expert.dtype}")
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"gmm: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (M, K) and (E, K, N)")
    M, K = x.shape
    N = w.shape[2]
    if bm % BLOCK_M or M % bm or K % BLOCK_K or N % BLOCK_N:
        raise ValueError(f"gmm kernel needs bm % {BLOCK_M} == 0, M % bm == 0, "
                         f"K % {BLOCK_K} == 0, N % {BLOCK_N} == 0; got M={M}, "
                         f"K={K}, N={N}, bm={bm}")
    if tuple(block_expert.shape) != (M // bm,):
        raise ValueError(f"block_expert shape {tuple(block_expert.shape)} != "
                         f"({M // bm},)")
    for name, t in (("x", x), ("w", w), ("block_expert", block_expert)):
        if not t.is_contiguous():
            raise ValueError(f"gmm: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"gmm: {name} must be 16-byte aligned")


def gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor, *,
        bm: int = 128) -> torch.Tensor:
    """x: (M, K) rows grouped by expert; w: (E, K, N); block_expert:
    (M // bm,) int32 expert id per row block. Returns (M, N) in ``x.dtype``
    with fp32 accumulation."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, block_expert, bm=bm)
    _validate(x, w, block_expert, bm)
    M, K = x.shape
    E, _, N = w.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = load_library().repro_gmm_bf16(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(), y.data_ptr(),
            M, K, N, bm, E, torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "gmm")
    gmm.launches += 1
    return y


gmm.launches = 0   # kernel launches since the count was last set to 0
