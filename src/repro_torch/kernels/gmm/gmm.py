"""Grouped matmul (GMM): the wrapper of the CUDA kernel ``csrc/gmm.cu``.

``gmm(x, w, block_expert)`` computes ``y[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm]
@ w[block_expert[i]]`` — the contract of the JAX package's Pallas kernel
``repro.kernels.gmm.gmm.gmm``. With ``trans_w=True`` it computes ``x @
w[e]^T`` instead, the data gradient of that product, from the same weights
(no transposed copy). ``bm`` is any multiple of 8 that divides M, as the
reference kernel takes it: row blocks that 64 divides run on the TMA +
wgmma kernel with the tokens on wgmma's 64-row side, others on its
swap-AB form, the weight's output columns on that side and a pass of up
to 128 token rows of one expert's run on the other (:func:`tile_shape`).
For a CUDA tensor it launches the kernel or raises; only a CPU tensor
takes the plain version (``ref.gmm_ref``). A fake tensor (a dry run,
``launch/dryrun.py``) takes neither: the call returns an empty output of
the right shape and reports its work (:func:`gmm_work`) to the active
``roofline.trace_cost.Recorder``, as every call does while one is.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.gmm.ref import gmm_ref
from repro_torch.roofline import trace_cost

BLOCK_K = 64                # the kernel's K step (128 B of bf16, the swizzle span)
BLOCKS_M = (128, 64)        # the TMA kernel's row tiles, for bm % 64 == 0
SMALL_BLOCKS_M = (8, 16, 32, 64, 128)   # the swap-AB kernel's rows a pass (its wgmma N)
BLOCKS_N = (256, 128)       # column tiles; N must be a multiple of 128
SMALL_BLOCK_N = 128         # the swap-AB kernel's columns a tile


@functools.lru_cache(maxsize=None)
def _n_sms(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _wave_fill(tiles: int, n_sms: int) -> float:
    """Share of the persistent grid's tile slots (waves x SMs) that hold a tile."""
    return tiles / (-(-tiles // n_sms) * n_sms)


def run_blocks(M: int, bm: int, experts: int) -> int:
    """Row blocks of one expert's run when the ``experts`` own equal spans:
    the swap-AB kernel's pass (:func:`tile_shape`) and its window of row
    blocks (``gmm.cu::launch_swap``) both follow from it."""
    return -(-(M // bm) // experts)


def tile_shape(M: int, N: int, bm: int, n_sms: int, experts: int) -> tuple:
    """The kernel's (BM, BN) for this launch. A row block that 64 does not
    divide takes the swap-AB kernel: (P, 128), P its rows a pass, the
    smallest of ``SMALL_BLOCKS_M`` that holds one expert's run of row blocks
    (:func:`run_blocks`), else 128 (a run then takes several passes). At
    decode, one block an expert, that is bm rounded up to a power of two.
    Otherwise the TMA kernel's: 128-row tiles when ``bm`` allows them, else
    64; 256 columns when ``N`` allows them, unless 128-column tiles fill the
    ``n_sms`` SMs' waves over a tenth better. A wide tile reads x half as
    often and reuses each operand twice as much, which outweighs a few
    points of fill; a last wave three quarters empty it does not (the decode
    step's down launch: 192 wide tiles on 132 SMs measured 3% slower than
    384 narrow ones, launch/bench_gmm.py)."""
    if bm % 64:
        rows = bm * run_blocks(M, bm, experts)
        return next((p for p in SMALL_BLOCKS_M if p >= rows), SMALL_BLOCKS_M[-1]), SMALL_BLOCK_N
    block_m = 128 if bm % 128 == 0 else 64
    rows = M // block_m
    if N % 256 or _wave_fill(rows * (N // 128), n_sms) > 1.1 * _wave_fill(rows * (N // 256), n_sms):
        return block_m, 128
    return block_m, 256


def gmm_work(M: int, K: int, N: int, experts_used: int, itemsize: int = 2) -> tuple:
    """``(flops, bytes)`` of one launch: 2·M·K·N products (``trans_w`` alike),
    and x and y once and each used expert's (K, N) weight once."""
    return 2.0 * M * K * N, float(itemsize * (M * K + M * N + experts_used * K * N))


def _report(rec, x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
            trans_w: bool) -> None:
    """The call's work to the recorder ``rec``: every expert of ``w`` taken
    as used on a fake ``block_expert`` (as the MoE layer's spans use them)."""
    M, K = x.shape
    N = w.shape[1 if trans_w else 2]
    used = w.shape[0] if trace_cost.is_fake(block_expert) else \
        rec.hidden(lambda: int(torch.unique(block_expert).numel()))
    rec.kernel("gmm_trans_w" if trans_w else "gmm",
               (tuple(x.shape), tuple(w.shape), tuple(block_expert.shape)),
               *gmm_work(M, K, N, used, x.element_size()))


def _validate(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
              bm: int, block_m: int, block_n: int, trans_w: bool) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"gmm kernel needs CUDA tensors, got {x.device}")
    if w.device != x.device or block_expert.device != x.device:
        raise ValueError(f"gmm: x on {x.device}, w on {w.device}, "
                         f"block_expert on {block_expert.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gmm kernel takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"block_expert must be int32, got {block_expert.dtype}")
    k_dim = 2 if trans_w else 1
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[k_dim]:
        raise ValueError(f"gmm: x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         f"(M, K) and {'(E, N, K)' if trans_w else '(E, K, N)'}")
    M, K = x.shape
    E, N = w.shape[0], w.shape[3 - k_dim]
    if (M == 0 or bm <= 0 or bm % min(SMALL_BLOCKS_M) or M % bm or K == 0 or K % BLOCK_K
            or N % min(BLOCKS_N)):
        raise ValueError(f"gmm kernel needs bm % {min(SMALL_BLOCKS_M)} == 0, M % bm == 0, "
                         f"K % {BLOCK_K} == 0, N % {min(BLOCKS_N)} == 0; got M={M}, "
                         f"K={K}, N={N}, bm={bm}")
    if (bm % 64 or block_m < 64) and block_m in SMALL_BLOCKS_M:
        ok = block_n == SMALL_BLOCK_N            # the swap-AB kernel: any run, any bm
    else:
        ok = (block_m in BLOCKS_M and bm % block_m == 0 and block_n in BLOCKS_N
              and N % block_n == 0)
    if not ok:
        raise ValueError(f"gmm: tile ({block_m}, {block_n}) does not tile bm={bm}, N={N}")
    if E * w.shape[1] >= 2 ** 31:
        raise ValueError(f"gmm: {E * w.shape[1]} rows of w exceed int32 coordinates")
    if tuple(block_expert.shape) != (M // bm,):
        raise ValueError(f"block_expert shape {tuple(block_expert.shape)} != "
                         f"({M // bm},)")
    for name, t in (("x", x), ("w", w), ("block_expert", block_expert)):
        if not t.is_contiguous():
            raise ValueError(f"gmm: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"gmm: {name} must be 16-byte aligned")


def gmm(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor, *,
        bm: int = 128, trans_w: bool = False, block_m: Optional[int] = None,
        block_n: Optional[int] = None) -> torch.Tensor:
    """x: (M, K) rows grouped by expert; w: (E, K, N), or (E, N, K) with
    ``trans_w``; block_expert: (M // bm,) int32 expert id per row block.
    Returns (M, N) in ``x.dtype`` with fp32 accumulation. ``block_m``/
    ``block_n`` force the kernel's tile (for measurement); by default
    ``tile_shape`` picks it."""
    rec = trace_cost.RECORDER
    if trace_cost.is_fake(x):
        if rec is not None:
            _report(rec, x, w, block_expert, trans_w)
        return x.new_empty((x.shape[0], w.shape[1 if trans_w else 2]))
    if x.device.type == "cpu":
        if rec is not None:
            _report(rec, x, w, block_expert, trans_w)
            return rec.hidden(gmm_ref, x, w, block_expert, bm=bm, trans_w=trans_w)
        return gmm_ref(x, w, block_expert, bm=bm, trans_w=trans_w)
    M, N = x.shape[0], w.shape[1 if trans_w else 2]
    if (block_m is None or block_n is None) and x.device.type == "cuda":
        auto_m, auto_n = tile_shape(M, N, bm, _n_sms(x.device.index), experts=w.shape[0])
        block_m, block_n = block_m or auto_m, block_n or auto_n
    _validate(x, w, block_expert, bm, block_m, block_n, trans_w)
    K, E = x.shape[1], w.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = load_library().repro_gmm_bf16(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(), y.data_ptr(),
            M, K, N, bm, E, block_m, block_n, run_blocks(M, bm, E), int(trans_w),
            torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "gmm")
    if rec is not None:
        _report(rec, x, w, block_expert, trans_w)
    gmm.launches += 1
    gmm.trans_w_launches += int(trans_w)
    return y


gmm.launches = 0            # kernel launches since the count was last set to 0
gmm.trans_w_launches = 0    # of which in the trans_w mode
