"""Plain PyTorch version of the GMM kernel (``kernels/csrc/gmm.cu``)."""
from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor, *,
            bm: int = 128, trans_w: bool = False) -> torch.Tensor:
    """``y[i] = x[i] @ w[expert_of_block(i // bm)]`` in fp32, cast to
    ``x.dtype``; with ``trans_w``, ``x[i] @ w[e]^T`` for ``w`` (E, N, K).

    The same function as ``repro.kernels.gmm.ref.gmm_ref``; instead of
    gathering an (M, K, N) weight per row it multiplies each expert's rows
    by that expert's matrix, so it also runs at the full model width.
    """
    M = x.shape[0]
    N = w.shape[1 if trans_w else 2]
    row_expert = torch.repeat_interleave(block_expert.long(), bm)[:M]   # (M,)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    for e in torch.unique(row_expert).tolist():
        rows = row_expert == e
        we = w[e].float()
        y[rows] = (x[rows].float() @ (we.T if trans_w else we)).to(x.dtype)
    return y
