"""GMM-backed MoE expert FFN (the dispatcher's expert backend)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gmm.gmm import gmm
from repro_torch.models.common import activation as act_fn


def pick_bm(n_tok: int) -> int:
    """Largest tile-friendly row-block dividing ``n_tok`` (1 = not tileable)."""
    for bm in (128, 64, 32, 16, 8):
        if n_tok % bm == 0:
            return bm
    return 1


def uniform_block_expert(e_local: int, span: int, bm: int, device=None) -> torch.Tensor:
    """``block_expert`` for ``e_local`` experts that each own ``span``
    contiguous rows (``span % bm == 0``): expert id per ``bm``-row block."""
    if span % bm:
        raise ValueError(f"span {span} not a multiple of block {bm}")
    return torch.arange(e_local, dtype=torch.int32,
                        device=device).repeat_interleave(span // bm)


def expert_ffn_gmm(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   w3: torch.Tensor, activation: str, *, bm: Optional[int] = None,
                   block_expert: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert FFN through three GMM launches (gate, up, down).

    xe: (E, N, D) tokens grouped by expert; w1/w3: (E, D, F); w2: (E, F, D).
    Each expert owns N contiguous rows unless ``block_expert`` (expert id
    per ``bm``-row block) says otherwise. Shapes must tile: ``N % bm == 0``,
    ``D % 128 == 0`` and ``F % 128 == 0``; other shapes raise ``ValueError``.
    """
    E, N, D = xe.shape
    F = w1.shape[-1]
    bm = bm if bm is not None else pick_bm(N)
    if bm < 8 or N % bm or D % 128 or F % 128:
        raise ValueError(f"expert_ffn_gmm: shapes do not tile (N={N}, D={D}, "
                         f"F={F}, bm={bm})")
    x2 = xe.reshape(E * N, D)
    be = block_expert
    if be is None:
        be = uniform_block_expert(E, N, bm, device=xe.device)
    gate = gmm(x2, w1, be, bm=bm)
    up = gmm(x2, w3, be, bm=bm)
    h = act_fn(activation, gate.reshape(E, N, F), up.reshape(E, N, F))
    y = gmm(h.reshape(E * N, F), w2, be, bm=bm)
    return y.reshape(E, N, D)
