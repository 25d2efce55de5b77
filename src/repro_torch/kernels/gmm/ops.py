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


class GroupedMatmul(torch.autograd.Function):
    """``y = gmm(x, w, block_expert)`` with its gradients, for experts that
    own equal contiguous spans of rows (``block_expert`` from
    :func:`uniform_block_expert`).

    * dgrad ``dx = dy @ w[e]^T``: the GMM kernel in its ``trans_w`` mode.
    * wgrad ``dw[e] = x_e^T @ dy_e``: one ``torch.bmm`` over the
      ``(E, span, .)`` views, as the JAX package leaves the einsum
      gradients of its expert FFN to XLA (``repro.core.dispatcher``).

    On CPU tensors ``gmm`` is its plain version, so is the backward.
    """

    @staticmethod
    def forward(ctx, x, w, block_expert, bm):
        ctx.save_for_backward(x, w, block_expert)
        ctx.bm = bm
        return gmm(x, w, block_expert, bm=bm)

    @staticmethod
    def backward(ctx, dy):
        x, w, block_expert = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, block_expert, bm=ctx.bm, trans_w=True)
        if ctx.needs_input_grad[1]:
            E = w.shape[0]
            with torch.profiler.record_function("gmm wgrad"):
                dw = torch.bmm(x.view(E, -1, x.shape[1]).transpose(1, 2),
                               dy.view(E, -1, dy.shape[1]))
        return dx, dw, None, None


def expert_ffn_einsum(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      w3: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's einsum expert FFN as three ``torch.bmm``: xe (E, N, D);
    w1/w3 (E, D, F); w2 (E, F, D) → (E, N, D). A plain product, which the
    JAX package also computes outside any kernel. Weights of another dtype
    than ``xe`` compute in ``xe``'s, as JAX promotes bf16 weights against
    fp32 activations."""
    w1, w2, w3 = (w.to(xe.dtype) for w in (w1, w2, w3))
    h = act_fn(activation, torch.bmm(xe, w1), torch.bmm(xe, w3))
    return torch.bmm(h, w2)


def expert_ffn_gmm(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   w3: torch.Tensor, activation: str, *,
                   bm: Optional[int] = None) -> torch.Tensor:
    """Expert FFN through three GMM launches (gate, up, down), differentiable.

    xe: (E, N, D) tokens grouped by expert, each expert owning its N rows;
    w1/w3: (E, D, F); w2: (E, F, D). Shapes the kernel does not tile
    (``N % bm``, ``D % 128`` or ``F % 128`` non-zero, or ``bm < 8``) take
    :func:`expert_ffn_einsum`, as the reference's ``expert_ffn_gmm`` does
    (``repro.kernels.gmm.ops``): under ETP the local ``F`` is a slice, and
    Qwen2's 2560 leaves 320 columns a rank at ETP 8.
    The backward launches the kernel three more times (``trans_w``) and
    runs three ``torch.bmm`` weight gradients; the activation's gradient is
    autograd's of the plain ``activation``.
    """
    E, N, D = xe.shape
    F = w1.shape[-1]
    bm = bm if bm is not None else pick_bm(N)
    if bm < 8 or N % bm or D % 128 or F % 128:
        return expert_ffn_einsum(xe, w1, w2, w3, activation)
    w1, w2, w3 = (w.to(xe.dtype) for w in (w1, w2, w3))
    x2 = xe.reshape(E * N, D)
    be = uniform_block_expert(E, N, bm, device=xe.device)
    gate = GroupedMatmul.apply(x2, w1, be, bm)
    up = GroupedMatmul.apply(x2, w3, be, bm)
    h = act_fn(activation, gate.reshape(E, N, F), up.reshape(E, N, F))
    y = GroupedMatmul.apply(h.reshape(E * N, F), w2, be, bm)
    return y.reshape(E, N, D)
