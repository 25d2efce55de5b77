"""Shared building blocks: RMSNorm and LayerNorm, RoPE and M-RoPE,
activations, initializers, and the cross-entropy loss.

Port of ``repro.models.common`` (the parts the serving and training slices
run).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               scale: Optional[float] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal(0, scale²) ``(d_in, d_out)`` matrix, default scale 1/√d_in.

    Drawn in fp32 from ``generator`` (on the generator's device) and cast
    to ``dtype``; torch's normal stream differs from ``jax.random``'s, so
    weights shared with the JAX package go through ``repro_torch.convert``.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the scale stored as ``scale - 1`` (applied as ``1 + w``),
    computed in fp32 and cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the scale ``w`` stored as it is and a bias ``b``,
    computed in fp32 and cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm_apply(kind: str, x: torch.Tensor, p) -> torch.Tensor:
    """The config's norm (``ModelConfig.norm``): ``p`` is the RMSNorm weight,
    or for ``"layernorm"`` a module (or namespace) with ``w`` and ``b``."""
    if kind == "layernorm":
        return layernorm(x, p.w, p.b)
    return rmsnorm(x, p)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotates the split halves ``[x1, x2]`` of the head dim (not interleaved
    pairs), in fp32.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """The (temporal, height, width) frequency sections of M-RoPE for heads
    of ``head_dim`` (``repro.models.attention._apply_positional``)."""
    base = head_dim // 2
    return (base - 2 * (base * 3 // 8), base * 3 // 8, base * 3 // 8)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (..., S, H, hd); ``positions_3d``
    (..., S, 3) the (temporal, height, width) position ids. The hd/2
    frequency channels are cut into three sections, each rotated by its own
    position stream, in fp32 [arXiv:2409.12191]."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover {hd // 2} channels")
    freqs = rope_freqs(hd, theta, device=x.device)              # (hd/2,)
    sec_id = torch.repeat_interleave(torch.arange(3, dtype=torch.long, device=x.device),
                                     torch.tensor(sections, dtype=torch.long, device=x.device),
                                     output_size=hd // 2)
    pos = positions_3d.float()[..., sec_id]                     # (..., S, hd/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(kind: str, gate: torch.Tensor,
               up: Optional[torch.Tensor] = None) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(kind)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy over the ``mask``ed tokens → ``(loss, n_tok)``.

    ``logits`` (..., V) in any dtype, computed in fp32; the denominator is
    the mask's sum floored at 1. Port of ``repro.models.common``'s.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = torch.sum(nll * mask)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return total / denom, denom


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None, *, vocab_start: int,
                                 vocab_group=None, token_group=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`softmax_cross_entropy` of logits cut on the vocabulary.

    ``logits`` (..., V / tp): this rank's vocabulary slice, which starts at
    id ``vocab_start``; ``labels``/``mask``: this rank's tokens, which the
    ranks of ``vocab_group`` (TP) share. The max, the sum of exponentials
    and the target logit are reduced over ``vocab_group``; the numerator
    and the token count over ``token_group`` (dp + cp), so the TP ranks of
    one token count it once. Every rank returns the global ``(loss,
    n_tok)`` and back-propagates its own share (``comm.psum``).
    """
    from repro_torch.core import comm
    logits = logits.float()
    m = comm.all_reduce(logits.detach().amax(dim=-1), vocab_group, op=dist.ReduceOp.MAX)
    sumexp = comm.psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1), vocab_group)
    lse = m + torch.log(sumexp)
    local = labels.long() - vocab_start
    mine = (local >= 0) & (local < logits.shape[-1])
    ll = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    ll = comm.psum(torch.where(mine, ll, 0.0), vocab_group)
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = comm.psum(torch.sum(nll * mask), token_group)
    denom = torch.clamp(comm.all_reduce(torch.sum(mask), token_group), min=1.0)
    return total / denom, denom
