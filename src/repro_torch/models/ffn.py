"""Dense feed-forward layers (SwiGLU / GeGLU / GeLU), at one rank or across
the TP ranks of a fold.

Port of ``repro.models.ffn``, whose products are einsums outside any Pallas
kernel; here they are plain ``torch.matmul``. At a fold the layer is
Megatron's column/row-parallel pair, with the collectives of the attention
(``models.attention``):

* :func:`ffn` (training, whole sequences): the rank's sequence-parallel rows
  are all-gathered over TP, ``w_gate`` / ``w_up`` are column-parallel (the
  rank's ``F / tp`` columns), ``w_down`` row-parallel, and its partial sums
  are reduce-scattered over TP back to the sequence-parallel rows (the
  reference's constraints, ``repro.models.ffn.ffn``).
* :func:`ffn_decode` (serving): the rows are replicated over CP and TP, and
  ``w_down``'s partial sums are all-reduced over TP in fp32, rounded once,
  as ``attention._attn_output`` sums its output projection.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups
from repro_torch.models.common import activation, dense_init


class FFNParams(nn.Module):
    """``w_gate`` (D, F), ``w_down`` (F, D) and, for the gated activations
    (SwiGLU, GeGLU), ``w_up`` (D, F): the JAX package's ``init_ffn`` leaves."""

    def __init__(self, w_gate: torch.Tensor, w_down: torch.Tensor,
                 w_up: Optional[torch.Tensor] = None):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate)
        self.w_down = nn.Parameter(w_down)
        self.register_parameter("w_up", nn.Parameter(w_up) if w_up is not None else None)


def init_ffn(cfg: ModelConfig, *, generator: torch.Generator, d_ff: int = 0,
             dtype=torch.float32, device=None) -> FFNParams:
    """Random ``FFNParams`` from ``generator`` (other numbers than JAX's;
    weights shared with the JAX package go through ``repro_torch.convert``)."""
    d_ff = d_ff or cfg.d_ff

    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype=dtype, device=device)

    w_gate, w_down = w(cfg.d_model, d_ff), w(d_ff, cfg.d_model)
    w_up = w(cfg.d_model, d_ff) if cfg.activation in ("swiglu", "geglu") else None
    return FFNParams(w_gate, w_down, w_up)


def _hidden(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = x @ p.w_gate.to(x.dtype)
    up = x @ p.w_up.to(x.dtype) if p.w_up is not None else None
    return activation(cfg.activation, gate, up)


def ffn(p, x: torch.Tensor, cfg: ModelConfig,
        groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """x (B, S, D) → (B, S, D). With ``groups``, ``x`` is the rank's
    sequence-parallel rows (B, S / (cp·tp), D), ``p`` its compute slice
    (the FSDP gather is the caller's, as for the attention) and the result
    is in the same layout."""
    if groups is None:
        h = _hidden(p, x, cfg)
        return h @ p.w_down.to(h.dtype)
    tp = groups.attn["tp"]
    h = _hidden(p, comm.sp_gather(x, tp), cfg)           # (B, S/cp, F/tp)
    return comm.sp_scatter(h @ p.w_down.to(h.dtype), tp)


def ffn_decode(p, x: torch.Tensor, cfg: ModelConfig,
               groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Decode rows x (b, C, D) → (b, C, D). At a fold the rows are
    replicated over CP and TP, ``p`` holds the rank's ``F / tp`` columns
    and rows, and ``w_down``'s partial sums stay fp32 through the sum over
    TP (see ``attention._attn_output``)."""
    h = _hidden(p, x, cfg)
    if groups is None or groups.tp == 1:
        return h @ p.w_down.to(h.dtype)
    y = h.float() @ p.w_down.float()
    return comm.all_reduce(y, groups.attn["tp"], name="tp_reduce").to(x.dtype)
