"""MoE FFN block: router + dispatcher + experts over a (B, S, D) activation.

Port of ``repro.core.moe_layer`` at one rank. Expert weights keep the JAX
package's layout, ``w1``/``w3`` (E, D, F) and ``w2`` (E, F, D), which is
also the GMM kernel's ``(E, K, N)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dispatcher import moe_ffn
from repro_torch.models.common import dense_init


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class MoEParams(nn.Module):
    """Router ``(D, E)`` (fp32) and routed experts ``w1``/``w3`` ``(E, D, F)``,
    ``w2`` ``(E, F, D)``."""

    def __init__(self, router: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 w3: torch.Tensor):
        super().__init__()
        self.router = _param(router)
        self.w1 = _param(w1)
        self.w2 = _param(w2)
        self.w3 = _param(w3)


def init_moe(cfg: ModelConfig, *, generator: torch.Generator,
             dtype=torch.float32, device=None) -> MoEParams:
    assert cfg.moe is not None
    e = cfg.moe
    if e.shared_expert_width:
        raise NotImplementedError("shared experts are not ported yet "
                                  "(ROADMAP.md queue 1, 'MoE layer, rest')")
    D, E, F = cfg.d_model, e.n_experts, e.d_expert

    def experts(d_in, d_out, scale=None):
        w = dense_init(generator, d_in, E * d_out, scale=scale, dtype=dtype,
                       device=device)
        return w.reshape(d_in, E, d_out).permute(1, 0, 2).contiguous()

    router = dense_init(generator, D, E, scale=0.02, device=device)
    w1 = experts(D, F)
    w3 = experts(D, F)
    w2 = experts(F, D, scale=F ** -0.5)
    return MoEParams(router, w1, w2, w3)


def moe_block(p: MoEParams, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → same, plus the aux statistics of
    :func:`repro_torch.core.dispatcher.moe_ffn`."""
    assert cfg.moe is not None
    B, S, D = x.shape
    y, aux = moe_ffn(x.reshape(B * S, D), p.router, p.w1, p.w2, p.w3, cfg.moe,
                     activation=cfg.activation)
    return y.reshape(B, S, D), aux
