"""MoE FFN block: router + dispatcher + experts over a (B, S, D) activation.

Port of ``repro.core.moe_layer`` at one rank. Expert weights keep the JAX
package's layout, ``w1``/``w3`` (E, D, F) and ``w2`` (E, F, D), which is
also the GMM kernel's ``(E, K, N)``; the shared experts' ``ws1``/``ws3``
(D, Fs) and ``ws2`` (Fs, D) are the reference's ``shared/{w1,w3,w2}``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dispatcher import moe_ffn
from repro_torch.models.common import dense_init


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t)


class MoEParams(nn.Module):
    """Router ``(D, E)`` (fp32), routed experts ``w1``/``w3`` ``(E, D, F)``,
    ``w2`` ``(E, F, D)``, and, when the config has shared experts, ``ws1``/
    ``ws3`` ``(D, Fs)``, ``ws2`` ``(Fs, D)`` and the optional per-token
    sigmoid ``gate`` ``(D, 1)`` (fp32 at init)."""

    def __init__(self, router: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 w3: torch.Tensor, ws1: Optional[torch.Tensor] = None,
                 ws2: Optional[torch.Tensor] = None, ws3: Optional[torch.Tensor] = None,
                 gate: Optional[torch.Tensor] = None):
        super().__init__()
        if (ws1 is None) != (ws2 is None) or (ws1 is None) != (ws3 is None):
            raise ValueError("shared experts need all of ws1, ws2, ws3")
        if gate is not None and ws1 is None:
            raise ValueError("a shared-expert gate needs ws1, ws2, ws3")
        self.router = _param(router)
        self.w1 = _param(w1)
        self.w2 = _param(w2)
        self.w3 = _param(w3)
        self.ws1 = _param(ws1)
        self.ws2 = _param(ws2)
        self.ws3 = _param(ws3)
        self.gate = _param(gate)

    def shared_weights(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """``(ws1, ws2, ws3[, gate])`` for the dispatcher, or ``None``."""
        if self.ws1 is None:
            return None
        ws = (self.ws1, self.ws2, self.ws3)
        return ws if self.gate is None else ws + (self.gate,)


def init_moe(cfg: ModelConfig, *, generator: torch.Generator,
             dtype=torch.float32, device=None) -> MoEParams:
    assert cfg.moe is not None
    e = cfg.moe
    D, E, F = cfg.d_model, e.n_experts, e.d_expert

    def experts(d_in, d_out, scale=None):
        w = dense_init(generator, d_in, E * d_out, scale=scale, dtype=dtype,
                       device=device)
        return w.reshape(d_in, E, d_out).permute(1, 0, 2).contiguous()

    def dense(d_in, d_out, scale=None, dt=dtype):
        return dense_init(generator, d_in, d_out, scale=scale, dtype=dt, device=device)

    router = dense(D, E, scale=0.02, dt=torch.float32)
    w1 = experts(D, F)
    w3 = experts(D, F)
    w2 = experts(F, D, scale=F ** -0.5)
    shared = {}
    fs = e.shared_expert_width
    if fs:
        shared = dict(ws1=dense(D, fs), ws3=dense(D, fs), ws2=dense(fs, D, scale=fs ** -0.5))
        if e.shared_expert_gate:
            shared["gate"] = dense(D, 1, scale=0.02, dt=torch.float32)
    return MoEParams(router, w1, w2, w3, **shared)


def moe_block(p: MoEParams, x: torch.Tensor, cfg: ModelConfig, *,
              permute_mode: Optional[str] = None, capacity_hint: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → same, plus the aux statistics of
    :func:`repro_torch.core.dispatcher.moe_ffn`. ``permute_mode`` and
    ``capacity_hint`` override the config's layout and (sort + dropless)
    the bucketed capacity, as there."""
    assert cfg.moe is not None
    B, S, D = x.shape
    y, aux = moe_ffn(x.reshape(B * S, D), p.router, p.w1, p.w2, p.w3, cfg.moe,
                     activation=cfg.activation, permute_mode=permute_mode,
                     capacity_hint=capacity_hint, shared_weights=p.shared_weights())
    return y.reshape(B, S, D), aux
