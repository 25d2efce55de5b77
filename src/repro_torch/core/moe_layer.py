"""MoE FFN block: router + dispatcher + experts over a (B, S, D) activation.

Port of ``repro.core.moe_layer``. Expert weights keep the JAX package's
layout, ``w1``/``w3`` (E, D, F) and ``w2`` (E, F, D), which is also the GMM
kernel's ``(E, K, N)``; the shared experts' ``ws1``/``ws3`` (D, Fs) and
``ws2`` (Fs, D) are the reference's ``shared/{w1,w3,w2}``.

Across ranks each rank holds the shards the reference's ``constrain`` calls
give it (:func:`shard_moe_params`): experts on EP, ``F`` on ETP and ``D`` on
EDP (the dispatcher gathers ``D`` back); the shared experts on ETP/EDP; the
router and the shared gate replicated. The reference's MoE token shard is
a run of a pipeline stage's flattened (B·S) tokens over EDP×EP×ETP; the
attention side leaves each rank its sequence-parallel rows, (B, S /
(cp·tp)) of its DP rank's sequences. Where the MoE atoms are the attention
side's (DP, CP, TP) in order, the two coincide when a DP rank holds one
sequence or the sequence is not cut, and otherwise differ within a DP
rank; under ``pod_role="cp"`` or non-contiguous ``moe_factors`` a shard
holds other DP ranks' tokens. :func:`moe_block` moves the rows to the
shard before the router and back after the combine (``comm.sp_to_moe`` /
``comm.moe_to_sp``: an exchange over the DP rank's cp·tp ranks, or over
the stage).

Serving's decode rows are laid out otherwise: replicated over CP and TP,
cut over DP only when the batch divides (:func:`moe_block_decode`), so the
hand-off there follows the reference's token shards of the *global*
decode batch, which cross DP ranks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.dispatcher import moe_ffn, token_shard
from repro_torch.core.folding import FoldedGroups
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


def shard_moe_params(p: MoEParams, groups: FoldedGroups) -> MoEParams:
    """This rank's shards of the full parameters ``p``: ``w1``/``w3``
    ``[experts of my EP index, D of my EDP index, F of my ETP index]``,
    ``w2`` ``[experts, F, D]`` alike, ``ws1``/``ws3`` ``[D (EDP), Fs (ETP)]``,
    ``ws2`` ``[Fs (ETP), D (EDP)]``; the router and gate whole. Each shard
    is a contiguous copy (the full tensors can be freed)."""
    m = groups.moe

    def cut(t: Optional[torch.Tensor], *axes: Optional[str]) -> Optional[torch.Tensor]:
        if t is None:
            return None
        for dim, name in enumerate(axes):
            if name is not None and m[name].size > 1:
                n, i = m[name].size, m[name].index
                if t.shape[dim] % n:
                    raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                                     f"over {name.upper()} {n}")
                step = t.shape[dim] // n
                t = t.narrow(dim, i * step, step)
        return t.detach().clone().contiguous()

    return MoEParams(cut(p.router), cut(p.w1, "ep", "edp", "etp"),
                     cut(p.w2, "ep", "etp", "edp"), cut(p.w3, "ep", "edp", "etp"),
                     ws1=cut(p.ws1, "edp", "etp"), ws2=cut(p.ws2, "etp", "edp"),
                     ws3=cut(p.ws3, "edp", "etp"), gate=cut(p.gate))


def moe_block(p: MoEParams, x: torch.Tensor, cfg: ModelConfig, *,
              permute_mode: Optional[str] = None, capacity_hint: Optional[int] = None,
              ragged: Optional[bool] = None, overlap_chunks: Optional[int] = None,
              groups: Optional[FoldedGroups] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → same, plus the aux statistics of
    :func:`repro_torch.core.dispatcher.moe_ffn`. ``permute_mode``,
    ``capacity_hint``, ``ragged`` and ``overlap_chunks`` override the
    config's, as there. With ``groups``, ``x`` is this rank's
    sequence-parallel rows (its DP rank's B sequences, S cut over cp·tp)
    and ``p`` this rank's shards (:func:`shard_moe_params`): the rows go to
    the reference's MoE token shard (``comm.sp_to_moe``: an exchange over
    the attention ``cp_tp`` axis, or over the ``stage`` where the shard
    holds other DP ranks' tokens, or none where the layouts coincide),
    through ``moe_ffn``, and back (``comm.moe_to_sp``)."""
    assert cfg.moe is not None
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if groups is not None:
        xt = comm.sp_to_moe(xt, groups, B)
    y, aux = moe_ffn(xt, p.router, p.w1, p.w2, p.w3, cfg.moe,
                     activation=cfg.activation, permute_mode=permute_mode,
                     capacity_hint=capacity_hint, shared_weights=p.shared_weights(),
                     ragged=ragged, overlap_chunks=overlap_chunks, groups=groups)
    if groups is not None:
        y = comm.moe_to_sp(y, groups, B)
    return y.reshape(B, S, D), aux


def moe_block_decode(p: MoEParams, x: torch.Tensor, cfg: ModelConfig, *,
                     groups: Optional[FoldedGroups] = None, rows_cut: bool = False
                     ) -> torch.Tensor:
    """The MoE block on serving's decode rows ``x`` (b, C, D) → same.

    At one rank it is :func:`moe_block`. With ``groups`` the rows are
    replicated over the attention CP and TP ranks and, with ``rows_cut``,
    cut over DP (this rank's b = B / dp rows of the batch; else all B).
    The reference flattens the *global* (B·C) tokens, pads them to the
    token shard count EDP·EP·ETP and gives shard i to the rank at index i
    of the MoE ``tokens`` axis (``repro.core.dispatcher._token_shards``),
    so a shard may hold another DP rank's rows. No aux statistic is
    computed (``moe_ffn(stats=False)``). The hand-off: all-gather
    the rows over DP (when cut), take this rank's token shard with its
    padding mask (``dispatcher.token_shard``; capacity from the padded
    shard, as there), ``moe_ffn(..., token_mask=)``, then all-gather the
    outputs over the ``tokens`` axis and keep this rank's rows, each in
    the ``comm decode_handoff`` range."""
    assert cfg.moe is not None
    if groups is None:
        return moe_block(p, x, cfg)[0]
    b, C, D = x.shape
    xt = x.reshape(b * C, D)
    if rows_cut:
        xt = comm.gather_rows(xt, groups.attn["dp"], "decode_handoff")
    tok = groups.moe["tokens"]
    T = xt.shape[0]
    x_loc, mask = token_shard(xt, groups)
    y, _ = moe_ffn(x_loc, p.router, p.w1, p.w2, p.w3, cfg.moe, activation=cfg.activation,
                   shared_weights=p.shared_weights(), groups=groups, token_mask=mask,
                   stats=False)
    y = comm.gather_rows(y, tok, "decode_handoff")[:T]
    if rows_cut:
        lo = groups.attn["dp"].index * b * C
        y = y[lo:lo + b * C]
    return y.reshape(b, C, D)
