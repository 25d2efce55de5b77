"""The MoE dispatcher at one rank: route → permute → expert FFN →
un-permute → top-k combine.

Port of ``repro.core.dispatcher.moe_ffn`` for one device, in the sorted
(MegaBlocks-style) layout over the padded buffer (docs/dispatcher.md):

1. :func:`repro_torch.core.router.route` picks each token's top-k experts
   and the capacity drops (sub-sequence dropping over the tokens given).
2. A stable argsort by expert id groups the kept assignments; each expert
   owns a span of ``cap_pad = round_up(capacity, gmm_block_m)`` rows of the
   ``(E * cap_pad, D)`` buffer, which is *gathered* (row ``e*cap_pad + p``
   holds the p-th kept assignment of expert e in token order).
3. Every ``bm``-row block belongs to one expert, so the expert FFN is three
   launches of the GMM kernel (:func:`repro_torch.kernels.gmm.ops.expert_ffn_gmm`).
4. Each assignment reads its row back; the top-k combine sums in fp32.

At one rank the EP All-to-All-V and the ETP AllGather-V/ReduceScatter-V
are identities, and the overlap ladder (``MoEConfig.overlap_chunks``) is
numerically identical to one chunk, so it runs as one chunk.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.router import resolved_capacity, route, sorted_dispatch
from repro_torch.kernels.gmm.ops import expert_ffn_gmm


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def moe_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            w3: torch.Tensor, mcfg: MoEConfig, *, activation: str = "swiglu"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the MoE FFN to a flat batch of tokens ``x`` (T, D) at one rank.

    ``wg`` (D, E); ``w1``/``w3`` (E, D, F); ``w2`` (E, F, D). The expert
    FFN always runs through the GMM kernel, which raises ``ValueError`` on
    shapes it does not tile (``D`` or ``F`` not a multiple of 128, or
    ``mcfg.gmm_block_m`` < 8).
    Returns ``(y, stats)`` with ``moe_aux_loss``, ``moe_z_loss`` and
    ``moe_drop_fraction``.
    """
    mode = mcfg.permute_mode
    if mode == "scatter":
        raise NotImplementedError(
            "permute_mode='scatter' is not ported yet (ROADMAP.md queue 1, "
            "'MoE layer, rest'); use permute_mode='sort'")
    if mode != "sort":
        raise ValueError(f"unknown permute_mode {mode!r}")
    if mcfg.ragged_a2a:
        raise NotImplementedError(
            "the ragged EP exchange needs more than one rank; it is not "
            "ported yet (ROADMAP.md queue 1, 'Distributed dispatcher')")
    if mcfg.shared_expert_width:
        raise NotImplementedError(
            "shared experts are not ported yet (ROADMAP.md queue 1, "
            "'MoE layer, rest')")

    T, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    cap = resolved_capacity(T, mcfg)
    # Span alignment: each expert's span is a whole number of GMM row blocks.
    bm = mcfg.gmm_block_m
    cap_pad = _round_up(cap, bm)

    # ------------------------------------------------ 1. route + permute
    r = route(x, wg, mcfg, capacity=cap)
    sd = sorted_dispatch(r.expert_idx, r.keep, E)
    L = T * K
    row = torch.arange(E * cap_pad, device=x.device)
    e_of = row // cap_pad
    p_of = row % cap_pad
    valid = p_of < sd.group_sizes[e_of]
    src_sorted = torch.clamp(sd.group_offsets[e_of] + p_of, max=L - 1)
    src_tok = sd.perm[src_sorted] // K
    buf = torch.where(valid[:, None], x[src_tok], 0).to(x.dtype)
    # Combine index: each kept assignment's span position is its sorted-
    # stream position minus its expert's group offset.
    flat_e = r.expert_idx.reshape(-1)
    keep_flat = r.keep.reshape(-1)
    idx_flat = flat_e * cap_pad + (sd.inv_perm - sd.group_offsets[flat_e])
    idx_flat = torch.where(keep_flat, idx_flat, E * cap_pad)            # OOB = drop

    # ------------------------------------------------ 4. expert compute
    ye = expert_ffn_gmm(buf.reshape(E, cap_pad, D), w1, w2, w3, activation, bm=bm)

    # ------------------------------------------------ 7. un-permute + combine
    gath = ye.reshape(E * cap_pad, D)[torch.clamp(idx_flat, max=E * cap_pad - 1)]
    w = (r.combine_w.reshape(-1) * keep_flat).float()
    y = (gath.float() * w[:, None]).reshape(-1, K, D).sum(dim=1).to(x.dtype)

    kept_ct = r.keep.float().sum()
    dropf = 1.0 - kept_ct / max(float(T * K), 1.0)
    return y, {"moe_aux_loss": r.aux_loss, "moe_z_loss": r.z_loss,
               "moe_drop_fraction": dropf}
