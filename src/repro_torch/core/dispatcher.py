"""The MoE dispatcher at one rank: route → permute → expert FFN →
un-permute → top-k combine, plus the shared experts.

Port of ``repro.core.dispatcher`` for one device (docs/dispatcher.md).
Two permutation layouts build the per-expert buffer:

* ``permute_mode="sort"`` (MegaBlocks-style): a stable argsort by expert id
  groups the kept assignments; each expert owns a span of ``cap_pad =
  round_up(capacity, gmm_block_m)`` rows of the ``(E * cap_pad, D)``
  buffer, which is *gathered* (row ``e*cap_pad + p`` holds the p-th kept
  assignment of expert e in token order). Every ``bm``-row block belongs
  to one expert, so the expert FFN is three launches of the GMM kernel
  (:func:`repro_torch.kernels.gmm.ops.expert_ffn_gmm`). In dropless mode a
  ``capacity_hint`` (:func:`routed_capacity_hint`) replaces the worst case
  ``capacity = t``.
* ``permute_mode="scatter"``: each kept assignment is added into slot
  ``e * capacity + pos_in_expert`` of an ``(E * capacity + 1, D)`` buffer
  whose last row takes the drops; the expert FFN is three batched matmuls
  (:func:`_expert_ffn_einsum`), as the reference computes it outside any
  kernel.

Each assignment reads its row back and the top-k combine sums in fp32; the
shared experts' fp32 output (:func:`_shared_expert_ffn`) is added before
the cast to ``x.dtype``.

At one rank the EP All-to-All-V and the ETP AllGather-V/ReduceScatter-V
are identities, and the overlap ladder (``MoEConfig.overlap_chunks``) is
numerically identical to one chunk, so it runs as one chunk.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.router import (capacity_per_expert, dropless_bucket_capacity,
                                     resolved_capacity, route, sorted_dispatch)
from repro_torch.kernels.gmm.ops import expert_ffn_gmm
from repro_torch.models.common import activation as act_fn


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _expert_ffn_einsum(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       w3: torch.Tensor, activation: str) -> torch.Tensor:
    """xe: (E, N, D); w1/w3: (E, D, F); w2: (E, F, D) → (E, N, D)."""
    h = act_fn(activation, torch.bmm(xe, w1), torch.bmm(xe, w3))
    return torch.bmm(h, w2)


def _shared_expert_ffn(x: torch.Tensor, shared: Sequence[torch.Tensor],
                       activation: str) -> torch.Tensor:
    """Dense shared-expert FFN over every token → fp32 (T, D).

    ``shared`` is ``(ws1, ws2, ws3)`` — ``(D, Fs)``, ``(Fs, D)``, ``(D, Fs)``
    — plus an optional ``(D, 1)`` gate: with it the output is scaled per
    token by ``sigmoid(x @ gate)`` taken in fp32 (Qwen2-MoE); without, it
    is added ungated (DeepSeek's variant)."""
    ws1, ws2, ws3 = shared[:3]
    with torch.profiler.record_function("shared expert"):
        h = act_fn(activation, x @ ws1.to(x.dtype), x @ ws3.to(x.dtype))
        y = (h @ ws2.to(x.dtype)).float()
        if len(shared) > 3:
            y = y * torch.sigmoid(x.float() @ shared[3].float())
    return y


def routed_capacity_hint(x: torch.Tensor, wg: torch.Tensor, mcfg: MoEConfig, *,
                         block: Optional[int] = None) -> int:
    """Host-side pre-pass for the sorted dropless layout (one token shard).

    Routes ``x`` (T, D) as :func:`moe_ffn` will, takes the largest
    per-expert routed count and buckets it with
    :func:`dropless_bucket_capacity`. The returned int is a
    ``capacity_hint``; reading it synchronises with the device. The hint
    holds only for the batch it was computed from: a batch whose routed
    counts exceed it drops the overflow (``moe_drop_fraction > 0``)."""
    T = x.shape[0]
    with torch.no_grad():
        r = route(x, wg, mcfg, capacity=T)
        counts = F.one_hot(r.expert_idx, mcfg.n_experts).sum(dim=(0, 1))
    return dropless_bucket_capacity(int(counts.max()), block=block or mcfg.gmm_block_m,
                                    n_tokens=T)


def moe_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            w3: torch.Tensor, mcfg: MoEConfig, *, activation: str = "swiglu",
            permute_mode: Optional[str] = None, capacity_hint: Optional[int] = None,
            shared_weights: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the MoE FFN to a flat batch of tokens ``x`` (T, D) at one rank.

    ``wg`` (D, E); ``w1``/``w3`` (E, D, F); ``w2`` (E, F, D).
    ``permute_mode`` overrides ``mcfg.permute_mode`` ("scatter" | "sort").
    The sort layout's expert FFN always runs through the GMM kernel, which
    raises ``ValueError`` on shapes it does not tile (``D`` or ``F`` not a
    multiple of 128, or ``mcfg.gmm_block_m`` < 8).
    ``capacity_hint`` (sort + dropless only; ignored by the scatter layout,
    as in the reference): the static capacity from
    :func:`routed_capacity_hint`, clamped to ``T``; an undersized hint drops
    the overflow.
    ``shared_weights``: optional ``(ws1, ws2, ws3[, gate])``, see
    :func:`_shared_expert_ffn`; its output is added to every token's.
    Returns ``(y, stats)`` with ``moe_aux_loss``, ``moe_z_loss`` and
    ``moe_drop_fraction``.
    """
    mode = permute_mode if permute_mode is not None else mcfg.permute_mode
    if mode not in ("scatter", "sort"):
        raise ValueError(f"unknown permute_mode {mode!r}")
    use_sort = mode == "sort"
    if mcfg.ragged_a2a and not use_sort:
        raise ValueError("ragged A2A requires permute_mode='sort' — the "
                         "packed expert-major stream is what it ships")
    if capacity_hint is not None and mcfg.drop_policy == "full_sequence":
        raise ValueError("capacity_hint is not supported with "
                         "drop_policy='full_sequence'")
    if mcfg.ragged_a2a:
        raise NotImplementedError(
            "the ragged EP exchange needs more than one rank; it is not "
            "ported yet (ROADMAP.md queue 1, 'Distributed dispatcher')")
    if shared_weights is not None and len(shared_weights) not in (3, 4):
        raise ValueError("shared_weights must be (ws1, ws2, ws3[, gate]), got "
                         f"{len(shared_weights)} tensors")

    T, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    cap = resolved_capacity(T, mcfg, capacity_hint if use_sort else None)
    # Sort: each expert's span is a whole number of GMM row blocks.
    cap_pad = _round_up(cap, mcfg.gmm_block_m) if use_sort else cap
    n_rows = E * cap_pad

    # ------------------------------------------------ 1. route + permute
    r = route(x, wg, mcfg, capacity=cap)
    flat_e = r.expert_idx.reshape(-1)
    keep_flat = r.keep.reshape(-1)
    if use_sort:
        sd = sorted_dispatch(r.expert_idx, r.keep, E)
        L = T * K
        row = torch.arange(n_rows, device=x.device)
        e_of = row // cap_pad
        p_of = row % cap_pad
        valid = p_of < sd.group_sizes[e_of]
        src_sorted = torch.clamp(sd.group_offsets[e_of] + p_of, max=L - 1)
        src_tok = sd.perm[src_sorted] // K
        buf = torch.where(valid[:, None], x[src_tok], 0).to(x.dtype)
        # Combine index: each kept assignment's span position is its sorted-
        # stream position minus its expert's group offset.
        idx_flat = flat_e * cap_pad + (sd.inv_perm - sd.group_offsets[flat_e])
    else:
        idx_flat = flat_e * cap_pad + r.pos_in_expert.reshape(-1)
    idx_flat = torch.where(keep_flat, idx_flat, n_rows)                # OOB = drop
    if not use_sort:
        # Every kept slot takes exactly one row; the drops land in the
        # extra last row, which is cut off (the reference's mode="drop").
        buf = torch.zeros((n_rows + 1, D), dtype=x.dtype, device=x.device).index_add(
            0, idx_flat, x.repeat_interleave(K, dim=0))[:n_rows]

    # ------------------------------------------------ 4. expert compute
    xe = buf.reshape(E, cap_pad, D)
    if use_sort:
        ye = expert_ffn_gmm(xe, w1, w2, w3, activation, bm=mcfg.gmm_block_m)
    else:
        ye = _expert_ffn_einsum(xe, w1, w2, w3, activation)

    # ------------------------------------------------ 7. un-permute + combine
    gath = ye.reshape(n_rows, D)[torch.clamp(idx_flat, max=n_rows - 1)]
    w = (r.combine_w.reshape(-1) * keep_flat).float()
    y = (gath.float() * w[:, None]).reshape(-1, K, D).sum(dim=1)
    if shared_weights is not None:
        y = y + _shared_expert_ffn(x, shared_weights, activation)
    y = y.to(x.dtype)

    kept_ct = r.keep.float().sum()
    dropf = 1.0 - kept_ct / max(float(T * K), 1.0)
    return y, {"moe_aux_loss": r.aux_loss, "moe_z_loss": r.z_loss,
               "moe_drop_fraction": dropf}


def moe_ffn_reference(x_chunks: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, w3: Optional[torch.Tensor], mcfg: MoEConfig, *,
                      activation: str = "swiglu"
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain-torch oracle with the same sub-sequence-drop semantics: every
    expert applied to every token, weighted by the kept gates.

    ``x_chunks``: (n_ranks, t, D) — tokens pre-split into the per-rank
    chunks a sharded dispatcher would see. Returns (n_ranks, t, D) and the
    aux and z losses averaged over the chunks."""
    n, t, D = x_chunks.shape
    cap = capacity_per_expert(t, mcfg)
    ys, auxs, zls = [], [], []
    for xc in x_chunks:
        r = route(xc, wg, mcfg, capacity=cap)
        w = r.combine_w * r.keep.float()                                  # (t, K)
        oh = F.one_hot(r.expert_idx, mcfg.n_experts).float()
        gates = (w[..., None] * oh).sum(dim=1)                            # (t, E)
        gate_h = torch.einsum("td,edf->etf", xc, w1)
        up_h = torch.einsum("td,edf->etf", xc, w3) if w3 is not None else None
        h = act_fn(activation, gate_h, up_h)
        ye = torch.einsum("etf,efd->etd", h, w2)                          # (E, t, D)
        ys.append(torch.einsum("etd,te->td", ye.float(), gates).to(xc.dtype))
        auxs.append(r.aux_loss)
        zls.append(r.z_loss)
    return torch.stack(ys), {"moe_aux_loss": torch.stack(auxs).mean(),
                             "moe_z_loss": torch.stack(zls).mean()}
