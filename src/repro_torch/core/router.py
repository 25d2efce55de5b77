"""Top-K MoE router with token-dropping (capacity factor) and dropless modes.

Port of ``repro.core.router`` at one rank: capacity and drop decisions use
only the tokens given (sub-sequence dropping, paper §3.3).

Discrete decisions match the JAX package exactly: top-k order is
``lax.top_k``'s (largest first, ties to the lower expert index) through a
stable descending sort, because ``torch.topk`` promises no tie order; drops
follow the arrival rank ``cumsum(onehot) - onehot``; the expert sort is a
stable argsort.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


@dataclasses.dataclass
class RouterOutput:
    expert_idx: torch.Tensor     # (t, K) int64 — selected expert per assignment
    combine_w: torch.Tensor      # (t, K) f32 — gating weights
    pos_in_expert: torch.Tensor  # (t, K) int64 — arrival rank within each expert
    keep: torch.Tensor           # (t, K) bool — survives capacity
    aux_loss: torch.Tensor       # scalar f32 — load-balancing loss
    z_loss: torch.Tensor         # scalar f32 — router z-loss
    probs: torch.Tensor          # (t, E) f32 — full softmax


def capacity_per_expert(n_tokens: int, cfg: MoEConfig) -> int:
    """Paper eq. (4): CF * L / E, counting routed assignments (L = t*K)."""
    if cfg.dropless:
        # One rank can send at most t tokens to one expert.
        return max(1, n_tokens)
    return max(1, int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))


def resolved_capacity(n_tokens: int, cfg: MoEConfig,
                      capacity_hint: Optional[int] = None) -> int:
    """The per-expert capacity the dispatcher runs with:
    :func:`capacity_per_expert`, overridden by a clamped ``capacity_hint``
    under dropless (the sorted layout's bucketed pre-pass)."""
    if cfg.dropless and capacity_hint is not None:
        return max(1, min(int(capacity_hint), n_tokens))
    return capacity_per_expert(n_tokens, cfg)


def dropless_bucket_capacity(max_count: int, *, block: int = 128,
                             n_tokens: Optional[int] = None) -> int:
    """Bucket an observed per-expert max routed count into a static capacity
    for the sorted dropless layout: ``block`` doubled until it holds
    ``max_count`` (a few buffer sizes, each within 2x of the demand), never
    above the provable worst case ``max(max_count, n_tokens)``."""
    if max_count < 0:
        raise ValueError(f"max_count must be >= 0, got {max_count}")
    cap = max(1, block)
    while cap < max_count:
        cap *= 2
    if n_tokens is not None:
        cap = min(cap, max(max_count, n_tokens))
    return cap


def _top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest entries of the last dim in
    ``lax.top_k`` order: largest first, equal values by lower index."""
    idx = torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(values, -1, idx), idx


def deterministic_top_k(logits: torch.Tensor, k: int, quantum: float) -> torch.Tensor:
    """Top-k on logits snapped to multiples of ``quantum``, exact ties on the
    grid broken toward the lower expert index. Returns (t, k) indices, best
    first. See ``repro.core.router.deterministic_top_k`` for the guarantee."""
    e = logits.shape[-1]
    # int32 lexicographic key (snapped logit, -expert index); the snap budget
    # is clamped so key = q*e + (e-1-idx) cannot overflow int32.
    lim = (2 ** 30) // max(e, 1)
    q = torch.clamp(torch.round(logits / quantum), -lim, lim).to(torch.int32)
    idx = torch.arange(e, dtype=torch.int32, device=logits.device)
    key = q * e + (e - 1 - idx)[None, :]
    return _top_k(key, k)[1]


def route(x: torch.Tensor, w_gate: torch.Tensor, cfg: MoEConfig, *, capacity: int,
          token_mask: Optional[torch.Tensor] = None) -> RouterOutput:
    """Route a chunk of tokens. ``x``: (t, D); ``w_gate``: (D, E).

    ``token_mask``: (t,) — False entries (padding) are never dispatched.
    """
    t = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = x.float() @ w_gate.float()                             # (t, E)
    probs = torch.softmax(logits, dim=-1)
    if cfg.deterministic_router:
        top_i = deterministic_top_k(logits, K, cfg.router_quantum)
        top_p = torch.gather(probs, 1, top_i)
    else:
        top_p, top_i = _top_k(probs, K)                             # (t, K)

    # Load-balancing auxiliary loss (Switch Transformer form):
    #   E * sum_e f_e * P_e, f_e = fraction of assignments to e, P_e = mean prob.
    assign_onehot = F.one_hot(top_i, E).float()                     # (t, K, E)
    if token_mask is not None:
        m = token_mask.float()
        assign_onehot = assign_onehot * m[:, None, None]
        probs_for_aux = probs * m[:, None]
        denom = torch.clamp(m.sum(), min=1.0)
    else:
        probs_for_aux = probs
        denom = float(t)
    f_e = assign_onehot.sum(dim=(0, 1)) / (denom * K)
    p_e = probs_for_aux.sum(dim=0) / denom
    aux_loss = E * torch.sum(f_e * p_e)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # Position of each assignment within its expert queue (token-order
    # priority, matching Megatron's drop policy).
    flat_e = top_i.reshape(-1)                                      # (t*K,)
    onehot = F.one_hot(flat_e, E)
    if token_mask is not None:
        onehot = onehot * token_mask.repeat_interleave(K).long()[:, None]
    pos_flat = torch.cumsum(onehot, dim=0) - onehot                 # arrivals before me
    pos = torch.gather(pos_flat, 1, flat_e[:, None])[:, 0].reshape(t, K)

    keep = pos < capacity
    if token_mask is not None:
        keep = keep & token_mask.bool()[:, None]

    return RouterOutput(expert_idx=top_i, combine_w=top_p.float(),
                        pos_in_expert=pos, keep=keep, aux_loss=aux_loss,
                        z_loss=z_loss, probs=probs)


@dataclasses.dataclass
class SortedDispatch:
    """Expert-sorted view of the routed assignments (``L = t * top_k`` ids).

    Dropped assignments sort after every expert group (key ``n_experts``),
    so the first ``sum(group_sizes)`` entries of ``perm`` are the kept
    assignments in (expert-major, token-order) order.
    """

    perm: torch.Tensor           # (L,) int64 — assignment ids in expert-sorted order
    inv_perm: torch.Tensor       # (L,) int64 — position of each assignment in ``perm``
    group_sizes: torch.Tensor    # (E,) int64 — kept assignments per expert
    group_offsets: torch.Tensor  # (E,) int64 — exclusive cumsum of group_sizes
    # With ``ep``: the packed stream's rows bound for EP rank d are the
    # contiguous slice [rank_offsets[d], rank_offsets[d] + rank_counts[d]),
    # the send side of the ragged All-to-All-V.
    rank_counts: Optional[torch.Tensor] = None    # (ep,) int64
    rank_offsets: Optional[torch.Tensor] = None   # (ep,) int64


def dest_rank_spans(group_sizes: torch.Tensor, ep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-destination-EP-rank send counts and offsets in the packed stream.

    EP rank ``d`` owns experts ``[d·E/ep, (d+1)·E/ep)`` and the packed
    stream is expert-major, so its slice is contiguous."""
    E = group_sizes.shape[0]
    if E % ep:
        raise ValueError(f"n_experts {E} not divisible by EP {ep}")
    counts = group_sizes.reshape(ep, E // ep).sum(dim=1)
    return counts, torch.cumsum(counts, 0) - counts


def sorted_dispatch(expert_idx: torch.Tensor, keep: torch.Tensor,
                    n_experts: int, *, ep: Optional[int] = None) -> SortedDispatch:
    """Stable argsort of assignments by expert id, drops last. With ``ep``
    also the per-destination-rank send spans (:func:`dest_rank_spans`)."""
    flat_e = expert_idx.reshape(-1).long()                          # (L,)
    kept = keep.reshape(-1)
    key = torch.where(kept, flat_e, n_experts)
    perm = torch.argsort(key, stable=True)
    inv_perm = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.numel(), dtype=torch.long, device=perm.device))
    group_sizes = torch.zeros(n_experts, dtype=torch.long,
                              device=flat_e.device).index_add_(0, flat_e, kept.long())
    group_offsets = torch.cumsum(group_sizes, 0) - group_sizes
    spans = dest_rank_spans(group_sizes, ep) if ep is not None else (None, None)
    return SortedDispatch(perm=perm, inv_perm=inv_perm, group_sizes=group_sizes,
                          group_offsets=group_offsets, rank_counts=spans[0],
                          rank_offsets=spans[1])


def chunked_sorted_dispatch(expert_idx: torch.Tensor, keep: torch.Tensor, n_experts: int,
                            spans: Sequence[Tuple[int, int]], *, ep: Optional[int] = None
                            ) -> Tuple[SortedDispatch, ...]:
    """Per-chunk :func:`sorted_dispatch` over the token ``spans`` of
    ``repro_torch.core.overlap.chunk_spans``. Routing (and so ``keep``) was
    decided on the unchunked stream; the chunks only partition the kept
    assignments, so their group sizes sum to the unchunked ones."""
    return tuple(sorted_dispatch(expert_idx[o:o + s], keep[o:o + s], n_experts, ep=ep)
                 for o, s in spans)


def chunk_expert_offsets(expert_idx: torch.Tensor, n_experts: int,
                         spans: Sequence[Tuple[int, int]],
                         token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routed arrivals per expert strictly before each chunk: (C, E).

    The scatter layout places each assignment at its arrival rank over the
    whole stream (:attr:`RouterOutput.pos_in_expert`); its position in a
    chunk's buffer is that rank less the arrivals of earlier chunks."""
    oh = F.one_hot(expert_idx, n_experts)                          # (t, K, E)
    if token_mask is not None:
        oh = oh * token_mask.long()[:, None, None]
    cum = torch.cumsum(oh.sum(dim=1), dim=0)                       # (t, E)
    zero = torch.zeros(n_experts, dtype=cum.dtype, device=cum.device)
    return torch.stack([zero if o == 0 else cum[o - 1] for o, _ in spans])


def padded_group_spans(group_sizes: torch.Tensor, bm: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each expert's row span rounded up to the GMM row block ``bm``:
    ``(padded_sizes, padded_offsets)``, MegaBlocks' contiguous layout."""
    padded = (group_sizes + bm - 1) // bm * bm
    return padded, torch.cumsum(padded, 0) - padded


def block_expert_from_group_sizes(group_sizes: torch.Tensor, bm: int,
                                  num_blocks: int) -> torch.Tensor:
    """The GMM's ``block_expert`` for the layout of :func:`padded_group_spans`:
    expert id per ``bm``-row block; blocks past the last span take the last
    expert (their rows are padding)."""
    padded, _ = padded_group_spans(group_sizes, bm)
    ends = torch.cumsum(padded, 0)
    starts = torch.arange(num_blocks, dtype=torch.long, device=group_sizes.device) * bm
    be = torch.searchsorted(ends, starts, right=True)
    return torch.clamp(be, 0, group_sizes.shape[0] - 1).to(torch.int32)
