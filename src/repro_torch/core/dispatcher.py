"""The flexible token-level MoE dispatcher (paper §3.3), across ranks.

Port of ``repro.core.dispatcher``. Forward workflow (Figure 2), in
collective order, over the process groups of
:class:`repro_torch.core.folding.FoldedGroups`:

  0. AllGather (EDP) of the expert weights, which rest sharded on ``D``
     (its backward reduce-scatters their gradients)
  1. router → permutation into per-expert buffer spans (local)
  2. All-to-All-V across the EP group
  3. AllGather-V within the ETP group (ETP members hold different tokens)
  4. expert FFN on this rank's experts and ``F`` columns
  5. ReduceScatter-V within the ETP group (reverses step 3)
  6. All-to-All-V back across EP
  7. un-permutation + top-k combine

With ``groups=None`` every group has one rank, every collective is an
identity, and the layer runs one chunk (unless ``overlap_chunks`` is given):
the one-rank layer the serving and training paths call.

Two permutation layouts build the step-1 buffer:

* ``permute_mode="sort"`` (MegaBlocks-style): a stable argsort by expert id
  groups the kept assignments; each expert owns ``capacity`` rows of the
  exchanged buffer (row ``e*capacity + p`` holds the p-th kept assignment
  of expert e in token order), and after the exchange a span of ``cap_pad
  = round_up(capacity, gmm_block_m)`` rows (zero rows appended). Every
  ``bm``-row block belongs to one expert, so the expert FFN is three GMM
  kernel launches (:func:`repro_torch.kernels.gmm.ops.expert_ffn_gmm`),
  or the reference's einsum where ``D`` or the ETP-local ``F`` is not a
  multiple of 128. In dropless mode a ``capacity_hint``
  (:func:`routed_capacity_hint`) replaces the worst case ``capacity = t``.
* ``permute_mode="scatter"``: each kept assignment is added into slot
  ``e * capacity + pos_in_expert`` of an ``(E * capacity + 1, D)`` buffer
  whose last row takes the drops; the expert FFN is three ``torch.bmm``.

Both layouts share steps 2–6 on the ``(E, capacity, D)`` expert-major
buffer (the *padded* exchange). The sort layout also has the *ragged*
exchange (``ragged=True``): the ranks first exchange their per-expert kept
counts over EP and ship only the packed kept rows through
``all_to_all_single`` with split sizes; the ETP AllGather-V and
ReduceScatter-V move the packed streams. ``all_to_all_single`` takes its
splits as host lists, so the counts move to the host once per chunk (one
synchronisation, which Megatron's dispatcher pays too; the reference keeps
them on the device behind static buckets). Each local expert still gets a
uniform ``(n_src · cap_pad)``-row span, packed rows then a zero tail, so
the expert FFN, its launches and every output row are those of the padded
path: the two are bitwise equal.

**Chunked overlap** (``overlap_chunks``, :mod:`repro_torch.core.overlap`):
steps 1b–7a run per contiguous token chunk through the double-buffered
ladder; chunk ``c+1``'s EP All-to-All is issued (``async_op=True``) before
chunk ``c``'s expert FFN and waited for in chunk ``c+1``'s compute step.
Routing, drops and the aux losses are computed once on the whole stream.
The shared experts run right after the first chunk's dispatch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, ParallelConfig
from repro_torch.core import comm
from repro_torch.core.folding import FoldedGroups, folded_axes
from repro_torch.core.overlap import chunk_spans, resolve_chunks, software_pipeline
from repro_torch.core.router import (capacity_per_expert, chunk_expert_offsets,
                                     chunked_sorted_dispatch, dropless_bucket_capacity,
                                     resolved_capacity, route)
from repro_torch.kernels.gmm.ops import expert_ffn_einsum, expert_ffn_gmm
from repro_torch.models.common import activation as act_fn


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _group(groups: Optional[FoldedGroups], name: str) -> Optional[dist.ProcessGroup]:
    return None if groups is None else groups.moe[name]


def _shared_expert_ffn(x: torch.Tensor, shared: Sequence[torch.Tensor], activation: str,
                       groups: Optional[FoldedGroups] = None) -> torch.Tensor:
    """Dense shared-expert FFN over the local tokens → fp32 (t, D).

    ``shared`` is ``(ws1, ws2, ws3)`` — ``(D, Fs)``, ``(Fs, D)``, ``(D, Fs)``,
    this rank's EDP slice of ``D`` and ETP slice of ``Fs`` — plus an
    optional replicated ``(D, 1)`` gate: with it the output is scaled per
    token by ``sigmoid(x @ gate)`` in fp32 (Qwen2-MoE); without, it is added
    ungated (DeepSeek's variant). Across ranks the weights are gathered over
    EDP, the ETP group's tokens are gathered, this rank's column block is
    computed and the fp32 partial sums are reduce-scattered back. The
    weights are replicated over EP and the gate over every token rank, so
    their gradients are summed there."""
    ws1, ws2, ws3 = shared[:3]
    gate = shared[3] if len(shared) > 3 else None
    xg = x
    if groups is not None:
        ws1, ws2, ws3 = (comm.grad_sum(w, _group(groups, "ep")) for w in (ws1, ws2, ws3))
        edp = _group(groups, "edp")
        ws1, ws3 = comm.all_gather(ws1, edp, 0), comm.all_gather(ws3, edp, 0)
        ws2 = comm.all_gather(ws2, edp, 1)
        if gate is not None:
            gate = comm.grad_sum(gate, _group(groups, "tokens"))
        xg = comm.all_gather(x, _group(groups, "etp"), 0)
    with torch.profiler.record_function("shared expert"):
        h = act_fn(activation, xg @ ws1.to(x.dtype), xg @ ws3.to(x.dtype))
        y = (h @ ws2.to(x.dtype)).float()
        if gate is not None:
            # A per-token scalar distributes over the ETP partial sums.
            y = y * torch.sigmoid(xg.float() @ gate.float())
    if groups is not None:
        y = comm.reduce_scatter(y, _group(groups, "etp"), 0)
    return y


def token_shard(x: torch.Tensor, groups: FoldedGroups
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's rows of a full token batch ``x`` (T, D), as the reference
    shards it over the MoE token atoms EDP×EP×ETP (``_token_shards``): the
    batch padded to a multiple of the shard count, shard ``i`` = rows
    ``[i·t, (i+1)·t)`` for the rank at index ``i`` of the ``tokens`` axis.
    Returns ``(x_local, token_mask)``; the mask (False on padding) is
    ``None`` when ``T`` divides evenly."""
    tok = groups.moe["tokens"]
    T = x.shape[0]
    pad = (-T) % tok.size
    t_l = (T + pad) // tok.size
    lo = tok.index * t_l
    if not pad:
        return x[lo:lo + t_l], None
    x = F.pad(x, (0, 0, 0, pad))
    mask = torch.arange(lo, lo + t_l, dtype=torch.long, device=x.device) < T
    return x[lo:lo + t_l], mask


def routed_capacity_hint(x: torch.Tensor, wg: torch.Tensor, mcfg: MoEConfig, *,
                         block: Optional[int] = None, groups: Optional[FoldedGroups] = None,
                         token_mask: Optional[torch.Tensor] = None) -> int:
    """Host-side pre-pass for the sorted dropless layout.

    Routes this rank's tokens ``x`` (t, D) as :func:`moe_ffn` will, takes
    the largest per-expert routed count (its max over the ``tokens`` group
    across ranks) and buckets it with :func:`dropless_bucket_capacity`. The
    returned int is a ``capacity_hint``; reading it synchronises with the
    device. The hint holds only for the batch it was computed from: a batch
    whose routed counts exceed it drops the overflow
    (``moe_drop_fraction > 0``)."""
    t = x.shape[0]
    with torch.no_grad():
        r = route(x, wg, mcfg, capacity=t, token_mask=token_mask)
        oh = F.one_hot(r.expert_idx, mcfg.n_experts)
        if token_mask is not None:
            oh = oh * token_mask.long()[:, None, None]
        top = comm.all_reduce(oh.sum(dim=(0, 1)).max(), _group(groups, "tokens"),
                              op=dist.ReduceOp.MAX)
    return dropless_bucket_capacity(int(top), block=block or mcfg.gmm_block_m, n_tokens=t)


def _moe_sizes(pcfg: ParallelConfig) -> Tuple[int, int, int]:
    """(EDP, EP, ETP) sizes of the MoE side of a mapping, pods included."""
    shape, _, moe = folded_axes(pcfg)
    return tuple(math.prod(shape[d] for d in moe[n]) for n in ("edp", "ep", "etp"))


def _route_sweep(x: torch.Tensor, wg: torch.Tensor, mcfg: MoEConfig, n_shards: int,
                 cap_fn: Callable[[int], int], stat_fn: Callable) -> Tuple[torch.Tensor, int]:
    """Route every token shard of the full batch ``x`` as the ranks will
    (same padding and mask) and stack ``stat_fn(router_output, mask)``."""
    T, D = x.shape
    pad = (-T) % n_shards
    t_l = (T + pad) // n_shards
    xp = F.pad(x, (0, 0, 0, pad))
    valid = torch.arange(T + pad, dtype=torch.long, device=x.device) < T
    out = []
    with torch.no_grad():
        for i in range(n_shards):
            m = valid[i * t_l:(i + 1) * t_l]
            out.append(stat_fn(route(xp[i * t_l:(i + 1) * t_l], wg, mcfg, capacity=cap_fn(t_l),
                                     token_mask=m), m))
    return torch.stack(out), t_l


def ep_dispatch_payload_bytes(x: torch.Tensor, wg: torch.Tensor, mcfg: MoEConfig,
                              pcfg: ParallelConfig, *,
                              capacity_hint: Optional[int] = None) -> Dict[str, float]:
    """Host-side accounting of the per-rank EP All-to-All-V payload for the
    full batch ``x`` (T, D) under the MoE mapping of ``pcfg``: what each
    direction ships per rank.

    * ``padded_bytes`` — the uniform ``(E, capacity, D)`` buffer;
    * ``ragged_send_bytes_max`` / ``_mean`` — the ragged path's send side,
      each rank's kept rows (max / mean over ranks);
    * ``ragged_recv_bytes_max`` / ``_mean`` — rows bound for each rank's
      local experts, summed over sources (the hot link under skew);
    * ``count_exchange_bytes`` — the ragged path's count exchange
      (``ep × E`` int32 per rank, as the reference counts it);
    * ``capacity`` — the resolved per-(rank, expert) capacity.

    The same numbers as the reference's; host-syncs."""
    if mcfg.drop_policy == "full_sequence":
        raise ValueError("ep_dispatch_payload_bytes does not support "
                         "drop_policy='full_sequence'")
    E, D = mcfg.n_experts, x.shape[1]
    edp, ep, etp = _moe_sizes(pcfg)

    def cap_fn(t_l):
        return resolved_capacity(t_l, mcfg, capacity_hint)

    def kept_per_expert(r, mask):
        kept = (r.keep & mask[:, None]).long()
        return (F.one_hot(r.expert_idx, E) * kept[..., None]).sum(dim=(0, 1))

    counts, t_l = _route_sweep(x, wg, mcfg, edp * ep * etp, cap_fn, kept_per_expert)
    counts = counts.cpu()                                            # (n_shards, E)
    send = counts.sum(dim=1)
    # Shards enumerate the token atoms (EDP, EP, ETP) row-major; the EP
    # exchange runs within each (edp, etp) group.
    recv = counts.reshape(edp, ep, etp, ep, E // ep).sum(dim=(1, 4))
    isz = x.element_size()
    return {"padded_bytes": float(E * cap_fn(t_l) * D * isz),
            "ragged_send_bytes_max": float(int(send.max()) * D * isz),
            "ragged_send_bytes_mean": float(send.double().mean() * D * isz),
            "ragged_recv_bytes_max": float(int(recv.max()) * D * isz),
            "ragged_recv_bytes_mean": float(recv.double().mean() * D * isz),
            "count_exchange_bytes": float(ep * E * 4),
            "capacity": float(cap_fn(t_l))}


def moe_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            w3: torch.Tensor, mcfg: MoEConfig, *, activation: str = "swiglu",
            permute_mode: Optional[str] = None, capacity_hint: Optional[int] = None,
            shared_weights: Optional[Sequence[torch.Tensor]] = None,
            ragged: Optional[bool] = None, overlap_chunks: Optional[int] = None,
            groups: Optional[FoldedGroups] = None,
            token_mask: Optional[torch.Tensor] = None, stats: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply the MoE FFN to this rank's tokens ``x`` (t, D).

    ``groups``: the folded process groups; ``None`` is one rank. Across
    ranks ``x`` is this rank's token shard (:func:`token_shard`), ``wg``
    (D, E) and the shared gate are replicated, ``w1``/``w3`` (E/ep, D/edp,
    F/etp) and ``w2`` (E/ep, F/etp, D/edp) are this rank's expert shards
    (:func:`repro_torch.core.moe_layer.shard_moe_params`).
    ``token_mask`` (t,): False rows (batch padding) are never dispatched.
    ``permute_mode`` overrides ``mcfg.permute_mode`` ("scatter" | "sort").
    ``capacity_hint`` (sort + dropless only; ignored by the scatter layout,
    as in the reference): the static capacity from
    :func:`routed_capacity_hint`, clamped to ``t``.
    ``ragged`` (sort only) overrides ``mcfg.ragged_a2a``.
    ``overlap_chunks`` overrides the chunk count, which is
    ``mcfg.overlap_chunks`` across ranks and 1 at one rank.
    ``shared_weights``: optional ``(ws1, ws2, ws3[, gate])``, see
    :func:`_shared_expert_ffn`; its output is added to every token's.
    Returns ``(y, stats)`` with ``moe_aux_loss`` and ``moe_z_loss`` (means
    over the token ranks) and ``moe_drop_fraction`` (over real tokens);
    with ``stats=False`` the statistics and their reductions over the token
    ranks are skipped (serving reads none) and ``stats`` is empty.
    """
    mode = permute_mode if permute_mode is not None else mcfg.permute_mode
    if mode not in ("scatter", "sort"):
        raise ValueError(f"unknown permute_mode {mode!r}")
    use_sort = mode == "sort"
    use_ragged = bool(mcfg.ragged_a2a if ragged is None else ragged)
    if overlap_chunks is None:
        overlap_chunks = mcfg.overlap_chunks if groups is not None else 1
    n_chunks = int(overlap_chunks)
    if n_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {n_chunks}")
    full_seq = mcfg.drop_policy == "full_sequence"
    if n_chunks > 1 and full_seq:
        raise ValueError("overlap_chunks > 1 is not supported with "
                         "drop_policy='full_sequence'")
    if use_ragged and not use_sort:
        raise ValueError("ragged A2A requires permute_mode='sort' — the "
                         "packed expert-major stream is what it ships")
    if capacity_hint is not None and full_seq:
        raise ValueError("capacity_hint is not supported with "
                         "drop_policy='full_sequence'")
    if use_ragged and full_seq:
        raise ValueError("ragged A2A is not supported with drop_policy='full_sequence'")
    if shared_weights is not None and len(shared_weights) not in (3, 4):
        raise ValueError("shared_weights must be (ws1, ws2, ws3[, gate]), got "
                         f"{len(shared_weights)} tensors")

    ep_ax = None if groups is None else groups.moe["ep"]
    ep, etp = (1, 1) if groups is None else (groups.ep, groups.etp)
    ep_g, etp_g = _group(groups, "ep"), _group(groups, "etp")
    E, K = mcfg.n_experts, mcfg.top_k
    if E % ep:
        raise ValueError(f"n_experts {E} not divisible by EP {ep}")
    e_local = E // ep
    if w1.shape[0] != e_local:
        raise ValueError(f"w1 holds {w1.shape[0]} experts; EP {ep} gives each rank {e_local}")
    t_l, D = x.shape
    cap = resolved_capacity(t_l, mcfg, capacity_hint if use_sort else None)

    # ------------------------------------------------ 0. EDP weight gather
    wg = comm.grad_sum(wg, _group(groups, "tokens"))
    edp_g = _group(groups, "edp")
    w1, w3 = comm.all_gather(w1, edp_g, 1), comm.all_gather(w3, edp_g, 1)
    w2 = comm.all_gather(w2, edp_g, 2)
    if w1.shape[1] != D:
        raise ValueError(f"expert weights hold D={w1.shape[1]} after the EDP gather, x has {D}")
    f_local = w1.shape[-1]
    # The GMM tiles the sort layout when D and the ETP-local F are multiples
    # of 128; spans are then whole GMM row blocks. Otherwise the reference
    # aligns nothing and takes the einsum.
    gmm_ok = use_sort and mcfg.gmm_block_m >= 8 and D % 128 == 0 and f_local % 128 == 0
    span_block = mcfg.gmm_block_m if gmm_ok else 1

    # ------------------------------------------------ 1. route
    if full_seq and groups is not None and groups.moe["seq"].size > 1:
        # The drop decision sees the whole sequence (paper §3.3 option 1):
        # gather the router logits over EP×ETP, route them all, keep my rows.
        seq = groups.moe["seq"]
        logits = comm.all_gather(x.float() @ wg.float(), seq, 0)
        gmask = None
        if token_mask is not None:
            gmask = comm.all_gather(token_mask.to(torch.int32), seq, 0).bool()
        capacity = capacity_per_expert(logits.shape[0], mcfg)
        r_full = route(logits, torch.eye(E, dtype=torch.float32, device=x.device), mcfg,
                       capacity=capacity, token_mask=gmask)
        mine = slice(seq.index * t_l, (seq.index + 1) * t_l)
        r = dataclasses.replace(r_full, expert_idx=r_full.expert_idx[mine],
                                combine_w=r_full.combine_w[mine],
                                pos_in_expert=r_full.pos_in_expert[mine],
                                keep=r_full.keep[mine], probs=r_full.probs[mine])
    else:
        r = route(x, wg, mcfg, capacity=cap, token_mask=token_mask)
        capacity = cap

    # ------------------------------------------------ 1b. chunk partition
    # A chunk of n_c tokens sends at most n_c rows to one expert (top-k
    # experts are distinct) and never more than the whole stream's capacity.
    C = resolve_chunks(t_l, n_chunks)
    spans = chunk_spans(t_l, C)
    caps = tuple(capacity if C == 1 else min(capacity, s) for _, s in spans)
    cap_pads = tuple(_round_up(cc, span_block) for cc in caps)
    sds = chunked_sorted_dispatch(r.expert_idx, r.keep, E, spans, ep=ep) if use_sort else None
    rebase = (chunk_expert_offsets(r.expert_idx, E, spans, token_mask)
              if (not use_sort and C > 1) else None)
    n_src = etp * ep

    def expert_compute(xe: torch.Tensor) -> torch.Tensor:
        # ------------------------------------------ 4. expert compute
        # xe: (e_local, n_src·cap_pad, D), every bm-row block one expert's,
        # whether rows arrive capacity-strided (padded) or packed (ragged).
        if use_sort:
            return expert_ffn_gmm(xe, w1, w2, w3, activation, bm=span_block)
        return expert_ffn_einsum(xe, w1, w2, w3, activation)

    def padded_dispatch(c: int) -> dict:
        off, n_c = spans[c]
        x_c = x[off:off + n_c]
        flat_e = r.expert_idx[off:off + n_c].reshape(-1)
        keep_c = r.keep[off:off + n_c].reshape(-1)
        # The exchange ships each expert's ``cap`` rows; the GMM's span
        # padding to ``cap_pad`` is added after the ETP gather, so no tile
        # padding crosses the wire.
        cap = caps[c]
        n_rows = E * cap
        if use_sort:
            sd = sds[c]
            row = torch.arange(n_rows, dtype=torch.long, device=x.device)
            e_of, p_of = row // cap, row % cap
            valid = p_of < sd.group_sizes[e_of]
            src_sorted = torch.clamp(sd.group_offsets[e_of] + p_of, max=n_c * K - 1)
            buf = torch.where(valid[:, None], x_c[sd.perm[src_sorted] // K], 0).to(x.dtype)
            # Each kept assignment's span position is its sorted-stream
            # position minus its expert's group offset.
            idx = flat_e * cap + (sd.inv_perm - sd.group_offsets[flat_e])
        else:
            pos = r.pos_in_expert[off:off + n_c].reshape(-1)
            if rebase is not None:
                pos = pos - rebase[c][flat_e]
            idx = flat_e * cap + pos
        idx = torch.where(keep_c, idx, n_rows)                           # OOB = drop
        if not use_sort:
            # The drops land in the extra last row, which is cut off.
            buf = torch.zeros((n_rows + 1, D), dtype=x.dtype, device=x.device).index_add(
                0, idx, x_c.repeat_interleave(K, dim=0))[:n_rows]
        # -------------------------------------------- 2. All-to-All (EP)
        pending: list = []
        buf = comm.all_to_all(buf, ep_g, pending=pending)    # (ep_src, e_local, cap, D)
        return dict(buf=buf, idx=idx, pending=pending, cap=cap, cap_pad=cap_pads[c])

    def padded_gather(st: dict) -> torch.Tensor:
        comm.wait(st["pending"])
        # -------------------------------------------- 3. AllGather (ETP)
        buf = comm.all_gather(st["buf"], etp_g, 0)       # (etp, ep_src, e_local, cap, D)
        cap, cap_pad = st["cap"], st["cap_pad"]
        buf = buf.reshape(n_src, e_local, cap, D)
        if cap_pad != cap:
            buf = F.pad(buf, (0, 0, 0, cap_pad - cap))    # zero rows to the GMM's block
        return buf.transpose(0, 1).reshape(e_local, n_src * cap_pad, D)

    def padded_combine(c: int, st: dict, ye: torch.Tensor) -> torch.Tensor:
        cap, cap_pad = st["cap"], st["cap_pad"]
        yb = ye.reshape(e_local, n_src, cap_pad, D)[:, :, :cap]
        yb = yb.transpose(0, 1).reshape(-1, D)
        yb = comm.reduce_scatter(yb, etp_g, 0)              # 5. ReduceScatter (ETP)
        yb = comm.all_to_all(yb, ep_g)                      # 6. All-to-All back (EP)
        return yb[torch.clamp(st["idx"], max=E * cap - 1)]            # 7a. (t_c·K, D)

    def ragged_dispatch(c: int) -> dict:
        off, n_c = spans[c]
        sd = sds[c]
        # 2a. count exchange: every EP source's kept rows per expert, and
        # every ETP member's received counts for its AllGather-V. The split
        # lists are host lists: one synchronisation per chunk.
        sizes_all = comm.all_gather(sd.group_sizes[None], ep_g, 0)         # (ep, E)
        mine = sizes_all[:, ep_ax.index * e_local:(ep_ax.index + 1) * e_local].contiguous()
        per_se = comm.all_gather(mine, etp_g, 0)                 # (etp·ep, e_local)
        host = torch.cat([sizes_all.reshape(-1), per_se.reshape(-1)]).cpu()
        to_rank = host[:ep * E].reshape(ep, ep, e_local).sum(dim=2)     # [src, dst]
        per_se = host[ep * E:].reshape(n_src, e_local)
        send_splits = to_rank[ep_ax.index].tolist()
        recv_splits = to_rank[:, ep_ax.index].tolist()
        n_kept = sum(send_splits)
        # 1c. the packed send stream: kept rows, expert-major, so each
        # destination rank's rows are contiguous.
        send = x[off:off + n_c][sd.perm[:n_kept] // K].to(x.dtype)
        pending: list = []
        # 2b. All-to-All-V (EP): my rows land source-major at each receiver.
        recv = comm.all_to_all(send, ep_g, in_splits=send_splits, out_splits=recv_splits,
                               pending=pending)
        return dict(recv=recv, pending=pending, per_se=per_se, sd=sd, L=n_c * K,
                    n_kept=n_kept, send_splits=send_splits, recv_splits=recv_splits,
                    cap_pad=cap_pads[c])

    def ragged_gather(st: dict) -> torch.Tensor:
        comm.wait(st["pending"])
        per_se = st["per_se"]                                  # (n_src, e_local) host
        member_rows = per_se.reshape(etp, ep * e_local).sum(dim=1).tolist()
        st["member_rows"] = member_rows
        recv = st["recv"]
        if etp > 1:
            # 3. AllGather-V (ETP): my stream to every member, theirs to me.
            recv = comm.all_to_all(recv.repeat(etp, 1), etp_g,
                                   in_splits=[recv.shape[0]] * etp, out_splits=member_rows)
        # 3b. re-layout into uniform expert-major spans (packed rows, zero
        # tail): recv rows run source-major, each source expert-major; row
        # j of local expert e is its j-th row across sources in order.
        span = n_src * st["cap_pad"]
        counts = per_se.reshape(-1)
        src_start = torch.cumsum(counts, 0) - counts
        dst_start = ((torch.arange(e_local, dtype=torch.long) * span)[None, :]
                     + torch.cumsum(per_se, 0) - per_se)
        dest = (torch.repeat_interleave(dst_start.reshape(-1) - src_start, counts)
                + torch.arange(int(counts.sum()), dtype=torch.long))
        st["dest"] = dest = dest.to(x.device)
        xe = torch.zeros((e_local * span, D), dtype=recv.dtype, device=x.device)
        return xe.index_copy(0, dest, recv).reshape(e_local, span, D)

    def ragged_combine(c: int, st: dict, ye: torch.Tensor) -> torch.Tensor:
        y_rows = ye.reshape(-1, D)[st["dest"]]                 # back in received order
        if etp > 1:
            # 5. ReduceScatter-V (ETP): each member's rows to it, summed.
            mine = st["recv"].shape[0]
            parts = comm.all_to_all(y_rows, etp_g, in_splits=st["member_rows"],
                                    out_splits=[mine] * etp)
            y_rows = parts.reshape(etp, mine, D).sum(dim=0)
        # 6. All-to-All-V back: the rows return to their packed positions.
        y_stream = comm.all_to_all(y_rows, ep_g, in_splits=st["recv_splits"],
                                   out_splits=st["send_splits"])
        # 7a. un-permute: dropped assignments sit past n_kept and read zeros.
        tail = y_stream.new_zeros((st["L"] - st["n_kept"], D))
        return torch.cat([y_stream, tail])[st["sd"].inv_perm]

    ragged_path = use_ragged and ep > 1
    dispatch = ragged_dispatch if ragged_path else padded_dispatch
    gather = ragged_gather if ragged_path else padded_gather
    combiner = ragged_combine if ragged_path else padded_combine
    shared_fn = None
    if shared_weights is not None:
        def shared_fn():
            return _shared_expert_ffn(x, shared_weights, activation, groups)
    gath_chunks, y_shared = software_pipeline(
        C, dispatch, lambda c, st: (st, expert_compute(gather(st))),
        lambda c, st_ye: combiner(c, *st_ye), concurrent=shared_fn)
    # Chunks are contiguous token spans: concatenation is token order.
    gath = gath_chunks[0] if C == 1 else torch.cat(gath_chunks)

    # ------------------------------------------------ 7b. top-k combine
    w = (r.combine_w.reshape(-1) * r.keep.reshape(-1)).float()
    y = (gath.float() * w[:, None]).reshape(-1, K, D).sum(dim=1)
    if y_shared is not None:
        y = y + y_shared
    y = y.to(x.dtype)

    # ------------------------------------------------ statistics
    if not stats:
        return y, {}
    tok_g = _group(groups, "tokens")
    aux, zl = comm.mean(r.aux_loss, tok_g), comm.mean(r.z_loss, tok_g)
    # The drop fraction counts real tokens only: padding rows are no drops.
    n_real = float(t_l) if token_mask is None else token_mask.float().sum()
    counts = comm.all_reduce(torch.stack([r.keep.float().sum(),
                                          torch.as_tensor(n_real * K, device=x.device)]),
                             tok_g)
    dropf = 1.0 - counts[0] / torch.clamp(counts[1], min=1.0)
    return y, {"moe_aux_loss": aux, "moe_z_loss": zl, "moe_drop_fraction": dropf}


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
