"""The dispatcher's collectives as autograd Functions over a ProcessGroup.

``jax.lax`` derives each collective's transpose itself; here each Function
states it:

==================  ==========================  ===========================
collective          forward                     backward
==================  ==========================  ===========================
:func:`all_to_all`  ``all_to_all_single``       the reverse All-to-All(-V)
                    (equal or ragged splits)
:func:`all_gather`  tiled along ``dim``         reduce-scatter (sum)
:func:`reduce_scatter`  tiled along ``dim``     all-gather
:func:`grad_sum`    identity (a replicated      all-reduce (sum) of the
                    input)                      gradient over the group
:func:`mean`        all-reduce / size           gradient / size
:func:`psum`        all-reduce (sum) for a      the gradient as is
                    replicated consumer
:func:`ring_shift`  to the next ring rank       to the previous ring rank
:func:`to_zigzag`,  natural ↔ zigzag chunk      the reverse exchange
:func:`from_zigzag` layout over CP (All-to-All-V)
:func:`sp_to_moe`,  SP rows ↔ the MoE token     the reverse exchange
:func:`moe_to_sp`   shard (A2A-V over CP×TP,
                    or the stage)
==================  ==========================  ===========================

Serving's decode step adds collectives without a gradient: the LSE merge
of attention partials over CP (:func:`cp_merge`), the all-gathers of the
decode hand-off and the logits (:func:`gather_rows`), and sums over TP and
DP through :func:`all_reduce` under their own range names (the
vocabulary-parallel lookup, the output projection, the expert load).

Between pipeline stages, :class:`StageLink` sends point to point (not a
collective: only the two stages of a message take part).

The attention side adds Megatron's sequence parallelism (:func:`sp_gather`,
:func:`sp_scatter`: the all-gather and reduce-scatter along the sequence)
and the ring and zigzag exchanges of context parallelism.

**Axis order.** Every collective takes a logical axis, the ``AxisGroups``
of ``repro_torch.core.folding`` (or a bare ``ProcessGroup``, or ``None``).
A ``ProcessGroup`` orders its members by global rank; an axis orders them
row-major over its grid dimensions, which need not be ascending (a
non-contiguous MoE factorisation, or the stage axis under
``pod_role="cp"``, whose dims are dp, then the pod, then cp, then tp).
Here, in one place, each collective follows the axis order whatever the
group's: the all-gather puts the gathered chunks in axis order, the
reduce-scatter hands axis index i its chunk i, the All-to-All(-V) takes
and returns its chunks and split lists in axis order, and the ring shift
steps along the axis. On an ascending axis nothing is permuted, and the
collectives issued are those of the group as it is, byte for byte.

Each is an identity when the group is ``None`` or has one rank, so the
one-rank layer runs no collective. Buffers handed to the backend are
contiguous; splits are host lists of rows. :func:`all_to_all` can be issued
asynchronously: with ``pending`` (a list) it returns the output tensor at
once and appends the work handle, and the caller waits (:func:`wait`)
before reading the output. The backward collectives are synchronous.

The backends take the tensors where they lie: NCCL on the card, gloo on the
CPU or on the card (gloo stages CUDA tensors through the host itself, for
every collective used here, as a probe on an H100 with torch 2.11 showed).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.autograd import Function

from repro_torch.core.folding import moe_token_index
from repro_torch.roofline import trace_cost

Group = Optional[dist.ProcessGroup]


def _is_axis(ax) -> bool:
    return hasattr(ax, "ranks") and hasattr(ax, "group")


def _pg(ax) -> Group:
    """The ``ProcessGroup`` of an axis (``AxisGroups``), a group, or ``None``."""
    return ax.group if _is_axis(ax) else ax


def axis_order(ax) -> Optional[List[int]]:
    """The ProcessGroup rank of each axis index of ``ax``, or ``None`` where
    they are the same (an ascending axis, a bare group, no group)."""
    if not _is_axis(ax) or ax.group is None:
        return None
    ranks = sorted(ax.ranks)
    order = [ranks.index(r) for r in ax.ranks]
    return None if order == list(range(len(order))) else order


def size(ax) -> int:
    group = _pg(ax)
    return 1 if group is None else dist.get_world_size(group)


def wait(pending: List) -> None:
    """Complete every work handle an asynchronous call appended."""
    while pending:
        pending.pop(0).wait()


def _rows(splits: Optional[List[int]], n: int) -> int:
    return n if splits is None else int(sum(splits))


# Every collective issued here runs inside a ``record_function`` range named
# ``comm <collective>``: a profile of a step reads the host time spent in
# the collectives (with gloo, their staging through the host) from them,
# and without a profiler ``HOST_S`` sums the same host seconds by range
# (a caller clears it and reads it around the work it measures). Each also
# reports itself to an active ``roofline.trace_cost.Recorder`` (``_noted``:
# one ``None`` check when none is active), under the reference's op kind
# and its range's name.
HOST_S: Dict[str, float] = {}
_open: set = set()


@contextlib.contextmanager
def _range(name: str):
    """``record_function(name)``, its host seconds added to ``HOST_S[name]``;
    a range inside an open one of the same name adds nothing (the outer one
    holds its time)."""
    outer = name not in _open
    _open.add(name)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if outer:
            _open.discard(name)
            HOST_S[name] = HOST_S.get(name, 0.0) + time.perf_counter() - t0


def _noted(kind: str, name: str, out: torch.Tensor, group: Group,
           pairs: Sequence[Tuple[int, int]] = ()) -> None:
    if trace_cost.RECORDER is not None:
        trace_cost.note_collective(kind, name, out, group, pairs)


def _a2a(x: torch.Tensor, ax, in_splits, out_splits, async_op=False,
         name: str = "all_to_all", pairs: Sequence[Tuple[int, int]] = ()):
    """The All-to-All(-V) over ``ax`` with the chunks and split lists in axis
    order: on a permuted axis the input's chunks go to the group in its rank
    order and the output's come back in axis order (a copy each way). The
    reorder needs the output, so there the exchange completes before it
    returns, ``async_op`` or not, and the work handle is ``None``."""
    group, order = _pg(ax), axis_order(ax)
    x = x.contiguous()
    if order is not None:
        n = len(order)
        inv = sorted(range(n), key=order.__getitem__)       # axis index of group rank g
        ins = in_splits if in_splits is not None else [x.shape[0] // n] * n
        outs = out_splits if out_splits is not None else [x.shape[0] // n] * n
        parts = torch.split(x, list(ins))
        x = torch.cat([parts[a] for a in inv]).contiguous()
        in_splits, out_splits = [ins[a] for a in inv], [outs[a] for a in inv]
    out = x.new_empty((_rows(out_splits, x.shape[0]),) + tuple(x.shape[1:]))
    with _range(f"comm {name}"):
        _noted("collective-permute" if name == "ring_shift" else "all-to-all", name, out,
               group, pairs)
        work = dist.all_to_all_single(out, x, output_split_sizes=out_splits,
                                      input_split_sizes=in_splits, group=group,
                                      async_op=async_op)
    if order is None:
        return out, work
    if work is not None:
        work.wait()
    parts = torch.split(out, list(out_splits))
    return torch.cat([parts[g] for g in order]), None


def _gather0(x: torch.Tensor, ax, name: str = "all_gather") -> torch.Tensor:
    """Tiled all-gather along dim 0, chunks in ``ax``'s axis order."""
    group, order = _pg(ax), axis_order(ax)
    x = x.contiguous()
    out = x.new_empty((size(group) * x.shape[0],) + tuple(x.shape[1:]))
    with _range(f"comm {name}"):
        _noted("all-gather", name, out, group)
        dist.all_gather_into_tensor(out, x, group=group)
    if order is None:
        return out
    return out.view(len(order), *x.shape)[order].reshape(out.shape)


def _scatter0(x: torch.Tensor, ax) -> torch.Tensor:
    """Sum over ``ax``, then axis index i's chunk i along dim 0."""
    group, order = _pg(ax), axis_order(ax)
    x = x.contiguous()
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows not divisible by {n} ranks")
    if order is not None:     # group rank g takes the chunk of the axis index at g
        inv = sorted(range(n), key=order.__getitem__)
        x = x.view(n, -1, *x.shape[1:])[inv].reshape(x.shape)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    with _range("comm reduce_scatter"):
        _noted("reduce-scatter", "reduce_scatter", out, group)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_(x: torch.Tensor, ax, op=dist.ReduceOp.SUM,
                name: str = "all_reduce") -> torch.Tensor:
    """``x`` (contiguous) summed (or max) over the axis ``ax`` in place, in
    the ``comm <name>`` range, with no gradient; ``x`` as it is with no
    group."""
    group = _pg(ax)
    if group is None:
        return x
    with _range(f"comm {name}"):
        _noted("all-reduce", name, x, group)
        dist.all_reduce(x, op=op, group=group)
    return x


def _all_reduce(x: torch.Tensor, ax, op=dist.ReduceOp.SUM,
                name: str = "all_reduce") -> torch.Tensor:
    """A summed (or max) copy of ``x`` over the axis."""
    return all_reduce_(x.detach().clone().contiguous(), ax, op, name)


def _along(fn, x: torch.Tensor, ax, dim: int) -> torch.Tensor:
    """``fn`` (a dim-0 collective) applied along ``dim``."""
    if dim == 0:
        return fn(x, ax)
    return fn(x.movedim(dim, 0), ax).movedim(0, dim).contiguous()


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits, pending):
        ctx.group, ctx.in_splits, ctx.out_splits = group, in_splits, out_splits
        out, work = _a2a(x, group, in_splits, out_splits, async_op=pending is not None)
        if pending is not None and work is not None:
            pending.append(work)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, _ = _a2a(g, ctx.group, ctx.out_splits, ctx.in_splits)
        return dx, None, None, None, None


class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _along(_gather0, x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _along(_scatter0, g, ctx.group, ctx.dim), None, None


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _along(_scatter0, x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _along(_gather0, g, ctx.group, ctx.dim), None, None


class _GradSum(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Mean(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = size(group)
        return _all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_to_all(x: torch.Tensor, group, *, in_splits: Optional[List[int]] = None,
               out_splits: Optional[List[int]] = None,
               pending: Optional[List] = None) -> torch.Tensor:
    """All-to-All over dim 0 of the axis ``group``: equal blocks of rows, or
    the row counts ``in_splits`` (sent to each peer, in axis order) and
    ``out_splits`` (received from each) for All-to-All-V. Backward: the
    reverse exchange."""
    if size(group) == 1:
        return x
    return _AllToAll.apply(x, group, in_splits, out_splits, pending)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim`` in the axis order of ``group``.
    Backward: the reduce-scatter (sum) of the gradient."""
    if size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Sum over the group, then this rank's tile along ``dim``, in the
    input's dtype. Backward: the all-gather of the gradient."""
    if size(group) == 1:
        return x
    return _ReduceScatter.apply(x, group, dim)


def grad_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input (the router, the shared gate): identity forward,
    its gradient summed over ``group`` backward, as JAX transposes an
    unsharded ``shard_map`` input."""
    if size(group) == 1:
        return x
    return _GradSum.apply(x, group)


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmean``: the mean over the group; each rank's gradient is the
    (replicated) cotangent over the group size."""
    if size(group) == 1:
        return x
    return _Mean.apply(x, group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               name: str = "all_reduce") -> torch.Tensor:
    """``lax.psum`` (or ``pmax``) without a gradient, in the ``comm
    <name>`` range."""
    if size(group) == 1:
        return x
    return _all_reduce(x, group, op, name)


class _Psum(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, for a consumer that every rank of the group
    computes alike (Megatron's reduce in the forward): each rank
    back-propagates its own share, so the gradient passes as is."""
    if size(group) == 1:
        return x
    return _Psum.apply(x, group)


def sp_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Sequence parallelism → the tensor-parallel region: all-gather the
    sequence (dim 1) over TP. Backward: reduce-scatter."""
    return all_gather(x, group, 1)


def sp_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """TP partial sums → sequence parallelism: reduce-scatter the sequence
    (dim 1) over TP. Backward: all-gather."""
    return reduce_scatter(x, group, 1)


# ---------------------------------------------------------------------------
# Context parallelism: ring rotation and the zigzag layout exchange
# ---------------------------------------------------------------------------

def ring_shift_(x: torch.Tensor, ax, step: int = 1) -> torch.Tensor:
    """``x`` to the ring rank ``step`` ahead, ``x`` of the one ``step``
    behind back (``ppermute`` along the axis's order), with no gradient:
    an All-to-All-V in which each rank sends all its rows to one peer,
    because gloo takes CUDA tensors in its collectives, not in send/recv."""
    n = ax.size
    if n == 1 or step % n == 0:
        return x
    rows = x.shape[0]
    ins, outs = [0] * n, [0] * n
    ins[(ax.index + step) % n] = rows
    outs[(ax.index - step) % n] = rows
    pairs = [(ax.ranks[i], ax.ranks[(i + step) % n]) for i in range(n)]
    return _a2a(x, ax, ins, outs, name="ring_shift", pairs=pairs)[0]


class _RingShift(Function):
    @staticmethod
    def forward(ctx, x, ax, step):
        ctx.ax, ctx.step = ax, step
        return ring_shift_(x, ax, step)

    @staticmethod
    def backward(ctx, g):
        return ring_shift_(g, ctx.ax, -ctx.step), None, None


def ring_shift(x: torch.Tensor, ax, step: int = 1) -> torch.Tensor:
    """:func:`ring_shift_` with a gradient: the rotation back."""
    if ax.size == 1:
        return x
    return _RingShift.apply(x, ax, step)


def _exchange_halves(x: torch.Tensor, ax, dim: int, have: Sequence[int],
                     want: Sequence[int], dest, src) -> torch.Tensor:
    """Move equal sequence chunks between the ranks of a CP axis. This rank
    holds chunks ``have`` (in that order along ``dim``) and ends with
    chunks ``want``; ``dest(h)`` / ``src(h)`` are the axis indices that
    take chunk h / hold it now. One All-to-All-V (:func:`all_to_all`, so
    the backward is the reverse exchange); each peer's rows go in axis
    order, chunks in ascending id."""
    n = ax.size
    x = x.movedim(dim, 0)
    c = x.shape[0] // len(have)
    send = sorted(range(len(have)), key=lambda k: (dest(have[k]), have[k]))
    ins, outs = [0] * n, [0] * n
    for h in have:
        ins[dest(h)] += c
    for h in want:
        outs[src(h)] += c
    y = all_to_all(torch.cat([x[k * c:(k + 1) * c] for k in send]), ax,
                   in_splits=ins, out_splits=outs)
    recv = sorted(want, key=lambda h: (src(h), h))
    y = torch.cat([y[recv.index(h) * c:(recv.index(h) + 1) * c] for h in want])
    return y.movedim(0, dim).contiguous()


def _zigzag_owner(h: int, cp: int) -> int:
    """The ring rank that holds chunk h of 2·cp in the zigzag layout."""
    return h if h < cp else 2 * cp - 1 - h


def to_zigzag(x: torch.Tensor, ax, dim: int = 1) -> torch.Tensor:
    """Natural → load-balanced layout over the CP axis ``ax``: rank i holds
    the sequence chunk i of cp along ``dim`` (chunks 2i, 2i+1 of 2·cp) and
    gets chunks i and 2·cp − 1 − i (``core.folding.zigzag_chunks``)."""
    cp, i = ax.size, ax.index
    if cp == 1:
        return x
    return _exchange_halves(x, ax, dim, (2 * i, 2 * i + 1), (i, 2 * cp - 1 - i),
                            dest=lambda h: _zigzag_owner(h, cp), src=lambda h: h // 2)


def from_zigzag(x: torch.Tensor, ax, dim: int = 1) -> torch.Tensor:
    """The inverse of :func:`to_zigzag`."""
    cp, i = ax.size, ax.index
    if cp == 1:
        return x
    return _exchange_halves(x, ax, dim, (i, 2 * cp - 1 - i), (2 * i, 2 * i + 1),
                            dest=lambda h: h // 2, src=lambda h: _zigzag_owner(h, cp))


# ---------------------------------------------------------------------------
# The SP → MoE token hand-off
# ---------------------------------------------------------------------------

def handoff_plan(moe_of: Sequence[int], n: int, seqs: int, s: int
                 ) -> Tuple[List[int], List[int], List[int], List[int]]:
    """The hand-off's exchange for the rank at index ``s`` of a pipeline
    stage's ranks, in the attention ``stage`` axis order: (dp, cp, tp)
    row-major, which is the sequence-parallel index
    (``folding.sp_token_index``). ``n`` = cp·tp; each of the stage's dp = N
    / n DP ranks holds ``seqs`` sequences; ``moe_of[t]`` is the MoE token
    index (``moe["tokens"]``) of the rank at stage index t.

    Number the stage's blocks of L = S / n consecutive positions in the
    flattened (dp·seqs·S) token order: block ``q = b·n + i`` is positions
    ``[i·L, (i+1)·L)`` of the stage's sequence b. Sequence parallelism puts
    blocks ``b·n + i`` of its DP rank's sequences b (in b order) on stage
    index ``d·n + i``; the reference's MoE token shard at token index m is
    the run of blocks ``[m·seqs, (m+1)·seqs)``. Returns ``(send, ins,
    outs, arrived)``: this rank's SP blocks (their offsets among its
    ``seqs``) in the order it sends them, by destination then block; the
    blocks it sends to and receives from each stage index; and its run's
    blocks (offsets in the run) in the order they arrive, by source then
    block. The way back sends ``arrived`` and receives ``send``."""
    N = len(moe_of)
    owner = [0] * N
    for t, m in enumerate(moe_of):
        owner[m] = t
    d, i = divmod(s, n)
    mine = [(d * seqs + b) * n + i for b in range(seqs)]
    dest = [owner[q // seqs] for q in mine]
    send = sorted(range(seqs), key=lambda b: (dest[b], mine[b]))
    ins = [0] * N
    for t in dest:
        ins[t] += 1
    run = [moe_of[s] * seqs + k for k in range(seqs)]
    src = [(q // n // seqs) * n + q % n for q in run]
    arrived = sorted(range(seqs), key=lambda k: (src[k], run[k]))
    outs = [0] * N
    for t in src:
        outs[t] += 1
    return send, ins, outs, arrived


def _handoff_route(groups, seqs: int):
    """``(axis, send, ins, outs, arrived)`` of this rank's hand-off
    (:func:`handoff_plan`), with the split lists over ``axis``: ``None``
    where every rank's SP blocks are its MoE blocks (no exchange); the
    attention ``cp_tp`` axis where no block leaves its DP rank (on every
    ``_TABLE`` fold: the exchange among a DP rank's cp·tp ranks); else the
    whole ``stage``. Every rank decides alike, from the whole stage's plan."""
    st, ct = groups.attn["stage"], groups.attn["cp_tp"]
    n = ct.size
    moe_of = [moe_token_index(groups, r) for r in st.ranks]
    plans = [handoff_plan(moe_of, n, seqs, t) for t in range(st.size)]
    if all(p[1][t] == seqs for t, p in enumerate(plans)):
        return None, None, None, None, None
    send, ins, outs, arrived = plans[st.index]
    within = all(sum(p[1][(t // n) * n:(t // n + 1) * n]) == seqs
                 for t, p in enumerate(plans))
    if within:
        d = st.index // n
        return ct, send, ins[d * n:(d + 1) * n], outs[d * n:(d + 1) * n], arrived
    return st, send, ins, outs, arrived


def handoff_axis(groups, seqs: int) -> Optional[str]:
    """The attention axis over which :func:`sp_to_moe` exchanges at
    ``seqs`` sequences a DP rank: ``"cp_tp"``, ``"stage"``, or ``None``
    (the layouts coincide)."""
    ax = _handoff_route(groups, seqs)[0]
    return None if ax is None else ("cp_tp" if ax is groups.attn["cp_tp"] else "stage")


def _take(x: torch.Tensor, order: Sequence[int]) -> torch.Tensor:
    if list(order) == sorted(order):
        return x
    return x.index_select(0, torch.tensor(list(order), dtype=torch.long, device=x.device))


def _handoff(x: torch.Tensor, route, seqs: int, to_moe: bool) -> torch.Tensor:
    """The exchange of :func:`sp_to_moe` (``to_moe``) or :func:`moe_to_sp`
    on ``x`` (seqs·L, ...) rows along ``route`` (:func:`_handoff_route`),
    without a gradient."""
    ax, send, ins, outs, arrived = route
    blocks = x.reshape(seqs, x.shape[0] // seqs, *x.shape[1:])
    rows = blocks.shape[1]
    if not to_moe:
        send, arrived, ins, outs = arrived, send, outs, ins
    with _range("comm handoff"):
        y, _ = _a2a(_take(blocks, send).reshape(x.shape), ax, [c * rows for c in ins],
                    [c * rows for c in outs], name="handoff")
        y = _take(y.reshape(blocks.shape), sorted(range(seqs), key=arrived.__getitem__))
    return y.reshape(x.shape)


class _Handoff(Function):
    @staticmethod
    def forward(ctx, x, route, seqs, to_moe):
        ctx.route, ctx.seqs, ctx.to_moe = route, seqs, to_moe
        return _handoff(x, route, seqs, to_moe)

    @staticmethod
    def backward(ctx, g):
        return _handoff(g, ctx.route, ctx.seqs, not ctx.to_moe), None, None, None


def sp_to_moe(x: torch.Tensor, groups, seqs: int) -> torch.Tensor:
    """This rank's sequence-parallel rows → the reference's MoE token shard.

    ``x``: this rank's rows (seqs · S / n, ...) of its DP rank's ``seqs``
    sequences, sequence by sequence (the (B, S / n, D) activation
    flattened; n = cp·tp); ``groups``: the fold's ``FoldedGroups``. Returns
    the run of its pipeline stage's flattened (dp · seqs · S) tokens that
    the reference's MoE layer shards to this rank (``repro.core.moe_layer``:
    the (B·S) tokens over EDP×EP×ETP, at the rank's ``moe["tokens"]``
    index), with one All-to-All-V in the ``comm handoff`` range
    (:func:`handoff_plan`). Where the MoE token index is the attention (dp,
    cp, tp) index, every run lies in its own DP rank and the exchange is
    over the ``cp_tp`` axis; where it is not (``pod_role="cp"``,
    non-contiguous ``moe_factors``) tokens cross DP ranks and the exchange
    is over the ``stage`` axis. Where the two layouts coincide (one
    sequence a DP rank, or the sequence not cut, at equal indices) ``x`` is
    returned as is, with no exchange. Backward: :func:`moe_to_sp`."""
    route = _handoff_route(groups, seqs)
    if route[0] is None:
        return x
    return _Handoff.apply(x, route, seqs, True)


def moe_to_sp(y: torch.Tensor, groups, seqs: int) -> torch.Tensor:
    """The inverse of :func:`sp_to_moe`: the MoE layer's output on this
    rank's token shard back to its sequence-parallel rows. Backward:
    :func:`sp_to_moe`."""
    route = _handoff_route(groups, seqs)
    if route[0] is None:
        return y
    return _Handoff.apply(y, route, seqs, False)


# ---------------------------------------------------------------------------
# Serving: the decode step's collectives (no gradient)
# ---------------------------------------------------------------------------

def cp_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, ax
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSE merge of attention partials over the CP axis ``ax``: each
    rank holds ``(acc, m, l)`` of the same queries against its slice of the
    keys (``acc`` (..., hd) unnormalized, ``m``/``l`` (...) fp32). Returns
    the merged ``(acc, l)``, the same on every rank: the reference's
    ``pmax``/``psum`` combine (``repro.models.attention._cache_attend``).
    One all-gather of the packed partials (``comm cp_merge``), then every
    rank combines them in axis order. A partial that saw no key (``m`` the
    masked value, ``l = 0``) gets exactly zero weight."""
    if ax.size == 1:
        return acc, l
    packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1).float()
    parts = _gather0(packed[None], ax, "cp_merge")         # in axis order
    m_all = parts[..., -2]
    m_g = m_all.amax(dim=0)
    acc_out = l_out = None
    for r in range(ax.size):
        m_r = m_all[r]
        # m_r == m_g also covers a row no rank saw (an infinite m would
        # otherwise make NaN); for finite values the exponent is 0 there.
        scale = torch.where(m_r == m_g, torch.ones_like(m_r), torch.exp(m_r - m_g))
        a_r, l_r = parts[r][..., :-2] * scale[..., None], parts[r][..., -1] * scale
        acc_out = a_r if acc_out is None else acc_out + a_r
        l_out = l_r if l_out is None else l_out + l_r
    return acc_out, l_out


def gather_rows(x: torch.Tensor, group, name: str, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim`` in the axis order of ``group``, in the
    ``comm <name>`` range (the decode hand-off and the logits gather)."""
    if size(group) == 1:
        return x
    return _along(lambda t, g: _gather0(t, g, name), x, group, dim)


# ---------------------------------------------------------------------------
# Pipeline stages: point-to-point sends
# ---------------------------------------------------------------------------

class StageLink:
    """Point-to-point messages between the stages of a ``pp`` axis
    (``AxisGroups``; the stage is the index on it), each with its own tag
    (``core.pipeline.message_tag``), so that messages of several chunks
    between the same two stages stay apart.

    Not a collective over the group: two stages exchange a message when
    their schedules reach it, and no other stage takes part. A send is
    non-blocking (its buffer is kept until :meth:`wait_sends`); a receive
    blocks until its message is in. The transport follows the group's
    backend: gloo's send and recv take no CUDA tensor, so under gloo the
    payload goes through host memory (copied to the host before the send,
    to the device after the receive); NCCL takes the device tensor as it
    is. The calls run in the ``comm send`` and ``comm recv`` ranges."""

    def __init__(self, ax):
        if ax.group is None:
            raise ValueError("StageLink needs the pp axis's process group")
        self.ax = ax
        self.host = dist.get_backend(ax.group) == "gloo"
        self._sends: List = []

    def send(self, x: torch.Tensor, stage: int, tag: int) -> None:
        """Post ``x`` (no gradient) to ``stage`` under ``tag``."""
        buf = x.detach()
        with _range("comm send"):
            _noted("send", "send", buf, self.ax.group,
                   [(self.ax.ranks[self.ax.index], self.ax.ranks[stage])])
            if self.host and buf.device.type != "cpu":
                buf = buf.cpu()
            buf = buf.contiguous()
            work = dist.isend(buf, dst=self.ax.ranks[stage], group=self.ax.group, tag=tag)
        self._sends.append((work, buf))

    def recv(self, shape: Sequence[int], dtype: torch.dtype, device: torch.device,
             stage: int, tag: int) -> torch.Tensor:
        """The message of ``shape`` and ``dtype`` from ``stage`` under
        ``tag``, on ``device``."""
        with _range("comm recv"):
            buf = torch.empty(tuple(shape), dtype=dtype,
                              device="cpu" if self.host else device)
            _noted("collective-permute", "recv", buf, self.ax.group,
                   [(self.ax.ranks[stage], self.ax.ranks[self.ax.index])])
            dist.irecv(buf, src=self.ax.ranks[stage], group=self.ax.group, tag=tag).wait()
            return buf.to(device)

    def wait_sends(self) -> None:
        """Complete every posted send and release its buffer."""
        with _range("comm send"):
            while self._sends:
                self._sends.pop(0)[0].wait()
