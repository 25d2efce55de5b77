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
==================  ==========================  ===========================

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

from typing import List, Optional

import torch
import torch.distributed as dist
from torch.autograd import Function

Group = Optional[dist.ProcessGroup]


def size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def wait(pending: List) -> None:
    """Complete every work handle an asynchronous call appended."""
    while pending:
        pending.pop(0).wait()


def _rows(splits: Optional[List[int]], n: int) -> int:
    return n if splits is None else int(sum(splits))


def _a2a(x: torch.Tensor, group: Group, in_splits, out_splits, async_op=False):
    x = x.contiguous()
    out = x.new_empty((_rows(out_splits, x.shape[0]),) + tuple(x.shape[1:]))
    work = dist.all_to_all_single(out, x, output_split_sizes=out_splits,
                                  input_split_sizes=in_splits, group=group,
                                  async_op=async_op)
    return out, work


def _gather0(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter0(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows not divisible by {n} ranks")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _along(fn, x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """``fn`` (a dim-0 collective) applied along ``dim``."""
    if dim == 0:
        return fn(x, group)
    return fn(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits, pending):
        ctx.group, ctx.in_splits, ctx.out_splits = group, in_splits, out_splits
        out, work = _a2a(x, group, in_splits, out_splits, async_op=pending is not None)
        if pending is not None:
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
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _Mean(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = size(group)
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_to_all(x: torch.Tensor, group: Group, *, in_splits: Optional[List[int]] = None,
               out_splits: Optional[List[int]] = None,
               pending: Optional[List] = None) -> torch.Tensor:
    """All-to-All over dim 0: equal blocks of rows, or the row counts
    ``in_splits`` (sent to each peer) and ``out_splits`` (received from
    each) for All-to-All-V. Backward: the reverse exchange."""
    if size(group) == 1:
        return x
    return _AllToAll.apply(x, group, in_splits, out_splits, pending)


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim`` in group-rank order. Backward: the
    reduce-scatter (sum) of the gradient."""
    if size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Sum over the group, then this rank's tile along ``dim``, in the
    input's dtype. Backward: the all-gather of the gradient."""
    if size(group) == 1:
        return x
    return _ReduceScatter.apply(x, group, dim)


def grad_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """A replicated input (the router, the shared gate): identity forward,
    its gradient summed over ``group`` backward, as JAX transposes an
    unsharded ``shard_map`` input."""
    if size(group) == 1:
        return x
    return _GradSum.apply(x, group)


def mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.pmean``: the mean over the group; each rank's gradient is the
    (replicated) cotangent over the group size."""
    if size(group) == 1:
        return x
    return _Mean.apply(x, group)


def all_reduce(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``lax.psum`` (or ``pmax``) of a statistic, without a gradient."""
    if size(group) == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out
