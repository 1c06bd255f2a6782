"""The collectives of the data-parallel step, each usable under autograd.

A rank's loss is its share of the global loss (the shares sum to it), so
the backward of a collective carries the cotangents of every rank:

- :func:`all_reduce_sum`: the forward sums over ranks; the backward sums
  the cotangents over ranks, since every rank's share depends on the sum.
  Without a group of W > 1 ranks it is ``x`` itself (and
  :func:`num_ranks` is 1), so a batch sum over one process and over ranks
  is one code path;
- :func:`gather_rows`: the forward concatenates the ranks' rows in rank
  order (the unsharded order); the backward sums the full cotangent over
  ranks and keeps this rank's rows. A rank that computes the whole global
  loss from gathered rows must therefore contribute ``1/W`` of it, or its
  gradient comes out ``W`` times too large. The backward needs only
  ``all_reduce``, which gloo supports on CUDA tensors too (``torch.
  distributed.nn``'s gather takes an all-to-all there).

Both backwards are themselves these differentiable collectives, so a
``create_graph`` backward (DMT ``second_order``'s inner gradient through
the global BatchNorm sums) records them, and the double backward carries
the cross-rank part of the second-order term too.

:func:`sum_over_ranks` sums tensors over ranks in one flat bucket, under
autograd (DMT's meta and inner gradients), :func:`sum_gradients` the
``.grad`` of parameters through it, and :func:`mean_over_ranks` averages
scalars (the step's metrics) in one all-reduce.
"""
from __future__ import annotations

import typing as t

import torch
import torch.distributed as dist

from .mesh import DataGroup, multi_rank

__all__ = ["all_reduce_sum", "num_ranks", "gather_rows", "sum_over_ranks", "sum_gradients",
           "mean_over_ranks"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group.process_group)
        return out

    @staticmethod
    def backward(ctx, g):
        # the sum is self-adjoint; through the Function, so that a
        # create_graph backward records it
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: t.Optional[DataGroup]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; ``x`` without a group
    of W > 1 ranks."""
    return x if multi_rank(group) is None else _AllReduceSum.apply(x, group)


def num_ranks(group: t.Optional[DataGroup]) -> int:
    """W, the number of ranks of ``group`` (1 without one)."""
    return 1 if group is None else group.size


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x, group=group.process_group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        g = _AllReduceSum.apply(g, ctx.group)
        return g.narrow(0, ctx.group.rank * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] (the same n on each) -> [W*n, ...] in rank
    order; integer tensors too (no gradient)."""
    return _GatherRows.apply(x, group)


def sum_over_ranks(tensors: t.Sequence[torch.Tensor], group: t.Optional[DataGroup]) -> tuple:
    """Each of ``tensors`` summed over the ranks of ``group``, through one
    flat all-reduce (differentiable, twice: a ``create_graph`` gradient
    keeps its graph); ``tensors`` as they are without a group of W > 1
    ranks."""
    if multi_rank(group) is None or not tensors:
        return tuple(tensors)
    flat = _AllReduceSum.apply(torch.cat([x.reshape(-1) for x in tensors]), group)
    return tuple(f.view_as(x) for f, x in zip(flat.split([x.numel() for x in tensors]), tensors))


@torch.no_grad()
def sum_gradients(params: t.Iterable[torch.Tensor], group: DataGroup) -> None:
    """Sum the ``.grad`` of ``params`` over ranks, in place, through one
    flat bucket (parameters without a gradient, the same on every rank,
    are left out)."""
    grads = [p.grad for p in params if p.grad is not None]
    for g, total in zip(grads, sum_over_ranks(grads, group)):
        g.copy_(total)


@torch.no_grad()
def mean_over_ranks(values: t.Mapping[str, torch.Tensor], group: DataGroup) -> dict:
    """The mean over ranks of each scalar of ``values``, in one all-reduce;
    a tensor of more than one element (a hook's ``fig/`` matrix, computed
    over the global batch already) is kept as it is."""
    keys = [k for k, v in values.items() if v.numel() == 1]
    out = {k: v for k, v in values.items() if v.numel() != 1}
    if not keys:
        return out
    stacked = torch.stack([values[k].float().reshape(()) for k in keys])
    dist.all_reduce(stacked, group=group.process_group)
    stacked /= group.size
    return {**{k: stacked[i] for i, k in enumerate(keys)}, **out}
