"""Simple collectives: variable-size gather, scatter and all-to-all over a
``torch.distributed`` process group.

The port's counterpart of the JAX package's ``comm/primitives.py``. With
static per-rank sizes (host-known, like all routing here), variable splits
are realized by padding to the max size, the same convention as
``GroupCollectiveMeta``. They take CUDA tensors on NCCL and on gloo
(whose all-gather and all-to-all copy them through the host themselves).
The all-gather and the all-reduce record themselves under
``group_collective.record_collectives`` (``all_gather``, ``psum``).

Beside them, the differentiable collectives of the trainer's parallel
layouts and of the cp baselines, each the torch form of a JAX collective
whose transpose autodiff derives: Megatron's tensor-parallel pair
(:func:`replicated` on a column-parallel product's input,
:func:`reduce_over_group` on a row-parallel product's output), the ring
shift (``lax.ppermute``; its backward the reverse shift), the tiled
all-gather (its backward the sum over the ranks, then this rank's slice)
and the tiled seq <-> heads all-to-all of Ulysses (each the other's
backward). They go through the same recorder, under the JAX census's
names (``psum``, ``ppermute``, ``all_gather``, ``all_to_all``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import group_collective as _gc
from .group_collective import all_to_all_rows, exchange, group_rank, group_size


def all_gather_v(x: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    """Concatenate every rank's valid rows in rank order: ``x`` [pad, ...]
    is this rank's rows padded to max(sizes); returns [sum(sizes), ...]."""
    sizes = [int(s) for s in sizes]
    pad = max(sizes)
    if x.shape[0] != pad:
        raise ValueError(f"x must be padded to {pad} rows, got {x.shape[0]}")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in sizes]
    if _gc.recording() and _gc.record_collective("all_gather", group, x):
        parts = [torch.zeros_like(x) for _ in sizes]
    else:
        dist.all_gather(parts, x, group=group)  # gloo copies CUDA tensors through the host
    return torch.cat([p[:s] for p, s in zip(parts, sizes)], dim=0)


def scatter_v(x_global: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    """This rank's slice of the concatenation ``x_global`` [sum(sizes),
    ...], which every rank holds, padded with zeros to max(sizes): a local
    slice, no communication."""
    sizes = [int(s) for s in sizes]
    if x_global.shape[0] != sum(sizes):
        raise ValueError(f"x_global has {x_global.shape[0]} rows, expected {sum(sizes)}")
    rank = dist.get_rank(group)
    start = int(np.sum(sizes[:rank]))
    out = x_global.new_zeros((max(sizes),) + tuple(x_global.shape[1:]))
    out[: sizes[rank]] = x_global[start : start + sizes[rank]]
    return out


def all2all_v(x: torch.Tensor, send_sizes: Sequence[Sequence[int]], group) -> torch.Tensor:
    """Variable all-to-all: ``x`` [cp, pad, ...] holds the rows for each
    destination padded to the max send size; block ``s`` of the returned
    [cp, pad, ...] buffer holds the ``send_sizes[s][my_rank]`` valid rows
    rank s sent here, the rest padding."""
    cp = len(send_sizes)
    if x.shape[0] != cp:
        raise ValueError(f"x leading dim {x.shape[0]} != world {cp}")
    pad = max(max(int(v) for v in row) for row in send_sizes)
    if x.shape[1] < pad:
        raise ValueError(f"x per-dst rows {x.shape[1]} < max send size {pad}")
    return all_to_all_rows(x, group)


class _SumGradOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if _gc.recording() and _gc.record_collective("psum", ctx.group, g):
            return torch.zeros_like(g), None
        dist.all_reduce(g, group=ctx.group)
        return g, None


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged, with its gradient summed over ``group`` in the
    backward: the mark of a tensor every rank holds the same copy of (a
    sink), whose gradient is the sum of the ranks' contributions (what
    ``shard_map``'s transpose does for a replicated input in the JAX
    package)."""
    return _SumGradOverGroup.apply(x, group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of ``x`` over ``group``, recorded as ``psum`` (zeros
    under a dry recording)."""
    y = x.contiguous().clone()
    if _gc.recording() and _gc.record_collective("psum", group, y):
        return torch.zeros_like(y)
    dist.all_reduce(y, group=group)
    return y


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (an all-reduce), with the identity
    as its backward: the epilogue of a row-parallel product, whose partial
    sums every tensor-parallel rank completes (the JAX model's
    ``lax.psum`` after ``wo`` and ``w_down``). Its partner on the
    column-parallel input is :func:`replicated`."""
    return _SumOverGroup.apply(x, group)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        n, me = group_size(group), group_rank(group)
        ctx.group, ctx.peers = group, ((me - shift) % n, (me + shift) % n)
        return exchange(x, (me + shift) % n, (me - shift) % n, group)

    @staticmethod
    def backward(ctx, g):
        to_rank, from_rank = ctx.peers
        return exchange(g, to_rank, from_rank, ctx.group), None, None


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to group rank + ``shift`` and return what rank - ``shift``
    sent (``lax.ppermute`` over ``[(i, (i + shift) % n)]``): one
    ``exchange``. Its backward sends the gradient the other way round. Every
    rank of the group calls it, in the same order."""
    return _RingShift.apply(x, group, int(shift))


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = group_size(group)
        ctx.group, ctx.rows, ctx.rank = group, x.shape[0], group_rank(group)
        return all_gather_v(x, [x.shape[0]] * n, group)

    @staticmethod
    def backward(ctx, g):
        # gloo has no reduce-scatter: the sum over the ranks, then this rank's rows
        g = _all_reduce(g, ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [rows, ...] concatenated in rank order, [n * rows,
    ...] (``lax.all_gather(..., tiled=True)``). Its backward sums the
    gradient over the ranks and keeps this rank's rows."""
    return _AllGatherTiled.apply(x, group)


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    t, h = x.shape[0], x.shape[1]
    if h % n:
        raise ValueError(f"{h} heads do not split over {n} ranks")
    send = x.reshape(t, n, h // n, *x.shape[2:]).transpose(0, 1)  # block j -> rank j
    recv = all_to_all_rows(send, group)  # block i: rank i's tokens, my heads
    return recv.reshape(n * t, h // n, *x.shape[2:])


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    t, hh = x.shape[0] // n, x.shape[1]
    recv = all_to_all_rows(x.reshape(n, t, hh, *x.shape[2:]), group)  # block i: heads of rank i
    return recv.transpose(0, 1).reshape(t, n * hh, *x.shape[2:])


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[t, h, ...] sharded on tokens -> [n * t, h / n, ...] sharded on heads:
    rank j gets head block j of every rank's tokens, in rank order (the
    tiled ``lax.all_to_all(split_axis=1, concat_axis=0)`` of Ulysses). Its
    backward is :func:`heads_to_seq`."""
    return _SeqToHeads.apply(x, group)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`: [n * t, h / n, ...] -> [t, h,
    ...]; its backward is :func:`seq_to_heads`."""
    return _HeadsToSeq.apply(x, group)
