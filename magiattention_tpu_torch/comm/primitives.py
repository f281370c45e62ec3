"""Simple collectives: variable-size gather, scatter and all-to-all over a
``torch.distributed`` process group.

The port's counterpart of the JAX package's ``comm/primitives.py``. With
static per-rank sizes (host-known, like all routing here), variable splits
are realized by padding to the max size, the same convention as
``GroupCollectiveMeta``. They take CUDA tensors on NCCL and on gloo
(whose all-gather and all-to-all copy them through the host themselves).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .group_collective import all_to_all_rows


def all_gather_v(x: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    """Concatenate every rank's valid rows in rank order: ``x`` [pad, ...]
    is this rank's rows padded to max(sizes); returns [sum(sizes), ...]."""
    sizes = [int(s) for s in sizes]
    pad = max(sizes)
    if x.shape[0] != pad:
        raise ValueError(f"x must be padded to {pad} rows, got {x.shape[0]}")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in sizes]
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
        dist.all_reduce(g, group=ctx.group)
        return g, None


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged, with its gradient summed over ``group`` in the
    backward: the mark of a tensor every rank holds the same copy of (a
    sink), whose gradient is the sum of the ranks' contributions (what
    ``shard_map``'s transpose does for a replicated input in the JAX
    package)."""
    return _SumGradOverGroup.apply(x, group)
