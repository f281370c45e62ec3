"""dispatch / undispatch: move tensors between the global layout and a cp
rank's shard.

The port's counterpart of the JAX package's ``parallel/dispatch.py``, with
the original MagiAttention's PyTorch API: every rank holds the global
tensor; :func:`dispatch` returns this rank's chunks (a permutation, no
communication; its backward all-gathers the shards' gradients, so that
each rank holds the whole gradient of the replicated input), and
:func:`undispatch` all-gathers the shards and un-permutes them (its
backward takes this rank's rows). The token axis is axis 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..comm.primitives import all_gather_v
from ..meta.dispatch_meta import DispatchMeta


def _perm(meta: DispatchMeta, rank: int, device) -> torch.Tensor:
    """This rank's slice of ``meta.perm_idx`` (pad slots of an uneven shard
    carry the sentinel ``total_seqlen``)."""
    shard = meta.shard_seqlen
    return torch.from_numpy(meta.perm_idx[rank * shard : (rank + 1) * shard].astype(np.int64)).to(device)


def _take_rows(x: torch.Tensor, perm: torch.Tensor, total: int, pad_value=0) -> torch.Tensor:
    """``x[perm]`` along axis 0, ``pad_value`` where perm holds the sentinel."""
    valid = perm < total
    out = x.index_select(0, torch.where(valid, perm, 0))
    if not bool(valid.all()):
        shape = (-1,) + (1,) * (x.dim() - 1)
        out = torch.where(valid.view(shape), out, torch.full_like(out, pad_value))
    return out


def _gather_global(y: torch.Tensor, meta: DispatchMeta, group) -> torch.Tensor:
    """Every rank's shard [shard, ...] -> the global [total, ...] in natural order."""
    flat = all_gather_v(y, [meta.shard_seqlen] * meta.cp_size, group)
    unperm = torch.from_numpy(meta.unperm_idx.astype(np.int64)).to(y.device)
    return flat.index_select(0, unperm)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, meta: DispatchMeta, group, pad_value):
        ctx.meta, ctx.group = meta, group
        perm = _perm(meta, dist.get_rank(group), x.device)
        return _take_rows(x, perm, meta.total_seqlen, pad_value)

    @staticmethod
    def backward(ctx, g):
        return _gather_global(g.contiguous(), ctx.meta, ctx.group), None, None, None


class _Undispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, meta: DispatchMeta, group):
        ctx.meta, ctx.group = meta, group
        return _gather_global(y.contiguous(), meta, group)

    @staticmethod
    def backward(ctx, g):
        meta = ctx.meta
        perm = _perm(meta, dist.get_rank(ctx.group), g.device)
        return _take_rows(g, perm, meta.total_seqlen), None, None


def dispatch(x: torch.Tensor, meta: DispatchMeta, group, pad_value=0) -> torch.Tensor:
    """This rank's dispatched shard [shard_seqlen, ...] of the global
    ``x`` [total_seqlen, ...] that every rank holds (pad slots of an uneven
    shard take ``pad_value``)."""
    return _Dispatch.apply(x, meta, group, pad_value)


def undispatch(y: torch.Tensor, meta: DispatchMeta, group) -> torch.Tensor:
    """Inverse of :func:`dispatch`: every rank's shard gathered back into
    the global natural order [total_seqlen, ...], on every rank."""
    return _Undispatch.apply(y, meta, group)


def position_ids(meta: DispatchMeta, rank: int) -> np.ndarray:
    """Global position of each of ``rank``'s dispatched slots [shard_seqlen]
    (int32; pad slots of an uneven shard read 0, their values are never
    used): RoPE's positions."""
    perm = meta.perm_idx
    if meta.is_uneven:
        perm = np.where(perm < meta.total_seqlen, perm, 0).astype(np.int32)
    shard = meta.shard_seqlen
    return perm[rank * shard : (rank + 1) * shard]
