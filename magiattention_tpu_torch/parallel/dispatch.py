"""dispatch / undispatch: move tensors between the global layout and a cp
rank's shard.

The port's counterpart of the JAX package's ``parallel/dispatch.py``, with
the original MagiAttention's PyTorch API: every rank holds the global
tensor; :func:`dispatch` returns this rank's chunks (a permutation, no
communication; its backward all-gathers the shards' gradients, so that
each rank holds the whole gradient of the replicated input), and
:func:`undispatch` all-gathers the shards and un-permutes them (its
backward takes this rank's rows). The token axis is axis 0.

:func:`roll` shifts a dispatched tensor along the global sequence (the
labels of multi-token prediction): a local gather for the rows that stay
on their rank, and one ``GroupCast`` of the rank-crossing rows, so that
its gradient takes the reverse route.

The padded-index adapters (:func:`padded_dispatch_indices`,
:func:`padded_undispatch_indices`, :func:`padded_position_ids`, host numpy
byte-identical to the JAX package's) map a request's real rows onto a
canonical (bucket-padded) plan's dispatch layout; :class:`PaddedDispatch`
holds them on the device for one rank and moves tensors through them,
with no host sync per call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..comm.group_collective import GroupCast, GroupCollectiveMeta, rank_routing
from ..utils.instrument import named_scope
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


def padded_dispatch_indices(meta: DispatchMeta, canon_to_real: np.ndarray,
                            real_total: int) -> np.ndarray:
    """The gather of a bucketed plan's dispatch: ``dispatched[slot] =
    x[idx[slot]]`` maps a request's real rows straight into the canonical
    plan's dispatch layout [cp * shard]. Bucket pad rows, the canonical
    chunk pad and the pad slots of an uneven shard all carry the sentinel
    ``real_total`` (they take the pad value). ``canon_to_real`` maps
    canonical global positions to real ones (-1 on pad rows)."""
    if canon_to_real.shape[0] > meta.total_seqlen:
        raise ValueError(f"canon_to_real has {canon_to_real.shape[0]} rows but the canonical "
                         f"dispatch meta covers total_seqlen={meta.total_seqlen}")
    perm = meta.perm_idx.astype(np.int64)  # the sentinel total_seqlen on pad slots
    c2r = np.full(meta.total_seqlen + 1, -1, np.int64)
    c2r[: canon_to_real.shape[0]] = canon_to_real
    src = c2r[np.minimum(perm, meta.total_seqlen)]
    return np.where(src >= 0, src, real_total).astype(np.int32)


def padded_undispatch_indices(meta: DispatchMeta, real_to_canon: np.ndarray) -> np.ndarray:
    """The inverse of :func:`padded_dispatch_indices`: ``x[t] =
    dispatched[idx[t]]`` for every real row ``t`` (pad slots are never
    read back)."""
    bad = (real_to_canon < 0) | (real_to_canon >= meta.total_seqlen)
    if bad.any():
        t = int(np.flatnonzero(bad)[0])
        raise ValueError(f"real_to_canon[{t}]={int(real_to_canon[t])} is outside the canonical "
                         f"sequence [0, {meta.total_seqlen}): row maps and dispatch meta disagree")
    unperm = meta.unperm_idx.astype(np.int64)
    return unperm[real_to_canon.astype(np.int64)].astype(np.int32)


def padded_position_ids(meta: DispatchMeta, canon_to_real: np.ndarray) -> np.ndarray:
    """The real global position of each canonical dispatched slot (pad
    slots read 0, as in :func:`position_ids`; their values are never
    used)."""
    perm = meta.perm_idx.astype(np.int64)
    c2r = np.full(meta.total_seqlen + 1, -1, np.int64)
    c2r[: canon_to_real.shape[0]] = canon_to_real
    src = c2r[np.minimum(perm, meta.total_seqlen)]
    return np.where(src >= 0, src, 0).astype(np.int32)


class PaddedDispatch:
    """One rank's view of the three padded-index tables, on its device
    (built once): ``src`` / ``valid`` are this rank's [rank * shard,
    (rank + 1) * shard) slice of the dispatch gather (the sentinel slots
    invalid), ``undispatch`` the slot of every real row in the gathered
    [cp * shard] layout, ``position_ids`` this rank's slice of the
    position table. :meth:`dispatch` and :meth:`undispatch` are each
    other's transposes, as the exact path's are."""

    def __init__(self, dispatch_idx: np.ndarray, undispatch_idx: np.ndarray,
                 position_ids: np.ndarray, real_total: int, shard: int, rank: int, device):
        local = dispatch_idx[rank * shard : (rank + 1) * shard].astype(np.int64)
        valid = local < real_total
        self.real_total, self.shard = int(real_total), int(shard)
        self.cp = dispatch_idx.shape[0] // shard
        self.src = torch.from_numpy(np.where(valid, local, 0)).to(device)
        self.valid = torch.from_numpy(valid).to(device)
        self.undispatch_idx = torch.from_numpy(undispatch_idx.astype(np.int64)).to(device)
        self.position_ids = torch.from_numpy(
            position_ids[rank * shard : (rank + 1) * shard].astype(np.int64)).to(device)

    def take(self, x: torch.Tensor, pad_value=0) -> torch.Tensor:
        """This rank's canonical shard of the real ``x`` [real_total, ...]."""
        if x.shape[0] != self.real_total:
            raise ValueError(f"a bucketed key dispatches the request's {self.real_total} real "
                             f"rows, got {x.shape[0]}")
        out = x.index_select(0, self.src)
        return out.masked_fill(~self.valid.view((-1,) + (1,) * (x.dim() - 1)), pad_value)

    def gather(self, y: torch.Tensor, group) -> torch.Tensor:
        """Every rank's canonical shard -> the real rows [real_total, ...]."""
        flat = all_gather_v(y.contiguous(), [self.shard] * self.cp, group)
        return flat.index_select(0, self.undispatch_idx)

    def dispatch(self, x: torch.Tensor, group, pad_value=0) -> torch.Tensor:
        return _PaddedDispatch.apply(x, self, group, pad_value)

    def undispatch(self, y: torch.Tensor, group) -> torch.Tensor:
        return _PaddedUndispatch.apply(y, self, group)


class _PaddedDispatch(torch.autograd.Function):
    """Its backward all-gathers the cotangent shards and takes each real
    row's slot: the scatter-add of the gather, since each real row has one
    slot; the pad slots' cotangents are dropped."""

    @staticmethod
    def forward(ctx, x, tables: PaddedDispatch, group, pad_value):
        ctx.tables, ctx.group = tables, group
        return tables.take(x, pad_value)

    @staticmethod
    def backward(ctx, g):
        return ctx.tables.gather(g, ctx.group), None, None, None


class _PaddedUndispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tables: PaddedDispatch, group):
        ctx.tables = tables
        return tables.gather(y, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.tables.take(g, 0), None, None


def _roll_src_slots(meta: DispatchMeta, shift: int) -> np.ndarray:
    """Dispatch-space source slot feeding every output slot of a global
    roll by ``shift``; pad slots source themselves (keep their value)."""
    perm = meta.perm_idx.astype(np.int64)
    unperm = meta.unperm_idx.astype(np.int64)
    total = meta.total_seqlen
    slots = np.arange(perm.shape[0], dtype=np.int64)
    valid = perm < total
    src_global = (np.where(valid, perm, 0) - shift) % total
    return np.where(valid, unperm[src_global], slots)


@functools.lru_cache(maxsize=64)
def roll_plan(meta: DispatchMeta, shift: int):
    """The host plan of a roll by ``shift``: (per rank, the local source
    row of each of its slots, 0 where the row comes from another rank;
    per rank, its slots filled from other ranks, in receive order; the
    ``GroupCollectiveMeta`` of the rank-crossing rows). Sender and receiver
    order each (src, dst) pair's rows by destination slot, so the receive
    order at rank d is (src rank asc, destination slot asc). Cached per
(meta, shift)."""
    cp, shard = meta.cp_size, meta.shard_seqlen
    src_slot = _roll_src_slots(meta, shift)
    slots = np.arange(cp * shard, dtype=np.int64)
    src_rank, dst_rank = src_slot // shard, slots // shard
    local = src_rank == dst_rank
    local_src = np.where(local, src_slot % shard, 0).reshape(cp, shard)
    send_map = [[np.empty(0, np.int64) for _ in range(cp)] for _ in range(cp)]
    recv_slots = []
    for d in range(cp):
        parts = []
        for s in range(cp):
            if s == d:
                continue
            sel = np.flatnonzero(~local & (dst_rank == d) & (src_rank == s))  # slot order
            send_map[s][d] = src_slot[sel] % shard
            parts.append(sel % shard)
        recv_slots.append(np.concatenate(parts) if parts else np.empty(0, np.int64))
    comm = GroupCollectiveMeta.build(send_map, [shard] * cp)
    return local_src, recv_slots, comm


def roll(x: torch.Tensor, meta: DispatchMeta, shift: int, group, axis: int = 0) -> torch.Tensor:
    """Distributed roll along the *global* sequence of this rank's
    dispatched shard ``x``: in global order y[i] = x[(i - shift) mod
    total], computed in dispatch space. Rows that stay on their rank are a
    local gather; only the rank-crossing rows move, in one ``GroupCast``
    (its backward sends their gradient home). Pad slots of an uneven shard
    keep their own value."""
    local_src, recv_slots, comm = roll_plan(meta, int(shift))
    rank = dist.get_rank(group)
    xm = x.movedim(axis, 0)
    dev = x.device
    out = xm.index_select(0, torch.from_numpy(local_src[rank]).to(dev))
    if sum(comm.send_total):  # the same on every rank: all join the cast or none
        rt = rank_routing(comm, rank, meta.shard_seqlen, str(dev))
        with named_scope("magi_roll_a2a"):
            recv = GroupCast.apply(xm.contiguous(), rt, group)
        n = len(recv_slots[rank])
        if n:
            out = out.index_copy(0, torch.from_numpy(recv_slots[rank]).to(dev), recv[:n])
    return out.movedim(0, axis)
