"""Megatron-style hybrid cp (zigzag all-gather) baseline.

The counterpart of the JAX package's ``parallel/baselines/hybrid_dcp.py``
(reference ``exps/dist_attn/baselines/hybrid_dcp.py``): the sequence is cut
into ``2 cp`` chunks and rank r owns the zigzag pair (r, 2 cp - 1 - r),
which evens out the causal area across the ranks; K/V are all-gathered
(``comm.all_gather_tiled``: one collective, no ring; its backward the sum
over the ranks and this rank's rows), and each rank attends its two chunks
against the whole gathered K/V in one kernel call. The per-rank tables
describe the local Q pair and the gathered buffer as runs in global
coordinates, so any flex mask works.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...comm.group_collective import group_rank, group_size
from ...comm.primitives import all_gather_tiled
from ...ops.block_meta import Run, build_block_meta_general
from ...ops.flex_attn import FlexAttnParams, flex_attn_headmajor
from ..dist_attn import StageTables, _hm, _kv_buffer, _rank_kernel_tables, _round_up, _seq
from .ring import _check_params, _tile


def zigzag_chunks(cp_size: int) -> list[tuple[int, int]]:
    """The chunk pair each rank owns."""
    return [(r, 2 * cp_size - 1 - r) for r in range(cp_size)]


def zigzag_perm(total: int, cp_size: int) -> np.ndarray:
    """Gather indices: ``zigzag_dispatched[i] = x[perm[i]]``."""
    ch = total // (2 * cp_size)
    parts = []
    for a, b in zigzag_chunks(cp_size):
        parts.append(np.arange(a * ch, (a + 1) * ch))
        parts.append(np.arange(b * ch, (b + 1) * ch))
    return np.concatenate(parts).astype(np.int32)


def zigzag_dispatch(x: torch.Tensor, total: int, cp_size: int, axis: int = 0) -> torch.Tensor:
    """``x`` in zigzag order along ``axis`` (rank r's shard is rows
    ``[r shard, (r+1) shard)`` of the result)."""
    idx = torch.from_numpy(zigzag_perm(total, cp_size).astype(np.int64)).to(x.device)
    return torch.index_select(x, axis, idx)


def zigzag_undispatch(y: torch.Tensor, total: int, cp_size: int, axis: int = 0) -> torch.Tensor:
    """The inverse of :func:`zigzag_dispatch`."""
    perm = zigzag_perm(total, cp_size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(total, dtype=np.int32)
    return torch.index_select(y, axis, torch.from_numpy(inv.astype(np.int64)).to(y.device))


@dataclasses.dataclass(frozen=True, eq=False)
class HybridDcpPlan:
    cp_size: int
    shard_len: int  # 2 * chunk rows per rank
    shard_q_pad: int
    kv_pad: int  # the gathered buffer's padded length
    block_q: int
    block_k: int
    tables: StageTables


def build_hybrid_dcp_plan(slices: np.ndarray, total_seqlen: int, cp_size: int, *,
                          block_q: int | None = None, block_k: int | None = None,
                          head_dim: int = 128) -> HybridDcpPlan:
    """The JAX builder, byte for byte at the same tile."""
    block_q, block_k = _tile(head_dim, block_q, block_k)
    if total_seqlen % (2 * cp_size):
        raise ValueError(f"total {total_seqlen} must divide into 2*cp={2 * cp_size} chunks")
    slices = np.asarray(slices, dtype=np.int64)
    ch = total_seqlen // (2 * cp_size)
    shard = 2 * ch
    shard_q_pad = _round_up(shard, block_q)
    kv_pad = _round_up(total_seqlen, block_k)
    k_runs, pos = [], 0  # the gathered K/V: rank-major zigzag pairs
    for a, b in zigzag_chunks(cp_size):
        k_runs += [Run(local_start=pos, global_start=a * ch, length=ch),
                   Run(local_start=pos + ch, global_start=b * ch, length=ch)]
        pos += shard
    metas = []
    for a, b in zigzag_chunks(cp_size):
        q_runs = [Run(local_start=0, global_start=a * ch, length=ch),
                  Run(local_start=ch, global_start=b * ch, length=ch)]
        metas.append(build_block_meta_general(slices, q_runs, k_runs, shard_q_pad, kv_pad,
                                              block_q=block_q, block_k=block_k))
    return HybridDcpPlan(cp_size=cp_size, shard_len=shard, shard_q_pad=shard_q_pad,
                         kv_pad=kv_pad, block_q=block_q, block_k=block_k,
                         tables=StageTables.from_rank_metas(metas, kv_pad))


@functools.lru_cache(maxsize=64)
def _tables(plan: HybridDcpPlan, rank: int, device: str) -> tuple:
    return _rank_kernel_tables(plan.tables, rank, plan.shard_q_pad, plan.block_q, plan.block_k,
                               device)


def hybrid_dcp_attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          plan: HybridDcpPlan, params: FlexAttnParams, group):
    """This rank's zigzag shards -> (out, lse): all-gather the K/V, one
    kernel call over the gathered buffer."""
    _check_params(params, "hybrid-dcp")
    ftab, btab, kv_pad = _tables(plan, group_rank(group), str(q.device))
    kvg = all_gather_tiled(torch.stack([k, v], dim=1), group)  # [total, 2, hk, d]
    buf = _kv_buffer((kvg,), kv_pad, k)
    out_h, lse_h, _ = flex_attn_headmajor(_hm(q, plan.shard_q_pad), buf[0], buf[1], ftab, btab,
                                          params)
    return _seq(out_h, lse_h, plan.shard_len)


def make_hybrid_dcp_attn_fn(plan: HybridDcpPlan, group, params: FlexAttnParams):
    """``fn(q, k, v) -> (out, lse)`` on this rank's zigzag shards
    (:func:`zigzag_dispatch`; the JAX ``make_hybrid_dcp_attn_fn`` over
    ``P(cp)``)."""
    if plan.cp_size != group_size(group):
        raise ValueError(f"the plan is for cp={plan.cp_size}, the group has "
                         f"{group_size(group)} ranks")

    def fn(q, k, v):
        return hybrid_dcp_attn_local(q, k, v, plan, params, group)

    return fn
