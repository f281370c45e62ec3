"""qo-comm: context-parallel attention over a dynamic partition of the
attention plane, where Q/O move as well as K/V.

The port's counterpart of the JAX package's ``parallel/qo_comm.py``, over
``torch.distributed`` with one process per cp rank. A dynamic solver
(``meta/solver/dynamic_attn_solver.py``) cuts the (q, k) plane into cp
regions; each region's owner group-casts in the Q rows and the K/V rows
its region touches, runs the flex kernels on them once, and the partial
(out, lse) rows are group-reduced with the LSE op back to the Q owners
(``comm.group_reduce_lse``).

The host planning (:func:`build_qo_comm_plan`) is a copy of the JAX
builder's and gives the same comm metas and stacked kernel tables, byte
for byte; at run time each process takes its own row
(:func:`qo_rank_tables`). Token ownership is the contiguous shard, or the
chunk-permuted dispatch layout when a ``dispatch_meta`` is given (the
keyed API passes its MinHeap-balanced one).

Everything is differentiable: the Q and K/V casts (``comm.GroupCast``)
send dQ and dK/dV home in their backward, the O-return reduce carries the
lse cotangent, and a sink is folded in once after the merge. The casts'
and the LSE reduce's chaos injectors and the reduce's repair quarantine
sit in ``comm.group_collective`` (``group_cast_m``, ``group_reduce_lse``),
as in the JAX package: qo-comm adds no hook of its own.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..comm.group_collective import (
    GroupCollectiveMeta,
    RankRouting,
    group_cast_m,
    group_reduce_lse,
    rank_routing,
)
from ..common.ranges import AttnRanges
from ..common.rectangle import AttnRectangles
from ..meta.solver.dynamic_attn_solver import AutoDynamicSolver
from ..ops.block_meta import Run, build_block_meta_general, runs_from_position_ids
from ..ops.correction import correct_attn_out_lse_with_sink
from ..ops.flex_attn import FlexAttnParams, flex_attn_headmajor
from .dist_attn import StageTables, _hm, _kv_buffer, _rank_kernel_tables, _round_up, _seq


@dataclasses.dataclass(frozen=True, eq=False)
class QoCommPlan:
    cp_size: int
    shard_len: int  # token shard per rank (q == kv side)
    q_buf_pad: int  # padded received-Q buffer rows
    kv_buf_pad: int
    block_q: int
    block_k: int
    comm_q: GroupCollectiveMeta  # Q cast out / O lse-reduce back
    comm_kv: GroupCollectiveMeta
    tables: StageTables
    rank_areas: tuple[int, ...]


def _ranges_to_send_map(
    need: list[AttnRanges],
    shard: int,
    cp: int,
    unperm: np.ndarray | None = None,
) -> tuple[list[list[np.ndarray]], list[list[tuple[int, np.ndarray]]]]:
    """send_map[s][d] = s-local rows of need[d] owned by s;
    recv_segments[d] = (src, global ids) in recv order.

    Ownership: global row g lives at dispatch slot ``unperm[g]`` =
    rank * shard + local. ``unperm=None`` is the contiguous identity
    (sequential shard); a chunk-permuted dispatch layout routes through
    its own unperm_idx."""
    send_map = [
        [np.empty(0, np.int64) for _ in range(cp)] for _ in range(cp)
    ]
    recv_segments: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(cp)]
    for d in range(cp):
        if need[d].is_empty():
            continue
        if unperm is None:
            # contiguous ownership: interval arithmetic, no row-id sort
            for s in range(cp):
                own = AttnRanges.from_ranges([(s * shard, (s + 1) * shard)])
                inter = need[d].find_overlap_ranges(own)
                if inter.is_empty():
                    continue
                rows = np.concatenate(
                    [
                        np.arange(
                            r.start - s * shard,
                            r.end - s * shard,
                            dtype=np.int64,
                        )
                        for r in inter
                    ]
                )
                send_map[s][d] = rows
                recv_segments[d].append((s, rows + s * shard))
            continue
        ids = np.concatenate(
            [np.arange(r.start, r.end, dtype=np.int64) for r in need[d]]
        )
        slots = unperm[ids]
        s_rank = slots // shard
        local = slots % shard
        # canonical (src, global id) order shared by sender and receiver:
        # ids are ascending (merged ranges), so a stable sort by src rank
        # keeps them ascending within each src group
        order = np.argsort(s_rank, kind="stable")
        s_sorted = s_rank[order]
        for s in np.unique(s_sorted):
            m = s_sorted == s
            send_map[int(s)][d] = local[order][m]
            recv_segments[d].append((int(s), ids[order][m]))
    return send_map, recv_segments


def _runs_from_segments(
    segments: list[tuple[int, np.ndarray]]
) -> list[Run]:
    runs: list[Run] = []
    base = 0
    for _, gids in segments:
        for r in runs_from_position_ids(gids):
            runs.append(
                Run(
                    local_start=base + r.local_start,
                    global_start=r.global_start,
                    length=r.length,
                )
            )
        base += len(gids)
    return runs


def _debug_plot(sol, sl: np.ndarray, cp_size: int, total_seqlen: int) -> None:
    """At ``DEBUG`` logging, draw the dynamic solver's partition to
    ``./dyn_solver_buckets_cp<cp>_<mask hash>.png`` (the reference's
    bucket plot, one file per mask); a drawing or I/O failure never stops
    planning."""
    import logging

    logger = logging.getLogger("magiattention_tpu_torch")
    if not logger.isEnabledFor(logging.DEBUG):
        return
    try:
        import hashlib

        from ..utils.vis import plot_dynamic_solution

        tag = hashlib.sha1(sl.tobytes()).hexdigest()[:8]
        path = plot_dynamic_solution(sol, total_seqlen, total_seqlen,
                                     f"./dyn_solver_buckets_cp{cp_size}_{tag}.png")
        if path:
            logger.debug("dynamic-solver bucket plot saved to %s", path)
    except Exception as exc:  # the plot is a debugging aid, never a planning fault
        logger.debug("dynamic-solver bucket plot failed: %r", exc)


def build_qo_comm_plan(
    slices: np.ndarray,  # [S, 5] global (qs, qe, ks, ke, type)
    total_seqlen: int,
    cp_size: int,
    *,
    block_q: int = 64,
    block_k: int = 64,
    solver=None,
    dispatch_meta=None,
) -> QoCommPlan:
    """Plan the dynamic (attention-plane) partition and its comm routing,
    at the kernels' tile (64 x 64 on Hopper; the JAX builder's default is
    128 x 128, so parity tests build both at one blocking). ``solver``
    defaults to :class:`AutoDynamicSolver` (pass one to pin an algorithm).

    ``dispatch_meta``: when given, token ownership is that (chunk-permuted)
    dispatch layout instead of the contiguous shard; the plane partition
    stays in global coordinates either way, only the cast/reduce routing
    follows the permuted ownership."""
    if total_seqlen % cp_size:
        raise ValueError(f"total_seqlen {total_seqlen} must be divisible by cp_size {cp_size}")
    sl = np.asarray(slices, dtype=np.int64).reshape(-1, 5)
    if not ((sl[:, :4] >= 0).all() and (sl[:, [1, 3]] <= total_seqlen).all()):
        raise ValueError(
            f"slice ranges must lie within [0, {total_seqlen}): got "
            f"{sl[:, :4].min()}..{sl[:, [1, 3]].max()} (out-of-range tokens "
            "would never be cast)"
        )
    shard = total_seqlen // cp_size
    unperm = None
    if dispatch_meta is not None:
        if dispatch_meta.cp_size != cp_size:
            raise ValueError(f"dispatch meta cp {dispatch_meta.cp_size} != {cp_size}")
        if dispatch_meta.is_uneven:
            raise ValueError("qo-comm x uneven shard is unsupported (check_flag_comb)")
        if dispatch_meta.shard_seqlen != shard:
            raise ValueError(f"dispatch meta shard {dispatch_meta.shard_seqlen} != {shard} "
                             "(pad the sequence to the dispatch layout first)")
        unperm = dispatch_meta.unperm_idx.astype(np.int64)
    solver = solver or AutoDynamicSolver()

    rects = AttnRectangles.from_ranges(
        [(int(s[0]), int(s[1])) for s in sl],
        [(int(s[2]), int(s[3])) for s in sl],
        [int(s[4]) for s in sl],
    )
    sol = solver.solve(rects, cp_size, total_seqlen=total_seqlen)
    from .. import telemetry

    telemetry.record_dynamic_solution(type(solver).__name__, sol.balance_ratio)
    _debug_plot(sol, sl, cp_size, total_seqlen)

    q_need: list[AttnRanges] = []
    k_need: list[AttnRanges] = []
    rank_slices: list[np.ndarray] = []
    for rr in sol.rank_rects:
        qs = AttnRanges()
        ks = AttnRanges()
        rows = []
        for rect in rr:
            qs.append(rect.q_range.clone())
            ks.append(rect.k_range.clone())
            rows.append(
                (
                    rect.q_range.start,
                    rect.q_range.end,
                    rect.k_range.start,
                    rect.k_range.end,
                    int(rect.mask_type),
                )
            )
        q_need.append(qs.merge())
        k_need.append(ks.merge())
        rank_slices.append(np.asarray(rows, dtype=np.int64).reshape(-1, 5))

    send_q, recv_q = _ranges_to_send_map(q_need, shard, cp_size, unperm)
    send_kv, recv_kv = _ranges_to_send_map(k_need, shard, cp_size, unperm)
    comm_q = GroupCollectiveMeta.build(send_q, [shard] * cp_size)
    comm_kv = GroupCollectiveMeta.build(send_kv, [shard] * cp_size)

    q_buf_pad = _round_up(max(comm_q.max_recv, block_q), block_q)
    kv_buf_pad = _round_up(max(comm_kv.max_recv, block_k), block_k)

    metas = [
        build_block_meta_general(
            rank_slices[r],
            _runs_from_segments(recv_q[r]),
            _runs_from_segments(recv_kv[r]),
            q_buf_pad,
            kv_buf_pad,
            block_q=block_q,
            block_k=block_k,
        )
        for r in range(cp_size)
    ]
    return QoCommPlan(
        cp_size=cp_size,
        shard_len=shard,
        q_buf_pad=q_buf_pad,
        kv_buf_pad=kv_buf_pad,
        block_q=block_q,
        block_k=block_k,
        comm_q=comm_q,
        comm_kv=comm_kv,
        tables=StageTables.from_rank_metas(metas, kv_buf_pad),
        rank_areas=sol.areas,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class QoRankTables:
    """One rank's row of a :class:`QoCommPlan` on its device."""

    kernel: tuple  # (ftab, btab, kv_pad) of the one kernel call
    q: RankRouting  # Q cast out, O lse-reduce back
    kv: RankRouting


@functools.lru_cache(maxsize=256)
def qo_rank_tables(plan: QoCommPlan, rank: int, device: str) -> QoRankTables:
    """``rank``'s tables and routing of ``plan`` on ``device``, copied once
    per (plan, rank, device)."""
    return QoRankTables(
        kernel=_rank_kernel_tables(plan.tables, rank, plan.q_buf_pad, plan.block_q,
                                   plan.block_k, device),
        q=rank_routing(plan.comm_q, rank, plan.shard_len, device),
        kv=rank_routing(plan.comm_kv, rank, plan.shard_len, device),
    )


def qo_comm_attn_local(
    q: torch.Tensor,  # [shard, hq, d] this rank's dispatched q
    k: torch.Tensor,  # [shard, hk, d]
    v: torch.Tensor,
    plan: QoCommPlan,
    params: FlexAttnParams,
    group,
    *,
    sink: torch.Tensor | None = None,  # [hq] learned sink logits (replicated)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank of qo-comm (each process passes its own shard and the
    process group of the cp ranks): cast Q and K/V to the region owners,
    one kernel call on the received rows, LSE-reduce the partial (out, lse)
    back to the Q owners. Returns (out [shard, hq, d] in
    ``params.out_dtype``, lse [shard, hq] f32).

    ``sink``: a q row's softmax is split across regions on different
    ranks, so the sink cannot ride the kernel (it would join the
    denominator once per region). The partials are merged sink-free and the
    owner folds the sink in once afterwards (``lse' = logaddexp(lse,
    sink)``, ``out' = out * exp(lse - lse')``); an uncovered row ends at
    (0, sink). Sum the sink's gradient over the ranks
    (``comm.replicated``), as the keyed API does."""
    import torch.distributed as dist

    if params.has_sink:
        raise ValueError("qo-comm folds the sink in after the merge: build params with "
                         "has_sink=False and pass the sink to this function")
    if (params.block_q, params.block_k) != (plan.block_q, plan.block_k):
        raise ValueError(f"params blocks ({params.block_q},{params.block_k}) != plan blocks "
                         f"({plan.block_q},{plan.block_k}): derive params with "
                         "make_attn_params(plan, head_dim)")
    n = plan.shard_len
    if q.shape[0] != n or k.shape[0] != n or v.shape[0] != n:
        raise ValueError(f"this plan's shards hold {n} rows, got q/k/v with "
                         f"{q.shape[0]}/{k.shape[0]}/{v.shape[0]}")
    tabs = qo_rank_tables(plan, dist.get_rank(group), str(q.device))
    ftab, btab, kv_pad = tabs.kernel
    qb = group_cast_m(q, tabs.q, group)  # [R_q, hq, d]
    kvb = group_cast_m(torch.stack([k, v], dim=1), tabs.kv, group)  # [R_kv, 2, hk, d]
    buf = _kv_buffer((kvb,), kv_pad, k)
    out_h, lse_h, _ = flex_attn_headmajor(
        _hm(qb, plan.q_buf_pad), buf[0], buf[1], ftab, btab,
        dataclasses.replace(params, out_dtype=torch.float32),
    )
    out_p, lse_p = _seq(out_h, lse_h, plan.comm_q.max_recv)
    hq, d = q.shape[1], q.shape[2]
    out_acc = torch.zeros((n, hq, d), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((n, hq), float("-inf"), dtype=torch.float32, device=q.device)
    out, lse = group_reduce_lse(out_p, lse_p, out_acc, lse_acc, tabs.q, group)
    if sink is not None:
        out, lse = correct_attn_out_lse_with_sink(out, lse, sink.float()[None, :], "sh")
    return out.to(params.out_dtype), lse
