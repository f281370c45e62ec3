"""Distributed context-parallel flex attention: plan builder + runtime.

The port's counterpart of the JAX package's ``parallel/dist_attn.py``, over
``torch.distributed`` with one process per cp rank. Per rank, on the host
(once per unique mask, cached under the runtime key):

1. host q/k ranges from the dispatch partition (chunked permutable shard;
   for cross-attention the K side's own partition, ``kv_dispatch_meta``),
2. ``remote_k = needed_k \\ host_k`` (the exact remote set),
3. GroupCollectiveMeta(s) routing K/V rows owner -> consumer, one per
   overlap stage; over an (n_inter, n_intra) layout of the ranks
   (``cp_mesh_shape``) the two-level ``HierGroupCollectiveMeta`` instead,
   which sends a row several ranks of one node need across nodes once,
4. per-rank entry tables over the rank-local KV buffers, built directly in
   global mask coordinates via run translation (ops/block_meta.py).

The host planning (:func:`build_dist_attn_plan`) is a copy of the JAX
builder's and gives the same stacked numpy arrays, byte for byte; at run
time each process takes its own row (:func:`rank_tables`).

Execution modes (:func:`dist_attn_local`):

- degree 0 (no overlap): ONE group cast of all remote KV, written after
  the own shard into one head-major KV buffer, ONE kernel call over it;
- degree D >= 1: the host stage attends the own shard (with the sink, if
  any); then per stage a cast, a sink-free kernel call and the LSE merge
  (``correct_attn_out_lse``) in f32. On the card each cast runs on a side
  CUDA stream, ordered by events, so that it overlaps the previous stage's
  kernel: the stream stands in for XLA's latency-hiding scheduler.

The kernels are the row-major ``flex_fwd_hb`` (head_block > 1) or
``flex_fwd`` forward and the ``flex_dq`` / ``flex_dkv`` backward, through
``ops.flex_attn.flex_attn_headmajor`` (CPU tensors take their plain
versions). The cast is ``comm.GroupCast`` (a hierarchical plan:
``comm.GroupCastHier`` over the ``HierCpGroups`` subgroups), whose
backward sums the dK/dV of received rows back onto their owners.

Resilience, as in the JAX package: a plan build that fails falls back to
the degree-0 plan (:func:`build_dist_attn_plan`), and each kernel partial
takes the chaos injector and the numerical guard before it merges
(:func:`dist_attn_local`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import numpy as np
import torch

from .. import env
from ..common.axes import split_cp_group
from ..common.mask import slice_area
from ..common.ranges import AttnRanges
from ..comm.group_collective import (
    GroupCollectiveMeta,
    RankRouting,
    group_cast_m,
    predicted_volume_ratio,
    rank_routing,
)
from ..comm.hier import (
    GroupCastHier,
    HierGroupCollectiveMeta,
    HierRouting,
    hier_rank_routing,
)
from ..meta.containers import AttnBucket
from ..meta.dispatch_meta import DispatchMeta
from ..meta.solver.overlap_solver import (
    OverlapConfig,
    OverlapSolver,
    OverlapStageCost,
    simulate_overlap_timeline,
)
from ..ops.block_meta import (
    FlexAttnBlockMeta,
    Run,
    build_block_meta_general,
    pad_block_meta,
    runs_from_position_ids,
)
from ..ops.correction import correct_attn_out_lse
from ..utils.instrument import named_scope
from ..ops.flex_attn import FlexAttnParams, _device_tables, flex_attn_headmajor


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


@dataclasses.dataclass(frozen=True, eq=False)
class StageTables:
    """Stacked per-rank kernel tables for one attention call (numpy int32,
    leading cp axis; each rank's process takes its own row)."""

    kv_pad: int  # padded local KV length this stage's kernel sees
    fwd_qblk: np.ndarray
    fwd_kblk: np.ndarray
    fwd_sid: np.ndarray
    fwd_runs: np.ndarray
    bwd_kblk: np.ndarray
    bwd_qblk: np.ndarray
    bwd_sid: np.ndarray
    bwd_runs: np.ndarray
    bounds: np.ndarray
    num_q_blocks: int = 0
    num_k_blocks: int = 0

    def arrays(self):
        return (
            self.fwd_qblk,
            self.fwd_kblk,
            self.fwd_sid,
            self.fwd_runs,
            self.bwd_kblk,
            self.bwd_qblk,
            self.bwd_sid,
            self.bwd_runs,
            self.bounds,
        )

    def kernel_steps(self) -> tuple[int, int]:
        """(fwd, bwd) row-major step extents across the ranks: the most
        entries of one q block (forward, dq) and of one k block (dk/dv)."""
        from ..ops.block_meta import max_row_count

        nq = max(self.num_q_blocks, 1)
        nk = max(self.num_k_blocks, 1)
        return (max(max_row_count(row, nq) for row in self.fwd_qblk),
                max(max_row_count(row, nk) for row in self.bwd_kblk))

    @staticmethod
    def from_rank_metas(metas: list[FlexAttnBlockMeta], kv_pad: int):
        e = max(m.num_fwd_entries for m in metas)
        e2 = max(m.num_bwd_entries for m in metas)
        s = max(m.num_slices for m in metas)
        metas = [pad_block_meta(m, e, e2, s) for m in metas]
        return StageTables(
            kv_pad=kv_pad,
            num_q_blocks=max(m.num_q_blocks for m in metas),
            num_k_blocks=max(m.num_k_blocks for m in metas),
            fwd_qblk=np.stack([m.fwd_q_block for m in metas]),
            fwd_kblk=np.stack([m.fwd_k_block for m in metas]),
            fwd_sid=np.stack([m.fwd_slice_id for m in metas]),
            fwd_runs=np.stack([m.fwd_runs for m in metas]),
            bwd_kblk=np.stack([m.bwd_k_block for m in metas]),
            bwd_qblk=np.stack([m.bwd_q_block for m in metas]),
            bwd_sid=np.stack([m.bwd_slice_id for m in metas]),
            bwd_runs=np.stack([m.bwd_runs for m in metas]),
            bounds=np.stack([m.slice_bounds for m in metas]),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class StagePlan:
    comm: GroupCollectiveMeta | HierGroupCollectiveMeta
    tables: StageTables
    max_rank_area: int = 0  # mask area of the heaviest rank's work in this stage


@dataclasses.dataclass(frozen=True, eq=False)
class DistAttnPlan:
    """Host-side plan for one (mask, dispatch, blocking, overlap) combo."""

    cp_size: int
    shard_q_len: int
    shard_q_pad: int
    block_q: int
    block_k: int
    overlap_degree: int  # 0 = merged no-overlap path
    total_area: int
    max_rank_area: int

    # degree-0 (merged) path
    merged_comm: GroupCollectiveMeta | HierGroupCollectiveMeta | None
    merged_tables: StageTables | None

    # staged path (degree >= 1)
    host_tables: StageTables | None
    stages: tuple[StagePlan, ...]

    # hierarchical two-level comm over an (n_inter, n_intra) layout of the
    # ranks; None = flat group collectives
    hier: tuple[int, int] | None = None

    # heaviest rank's host-stage (own-shard) mask area; 0 on the merged path
    host_max_rank_area: int = 0

    # K/V rows per rank (the K side's shard; = shard_q_len in self-attention)
    shard_k_len: int = 0

    @property
    def comm(self) -> GroupCollectiveMeta | HierGroupCollectiveMeta:
        """The plan's comm for the records: the merged cast at degree 0,
        else the stages' casts summed (send and recv rows per rank)."""
        if self.merged_comm is not None:
            return self.merged_comm
        rt, st = [0] * self.cp_size, [0] * self.cp_size
        for sp in self.stages:
            for r in range(self.cp_size):
                rt[r] += sp.comm.recv_total[r]
                st[r] += sp.comm.send_total[r]
        if not self.stages:  # every stage was empty (a fully local mask)
            cp = self.cp_size
            return GroupCollectiveMeta(
                cp_size=cp, max_send=0, max_recv=0, send_total=tuple(st), recv_total=tuple(rt),
                send_idx=np.zeros((cp, cp, 0), np.int32), recv_sel=np.zeros((cp, 0), np.int32),
                recv_valid=np.zeros((cp, 0), bool), seg_ids=np.zeros((cp, cp, 0), np.int32))
        return dataclasses.replace(self.stages[0].comm, recv_total=tuple(rt), send_total=tuple(st))

    def memory_ledger(self, *, num_heads_q: int, num_heads_kv: int, head_dim: int,
                      bytes_per_elt: int = 2, **kw):
        """One rank's buffers for this plan's forward
        (``telemetry.plan_memory_ledger``): each stage's cast buffer at the
        rows its cast schedules, the kernels' partials and lse, the operands,
        tables and outputs."""
        from ..telemetry.memory import plan_memory_ledger

        return plan_memory_ledger(self, num_heads_q=num_heads_q, num_heads_kv=num_heads_kv,
                                  head_dim=head_dim, bytes_per_elt=bytes_per_elt, **kw)

    def table_sets(self) -> tuple[StageTables, ...]:
        """Every StageTables the plan hands the kernels, in call order."""
        if self.overlap_degree == 0:
            return (self.merged_tables,)
        return (self.host_tables, *(sp.tables for sp in self.stages))

    def comms(self) -> tuple[GroupCollectiveMeta | HierGroupCollectiveMeta, ...]:
        """Every cast of the plan, in call order."""
        if self.overlap_degree == 0:
            return (self.merged_comm,)
        return tuple(sp.comm for sp in self.stages)


# ---------------------------------------------------------------------------
# plan building
# ---------------------------------------------------------------------------


def _split_send_map_by_stage(
    send_map: list[list[np.ndarray]],
    stage_row_of: list[np.ndarray],  # per dst rank: stage id of each recv row
    num_stages: int,
    cp: int,
) -> list[list[list[np.ndarray]]]:
    """stage -> owner -> dst -> owner-local rows (subset of send_map)."""
    out = [
        [[np.empty(0, np.int64) for _ in range(cp)] for _ in range(cp)]
        for _ in range(num_stages)
    ]
    for d in range(cp):
        pos = 0
        for s in range(cp):
            rows = send_map[s][d]
            n = len(rows)
            if n:
                stages = stage_row_of[d][pos : pos + n]
                for st in range(num_stages):
                    sel = rows[stages == st]
                    out[st][s][d] = sel
            pos += n
    return out


def _stage_granularity(
    n_rows: int, config: OverlapConfig, block_k: int
) -> int:
    """Row-block granularity for stage assignment — shared by the staged
    builder and the auto-degree timeline model so the model prices exactly
    the split that will execute."""
    return max(
        config.min_stage_rows,
        block_k,
        -(-n_rows // config.max_num_chunks) if n_rows else 0,
    )


def _slice_area_within_k(
    qs: int, qe: int, ks: int, ke: int, mt: int, intervals
) -> int:
    """Exact unmasked area of one slice restricted to k in the interval
    union (mask-type-aware, via rectangle k-cuts)."""
    from ..common.enum import AttnMaskType
    from ..common.range import AttnRange
    from ..common.rectangle import AttnRectangle

    rect = AttnRectangle(
        AttnRange(qs, qe), AttnRange(ks, ke), AttnMaskType(mt)
    )
    total = 0
    for a, b in intervals:
        _, right = rect.cut_k_multi(a)
        for piece in right:
            left, _ = piece.cut_k_multi(b)
            total += sum(p.area for p in left)
    return total


def _choose_overlap_degree(
    cp: int,
    slices_per_rank,
    host_ranges,
    recv_rows,
    config: OverlapConfig,
    block_k: int,
    inter_frac: float | None = None,
    comm_volume_ratio: float = 1.0,
) -> int:
    """Auto overlap degree: simulate the staged pipeline per candidate
    degree with the config's cost factors and return the argmin over the
    slowest rank (ties -> fewer stages). Mirrors the UNIFORM contiguous
    row split the staged builder will actually apply.

    ``inter_frac``: for hierarchical plans, the fraction of recv rows that
    also cross the slow inter hop after dedup — comm is then priced as
    one intra hop per row plus inter_frac of an inter hop (when the config
    has ``comm_cost_factor_inter``).

    ``comm_volume_ratio``: scheduled / true rows of the selected
    group-collective impl on the full send map
    (:func:`~..comm.group_collective.predicted_volume_ratio`) — stage
    comm is priced at the volume the wire will actually carry, not the
    true-row lower bound (the per-stage skew is approximated by the
    plan-level ratio; the built stages' metas record the exact figure)."""
    cf = config.calc_cost_factor
    cmf = config.comm_cost_factor * max(comm_volume_ratio, 1e-9)
    if inter_frac is not None and config.comm_cost_factor_inter is not None:
        cmf = cmf + inter_frac * config.comm_cost_factor_inter
    per_rank: list[tuple[float, float, int]] = []  # (host_s, remote_s, rows)
    for r in range(cp):
        own = [
            (rng.start, rng.end) for rng in host_ranges[r]
        ]
        area_total = 0
        area_host = 0
        for qs, qe, ks, ke, mt in slices_per_rank[r].tolist():
            area_total += slice_area(qs, qe, ks, ke, mt)
            area_host += _slice_area_within_k(qs, qe, ks, ke, mt, own)
        per_rank.append(
            (
                area_host * cf,
                max(area_total - area_host, 0) * cf,
                int(recv_rows[r]),
            )
        )

    max_d = max(1, config.dynamic_max_degree)
    best_d, best_t = 1, float("inf")
    for d in range(1, max_d + 1):
        t = 0.0
        for host_s, remote_s, rows in per_rank:
            if rows == 0:
                t = max(t, host_s)
                continue
            gran = _stage_granularity(rows, config, block_k)
            n_blocks = -(-rows // gran)
            per = -(-n_blocks // min(d, n_blocks))
            stage_rows = []
            done = 0
            for s in range(min(d, n_blocks)):
                blocks = min(per, n_blocks - s * per)
                if blocks <= 0:
                    break
                r_rows = min(blocks * gran, rows - done)
                stage_rows.append(r_rows)
                done += r_rows
            comm_s = [x * cmf for x in stage_rows]
            calc_s = [remote_s * (x / rows) for x in stage_rows]
            t = max(
                t,
                simulate_overlap_timeline(
                    host_s, comm_s, calc_s, config.stage_overhead_s
                ),
            )
        if t < best_t * (1.0 - 1e-9):
            best_d, best_t = d, t
    from .. import telemetry

    telemetry.record_overlap_choice(best_d, best_t)
    return best_d


def build_dist_attn_plan(
    dispatch_meta: DispatchMeta,
    bucket: AttnBucket,
    *,
    kv_dispatch_meta: DispatchMeta | None = None,
    block_q: int = 64,
    block_k: int = 64,
    overlap_config: OverlapConfig | None = None,
    cp_mesh_shape: tuple[int, int] | None = None,
) -> DistAttnPlan:
    """Plan the distributed attention for one dispatched mask at the
    kernels' tile (64 x 64 on Hopper; JAX's ``build_dist_attn_plan``
    defaults to 128 x 128, so parity tests build both at one blocking). The
    stacked per-rank arrays are byte-identical to the JAX
    ``build_dist_attn_plan``'s for the same inputs.

    Self-attention by default (K/V follow the Q partition); pass the K
    side's own ``kv_dispatch_meta`` for cross-attention. ``cp_mesh_shape``
    (n_inter, n_intra) plans hierarchical two-level comm over that layout
    of the ranks (rank = inter * n_intra + intra): every cast, merged or
    staged, becomes a ``HierGroupCollectiveMeta``.

    A build that fails (an injected ``plan_error`` included) falls back to
    the dense degree-0 plan (one merged cast, one kernel call) with a
    warning on the ``resilience`` logger; a degree-0 build that fails
    raises, as there is nothing left to fall back to. With telemetry on the
    build is a span, and the plan's facts and build seconds are recorded
    (``telemetry.record_plan``); the seconds also go to the compile
    tracker's solver accumulator (``telemetry.record_plan_solver``).

    Under ``MAGI_ATTENTION_VALIDATE=plan`` the plan then runs through
    ``analysis.plan_sanity.validate_plan`` (against the bucket's mask area);
    under ``trace`` also through ``analysis.trace_audit
    .audit_plan_collectives``. A failing check raises
    ``PlanValidationError``; nothing catches it."""
    from .. import telemetry

    kw = dict(kv_dispatch_meta=kv_dispatch_meta, block_q=block_q, block_k=block_k,
              cp_mesh_shape=cp_mesh_shape)
    t0 = time.perf_counter()
    with telemetry.span("build_dist_attn_plan", cp=dispatch_meta.cp_size):
        try:
            plan = _build_dist_attn_plan(dispatch_meta, bucket, overlap_config=overlap_config,
                                         **kw)
        except Exception as exc:  # noqa: BLE001 — the degradation path
            cfg = overlap_config or OverlapConfig()
            if cfg.degree == 0:
                raise  # the fallback is the path that failed
            telemetry.record_degraded_path("plan_build_error")
            telemetry.get_logger("resilience").warning(
                "plan build failed (%s: %s) — degrading to the dense single-bucket degree-0 plan",
                type(exc).__name__, exc)
            plan = _build_dist_attn_plan(dispatch_meta, bucket,
                                         overlap_config=dataclasses.replace(cfg, degree=0), **kw)
    build_s = time.perf_counter() - t0
    telemetry.record_plan(plan, build_seconds=build_s)
    telemetry.record_plan_solver(build_s, cache_hit=False)
    mode = env.validate_mode()
    if mode != "off":
        # after the fallback was decided and outside its try: a failing
        # check raises to the caller, as in the JAX package
        from ..analysis.plan_sanity import PlanValidationError, validate_plan

        validate_plan(plan, total_area=bucket.area)
        if mode == "trace":
            from ..analysis.trace_audit import audit_plan_collectives

            problems = audit_plan_collectives(plan)
            if problems:
                telemetry.record_validate(failed=True)
                raise PlanValidationError("; ".join(problems))
    return plan


def _build_dist_attn_plan(
    dispatch_meta: DispatchMeta,
    bucket: AttnBucket,
    *,
    kv_dispatch_meta: DispatchMeta | None = None,
    block_q: int = 64,
    block_k: int = 64,
    overlap_config: OverlapConfig | None = None,
    cp_mesh_shape: tuple[int, int] | None = None,
) -> DistAttnPlan:
    from ..resilience import chaos

    chaos.maybe_fail("plan_error")  # an injectable solver / build failure
    cp = dispatch_meta.cp_size
    shard_len = dispatch_meta.shard_seqlen
    kv_meta = kv_dispatch_meta or dispatch_meta
    assert kv_meta.cp_size == cp
    shard_k_len = kv_meta.shard_seqlen
    overlap_config = overlap_config or OverlapConfig()
    degree = overlap_config.degree
    if cp_mesh_shape is not None:
        assert cp_mesh_shape[0] * cp_mesh_shape[1] == cp, (
            f"cp_mesh_shape {cp_mesh_shape} != cp {cp}"
        )

    pos_ids = [dispatch_meta.position_ids(r) for r in range(cp)]
    pos_ids_k = [kv_meta.position_ids(r) for r in range(cp)]
    host_ranges = kv_meta.host_ranges_per_rank()  # K-side ownership

    # per-rank slices (global coords) + needed K sets
    slices_per_rank: list[np.ndarray] = []
    needed_k: list[AttnRanges] = []
    for r in range(cp):
        rows = []
        ks = AttnRanges()
        for c in dispatch_meta.partitions[r]:
            for s in bucket.q_chunks[c].attn_slices:
                rows.append(
                    (
                        s.q_range.start,
                        s.q_range.end,
                        s.k_range.start,
                        s.k_range.end,
                        int(s.mask_type),
                    )
                )
                ks.append(s.k_range.clone())
        slices_per_rank.append(np.asarray(rows, dtype=np.int64).reshape(-1, 5))
        needed_k.append(ks.merge())

    remote_k = [needed_k[r].find_hole_ranges(host_ranges[r]) for r in range(cp)]
    send_map: list[list[np.ndarray]] = [
        [np.empty(0, np.int64) for _ in range(cp)] for _ in range(cp)
    ]
    recv_segments: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(cp)]
    for d in range(cp):
        for s in range(cp):
            if s == d:
                continue
            inter = remote_k[d].find_overlap_ranges(host_ranges[s])
            if inter.is_empty():
                continue
            local = host_ranges[s].make_ranges_local(inter, is_self_merged=True)
            order = sorted(range(len(local)), key=lambda i: local[i].start)
            idx_parts = [
                np.arange(local[i].start, local[i].end, dtype=np.int64)
                for i in order
            ]
            send_map[s][d] = (
                np.concatenate(idx_parts) if idx_parts else np.empty(0, np.int64)
            )
            recv_segments[d].append((s, pos_ids_k[s][send_map[s][d]]))

    shard_q_pad = _round_up(shard_len, block_q)
    q_runs_per_rank = [runs_from_position_ids(pos_ids[r]) for r in range(cp)]
    k_own_runs_per_rank = [
        runs_from_position_ids(pos_ids_k[r]) for r in range(cp)
    ]
    total_area = bucket.area

    if degree is None:
        # auto-tune (reference OverlapConfig degree=None + dynamic_max_degree,
        # overlap_solver.py:71-157): pick the stage count minimizing the
        # pipelined timeline cost model over the critical rank
        recv_rows = [
            sum(len(g) for _, g in recv_segments[r]) for r in range(cp)
        ]
        inter_frac = None
        if cp_mesh_shape is not None:
            tot = sum(recv_rows)
            inter_frac = (
                HierGroupCollectiveMeta.inter_crossing_rows(
                    send_map, *cp_mesh_shape
                )
                / tot
                if tot
                else 0.0
            )
        # price comm at the volume the selected impl will schedule (the
        # a2a's global pad, or the hop sums — for hier plans the flat
        # ratio approximates the intra level's skew)
        vol_ratio, _ = predicted_volume_ratio(send_map)
        degree = _choose_overlap_degree(
            cp,
            slices_per_rank,
            host_ranges,
            recv_rows,
            overlap_config,
            block_k,
            inter_frac=inter_frac,
            comm_volume_ratio=vol_ratio,
        )

    def _build_comm(smap):
        """(comm meta, per-rank recv-order global k ids) for one send map —
        flat single-level or hierarchical two-hop routing."""
        if cp_mesh_shape is None:
            comm = GroupCollectiveMeta.build(smap, [shard_k_len] * cp)
            sources = [
                [(s, smap[s][d]) for s in range(cp) if len(smap[s][d])]
                for d in range(cp)
            ]
        else:
            comm, sources = HierGroupCollectiveMeta.build(
                smap, [shard_k_len] * cp, cp_mesh_shape[0], cp_mesh_shape[1]
            )
        gids = []
        for d in range(cp):
            parts = [pos_ids_k[s][rows] for s, rows in sources[d]]
            gids.append(
                np.concatenate(parts) if parts else np.empty(0, np.int64)
            )
        return comm, gids

    def _runs_from_recv_rows(global_ids: np.ndarray, base: int) -> list[Run]:
        runs = []
        for run in runs_from_position_ids(global_ids):
            runs.append(
                Run(
                    local_start=base + run.local_start,
                    global_start=run.global_start,
                    length=run.length,
                )
            )
        return runs

    if degree == 0:
        comm, comm_gids = _build_comm(send_map)
        kv_buf_pad = _round_up(shard_k_len + comm.max_recv, block_k)
        metas = []
        for r in range(cp):
            k_runs = list(k_own_runs_per_rank[r])
            # received rows sit right after the own shard, in recv order
            k_runs += _runs_from_recv_rows(comm_gids[r], shard_k_len)
            metas.append(
                build_block_meta_general(
                    slices_per_rank[r],
                    q_runs_per_rank[r],
                    k_runs,
                    shard_q_pad,
                    kv_buf_pad,
                    block_q=block_q,
                    block_k=block_k,
                )
            )
        tables = StageTables.from_rank_metas(metas, kv_buf_pad)
        return DistAttnPlan(
            cp_size=cp,
            shard_q_len=shard_len,
            shard_q_pad=shard_q_pad,
            block_q=block_q,
            block_k=block_k,
            overlap_degree=0,
            total_area=total_area,
            max_rank_area=max(m.total_area for m in metas),
            merged_comm=comm,
            merged_tables=tables,
            host_tables=None,
            stages=(),
            hier=cp_mesh_shape,
            shard_k_len=shard_k_len,
        )

    # ---- staged path -----------------------------------------------------
    # host stage: own shard only
    host_kv_pad = _round_up(shard_k_len, block_k)
    host_metas = [
        build_block_meta_general(
            slices_per_rank[r],
            q_runs_per_rank[r],
            k_own_runs_per_rank[r],  # the rank's own K/V shard
            shard_q_pad,
            host_kv_pad,
            block_q=block_q,
            block_k=block_k,
        )
        for r in range(cp)
    ]
    host_tables = StageTables.from_rank_metas(host_metas, host_kv_pad)

    # assign each rank's remote recv rows to stages via the overlap solver,
    # at row-block granularity in recv order (granularity honors
    # min_stage_rows and the max_num_chunks cap, matching the auto-degree
    # timeline model)
    stage_row_of: list[np.ndarray] = []
    solver = OverlapSolver(overlap_config)
    for r in range(cp):
        n_rows = sum(len(g) for _, g in recv_segments[r])
        gran = _stage_granularity(n_rows, overlap_config, block_k)
        n_blocks = -(-n_rows // gran) if n_rows else 0
        costs = [
            OverlapStageCost(comm_cost=float(min(gran, n_rows - b * gran)), calc_cost=1.0)
            for b in range(n_blocks)
        ]
        sol = solver.solve(costs, degree=degree)
        row_stage = np.zeros(n_rows, dtype=np.int64)
        for b in range(n_blocks):
            row_stage[b * gran : (b + 1) * gran] = (
                sol.stage_of[b] if b < len(sol.stage_of) else 0
            )
        stage_row_of.append(row_stage)

    num_stages = degree
    staged_maps = _split_send_map_by_stage(
        send_map, stage_row_of, num_stages, cp
    )
    rank_area = [host_metas[r].total_area for r in range(cp)]
    stages: list[StagePlan] = []
    for st in range(num_stages):
        st_comm, st_gids = _build_comm(staged_maps[st])
        st_kv_pad = _round_up(max(st_comm.max_recv, block_k), block_k)
        st_metas = []
        for r in range(cp):
            k_runs = _runs_from_recv_rows(st_gids[r], 0)
            st_metas.append(
                build_block_meta_general(
                    slices_per_rank[r],
                    q_runs_per_rank[r],
                    k_runs,
                    shard_q_pad,
                    st_kv_pad,
                    block_q=block_q,
                    block_k=block_k,
                )
            )
        if all(t == 0 for t in st_comm.recv_total):
            continue  # globally empty stage: no collective, no kernel call
        for r in range(cp):
            rank_area[r] += st_metas[r].total_area
        stages.append(
            StagePlan(
                comm=st_comm,
                tables=StageTables.from_rank_metas(st_metas, st_kv_pad),
                max_rank_area=max(m.total_area for m in st_metas),
            )
        )

    return DistAttnPlan(
        cp_size=cp,
        shard_q_len=shard_len,
        shard_q_pad=shard_q_pad,
        block_q=block_q,
        block_k=block_k,
        overlap_degree=num_stages,
        hier=cp_mesh_shape,
        shard_k_len=shard_k_len,
        total_area=total_area,
        max_rank_area=max(rank_area),
        host_max_rank_area=max(m.total_area for m in host_metas),
        merged_comm=None,
        merged_tables=None,
        host_tables=host_tables,
        stages=tuple(stages),
    )


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def make_attn_params(
    plan,  # DistAttnPlan or parallel.qo_comm.QoCommPlan: only its tile is read
    head_dim: int,
    *,
    scale: float | None = None,
    softcap: float = 0.0,
    has_sink: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    head_block: int = 1,
) -> FlexAttnParams:
    """The kernels' static parameters for a plan: its tile, the row-major
    grid (the distributed tables are row-major walks, as in the JAX
    package), and ``head_block`` (> 1 launches ``flex_fwd_hb``; a qo-comm
    plan keeps 1, as the JAX package's qo branch does, so it launches
    ``flex_fwd`` at every G)."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    return FlexAttnParams(
        block_q=plan.block_q,
        block_k=plan.block_k,
        scale=float(scale),
        softcap=float(softcap),
        has_sink=bool(has_sink),
        out_dtype=out_dtype,
        head_block=int(head_block),
        grid="row_major",
    )


@dataclasses.dataclass(frozen=True, eq=False)
class RankTables:
    """One rank's row of a plan on its device: the kernels' forward and
    backward tables for each kernel call and the routing of each cast."""

    kernel: tuple[tuple[tuple, tuple, int], ...]  # (ftab, btab, kv_pad) per call
    casts: tuple[RankRouting | HierRouting, ...]  # per cast, in call order


def _rank_kernel_tables(st: StageTables, r: int, q_pad: int, block_q: int, block_k: int,
                        device: str):
    ftab = _device_tables(st.fwd_qblk[r], st.fwd_kblk[r], st.fwd_sid[r], st.fwd_runs[r],
                          st.bounds[r], q_pad // block_q, device)
    btab = _device_tables(st.bwd_kblk[r], st.bwd_qblk[r], st.bwd_sid[r], st.bwd_runs[r],
                          st.bounds[r], st.kv_pad // block_k, device)
    return ftab, btab, st.kv_pad


@functools.lru_cache(maxsize=256)
def rank_tables(plan: DistAttnPlan, rank: int, device: str) -> RankTables:
    """``rank``'s tables and routing of ``plan`` on ``device``, copied once
    per (plan, rank, device)."""
    routing = rank_routing if plan.hier is None else hier_rank_routing
    return RankTables(
        kernel=tuple(
            _rank_kernel_tables(st, rank, plan.shard_q_pad, plan.block_q, plan.block_k, device)
            for st in plan.table_sets()
        ),
        casts=tuple(routing(c, rank, plan.shard_k_len, device) for c in plan.comms()),
    )


def _hm(x: torch.Tensor, target: int) -> torch.Tensor:
    """[t, h, d] -> head-major [h, target, d], zero-padded."""
    out = x.new_zeros((x.shape[1], target, x.shape[2]))
    out[:, : x.shape[0]] = x.transpose(0, 1)
    return out


def _kv_buffer(parts, kv_pad: int, like: torch.Tensor) -> torch.Tensor:
    """One head-major K/V buffer [2, hk, kv_pad, d] in ``like``'s dtype from
    [t_i, 2, hk, d] row blocks laid one after the other (the own shard,
    then the received rows), zero past them: each block is copied once, and
    ``buf[0]`` / ``buf[1]`` are the contiguous, 16-byte aligned K and V the
    kernels load (a received [R, 2, hk, d] payload's K and V are strided
    views). Differentiable: each block gets its rows' gradient."""
    hk, d = like.shape[1], like.shape[2]
    buf = like.new_zeros((2, hk, kv_pad, d))
    pos = 0
    for p in parts:
        n = p.shape[0]
        buf[:, :, pos : pos + n] = p.permute(1, 2, 0, 3)
        pos += n
    return buf


def _seq(out_h, lse_h, n):
    """Kernel head-major outputs -> ([n, h, d] out, [n, h] lse)."""
    return out_h.transpose(0, 1)[:n], lse_h.transpose(0, 1)[:n]


def _cast(payload, rt, group):
    """One cast of the plan: flat (``group_cast_m`` over the cp group, with
    the cast's chaos injectors) or hierarchical (``GroupCastHier`` over the
    ``HierCpGroups``' levels, which has none, as in the JAX package)."""
    if isinstance(rt, HierRouting):
        return GroupCastHier.apply(payload, rt, group)
    return group_cast_m(payload, rt, group)


class _Stream:
    """The side stream a stage's cast runs on, ordered after the work that
    made its payload and before the kernel that reads it (CUDA tensors);
    a plain sequence on the CPU."""

    def __init__(self, device: torch.device):
        self.side = torch.cuda.Stream(device) if device.type == "cuda" else None
        if self.side is not None:
            self.side.wait_stream(torch.cuda.current_stream(device))

    def cast(self, payload, rt, group):
        if self.side is None:
            return _cast(payload, rt, group)
        main = torch.cuda.current_stream(payload.device)
        with torch.cuda.stream(self.side):
            recv = _cast(payload, rt, group)
        main.wait_stream(self.side)
        recv.record_stream(main)
        return recv


def _cast_groups(plan: DistAttnPlan, group):
    """(the flat cp group, the group the plan's casts run over): a
    hierarchical plan needs the ``HierCpGroups`` of its layout, a flat plan
    a flat group; any other pairing raises, so that a plan never runs over
    a layout it was not built for."""
    flat, shape = split_cp_group(group)
    if plan.hier is None:
        if shape is not None:
            raise ValueError(f"a flat plan was given the {shape} hierarchical groups: "
                             "plan with cp_mesh_shape, or pass the flat group")
        return flat, flat
    if shape != tuple(plan.hier):
        raise ValueError(f"a hierarchical {tuple(plan.hier)} plan needs the HierCpGroups of that "
                         f"layout (comm.make_hier_cp_groups), got {group!r}")
    return flat, group


def dist_attn_local(
    q: torch.Tensor,  # [shard_q_len, hq, d] this rank's dispatched q
    k: torch.Tensor,  # [shard_k_len, hk, d]
    v: torch.Tensor,
    plan: DistAttnPlan,
    params: FlexAttnParams,
    group,
    *,
    sink: torch.Tensor | None = None,
    with_guard_code: bool = False,
    with_census: bool = False,
):
    """The context-parallel hot path, one call per rank (each process
    passes its own shards and the process group of the cp ranks, or for a
    hierarchical plan its ``HierCpGroups``).

    Returns (out [shard_q_len, hq, d], lse [shard_q_len, hq] f32, and the
    rank-local per-head max logit [hq]: all-reduce it with MAX across the
    group for the global value). Differentiable in q, k, v and sink: the
    backward runs ``flex_dq`` / ``flex_dkv`` on this rank's tables and sums
    the dK/dV of the rows other ranks received back onto this rank.

    Resilience: each partial (the merged one at degree 0; the host stage's,
    then each stage's before its merge) takes the ``corrupt_partial`` chaos
    injector, then the guard (sites ``resilience.plan_guard_sites(plan)``,
    in bit order). ``with_guard_code``: also return this rank's int32 guard
    code (a device tensor) as a 4th output, for the caller to read at its
    boundary; the keyed runtime does. Off, the path is unchanged.

    ``with_census``: also return, last, this rank's packed value census
    (f32 ``[len(numerics.census_keys(plan_guard_sites(plan)))]`` on the
    rank's device: each site's summary, downstream of chaos and the guard,
    then the merge's softmax-mass deviation). Reductions of the partials
    in hand, no collective; the keyed runtime reads it."""
    from ..comm.group_collective import group_rank
    from ..resilience import chaos, guards
    from ..telemetry import numerics

    if params.has_sink != (sink is not None):
        raise ValueError("params.has_sink must match whether a sink is given")
    flat, group = _cast_groups(plan, group)
    rank = group_rank(flat)  # a DryGroup's own rank under a dry recording
    gmode = guards.guard_mode()
    code = guards.new_error_code(q.device) if with_guard_code else None
    # a hierarchical plan plants on every rank, as the JAX package does there
    chaos_rank = rank if plan.hier is None else None

    census_vals, partial_lses = [], []

    def resilient(out_p, lse_p, site, site_index, rowmax):
        # chaos upstream of the guard: an injected fault travels the path an
        # organic kernel NaN would; the census downstream of both, so that
        # it sees what the merge takes
        nonlocal code
        if chaos.enabled():
            out_p, lse_p = chaos.corrupt_partial(out_p, lse_p, site, rank=chaos_rank)
        if gmode != "off":
            out_p, lse_p, code = guards.guard_partial(out_p, lse_p, code, site_index, site)
        if with_census:
            census_vals.extend(numerics.site_summary(out_p.detach(), lse_p.detach(),
                                                     rowmax[:, :n]))
            partial_lses.append(lse_p.detach())
        return out_p, lse_p

    def result(out, lse, mx):
        res = (out, lse, mx, code) if with_guard_code else (out, lse, mx)
        if with_census:
            census_vals.append(numerics.mass_deviation(partial_lses, lse.detach()))
            res = res + (numerics.pack_census(census_vals),)
        return res

    tabs = rank_tables(plan, rank, str(q.device))
    n, nk = plan.shard_q_len, plan.shard_k_len
    if q.shape[0] != n or k.shape[0] != nk or v.shape[0] != nk:
        raise ValueError(f"this plan's shards hold {n} q rows and {nk} k/v rows, got q/k/v "
                         f"with {q.shape[0]}/{k.shape[0]}/{v.shape[0]}")
    qh = _hm(q, plan.shard_q_pad)
    kv = torch.stack([k, v], dim=1)  # one payload for K and V: [n, 2, hk, d]
    if env.is_backward_high_precision_reduce():
        # an fp32 payload: the dK/dV reduce of the cast's backward sums in
        # fp32, and the gradient is cast back to k's dtype once
        kv = kv.float()
    stream = _Stream(q.device)

    if plan.overlap_degree == 0:
        ftab, btab, kv_pad = tabs.kernel[0]
        with named_scope("magi_merged_cast"):
            recv = stream.cast(kv, tabs.casts[0], group)
        buf = _kv_buffer((kv, recv), kv_pad, k)
        with named_scope("magi_merged_kernel"):
            out_h, lse_h, rowmax = flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab, params,
                                                       sink=sink)
        out, lse = resilient(*_seq(out_h, lse_h, n), "merged", 0, rowmax)
        return result(out, lse, rowmax.amax(dim=1))

    # staged: the host stage (own shard, with the sink) and D sink-free
    # remote stages merged in by their lse, the accumulator kept in fp32
    # (one downcast at the end)
    acc_dtype = torch.float32 if env.is_forward_high_precision_reduce() else params.out_dtype
    ftab, btab, kv_pad = tabs.kernel[0]
    buf = _kv_buffer((kv,), kv_pad, k)
    with named_scope("magi_host_stage_kernel"):
        out_h, lse_h, rowmax = flex_attn_headmajor(
            qh, buf[0], buf[1], ftab, btab, dataclasses.replace(params, out_dtype=acc_dtype),
            sink=sink,
        )
    out, lse = resilient(*_seq(out_h, lse_h, n), "host", 0, rowmax)
    mx = rowmax.amax(dim=1)
    stage_params = dataclasses.replace(params, has_sink=False, out_dtype=acc_dtype)
    for i, ((ftab, btab, kv_pad), rt) in enumerate(zip(tabs.kernel[1:], tabs.casts)):
        with named_scope(f"magi_stage{i}_cast"):
            recv = stream.cast(kv, rt, group)
        buf = _kv_buffer((recv,), kv_pad, k)
        with named_scope(f"magi_stage{i}_kernel"):
            out_h, lse_h, rowmax = flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab,
                                                       stage_params)
        out_i, lse_i = resilient(*_seq(out_h, lse_h, n), f"stage{i}", 1 + i, rowmax)
        with named_scope(f"magi_stage{i}_lse_merge"):
            out, lse = correct_attn_out_lse(out, lse, out_i, lse_i)
        mx = torch.maximum(mx, rowmax.amax(dim=1))
    return result(out.to(params.out_dtype), lse, mx)
