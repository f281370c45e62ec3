"""DispatchMeta + the global-bucket slicer + meta builder.

The port's own copy of the JAX package's ``meta/dispatch_meta.py``: cut
the global mask into per-chunk AttnSlices with exact areas, solve the
chunk->rank assignment, and record the resulting sequence permutation
(position ids / perm indices) that dispatch/undispatch apply; for
cross-attention (``make_cross_attn_dispatch_meta``) the queries are
balanced by area and the memory keys get a sequential partition of their
own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..common.enum import AttnMaskType
from ..common.range import AttnRange
from ..common.ranges import AttnRanges
from .containers import AttnBucket, AttnChunk, truncate_slice_q
from .solver.dispatch_solver import (
    DispatchConfig,
    DispatchData,
    DispatchJob,
    DispatchSolver,
    IOUAffinity,
)


@dataclass(frozen=True, eq=False)
class DispatchMeta:
    """Sharding result for one tensor role (query or key).

    ``partitions[rank]`` lists the chunk ids owned by that rank (ascending).
    Tokens of a rank are the concatenation of its chunks' rows in chunk order;
    ``position_ids(rank)`` maps local slot -> global position.

    Uneven shard (reference _make_dispatch_meta.py:368-377 +
    api/magi_attn_interface.py:639-676, no-padding dispatch with per-rank
    split sizes): ranks may own different chunk counts. SPMD arrays must
    stay uniform, so the *physical* shard is ``max_chunks_per_rank x
    chunk_size``; ranks with fewer chunks carry trailing pad slots that no
    mask slice covers (kernel emits out=0 / lse=-inf there, no comm rows
    reference them, and undispatch drops them). The global sequence itself
    is only padded to a chunk multiple — never to a cp x chunk multiple.
    """

    total_seqlen: int
    chunk_size: int
    num_chunks: int
    cp_size: int
    partitions: tuple[tuple[int, ...], ...]

    @property
    def max_chunks_per_rank(self) -> int:
        return max(len(p) for p in self.partitions)

    @property
    def is_uneven(self) -> bool:
        return any(
            len(p) != self.max_chunks_per_rank for p in self.partitions
        )

    @property
    def shard_seqlen(self) -> int:
        """Physical per-rank rows (uniform across ranks)."""
        return self.max_chunks_per_rank * self.chunk_size

    def rank_valid_len(self, rank: int) -> int:
        """Valid (non-pad) rows on this rank."""
        return len(self.partitions[rank]) * self.chunk_size

    @property
    def rank_valid_lens(self) -> tuple[int, ...]:
        return tuple(
            self.rank_valid_len(r) for r in range(self.cp_size)
        )

    def position_ids(self, rank: int) -> np.ndarray:
        """Global positions of rank's VALID local tokens, int32
        [rank_valid_len(rank)]."""
        cs = self.chunk_size
        out = np.empty(len(self.partitions[rank]) * cs, dtype=np.int32)
        for i, c in enumerate(self.partitions[rank]):
            out[i * cs : (i + 1) * cs] = np.arange(c * cs, (c + 1) * cs)
        return out

    def host_ranges_per_rank(self) -> list[AttnRanges]:
        """Per-rank owned global q ranges (merged)."""
        out = []
        for rank in range(self.cp_size):
            rs = AttnRanges()
            cs = self.chunk_size
            for c in self.partitions[rank]:
                rs.append(AttnRange(c * cs, (c + 1) * cs))
            out.append(rs.merge())
        return out

    @property
    def perm_idx(self) -> np.ndarray:
        """Global gather indices: dispatched[i] = x[perm_idx[i]], int32
        [cp * shard_seqlen]. Pad slots (uneven shard only) carry the
        out-of-bounds sentinel ``total_seqlen`` — gather with fill."""
        parts = []
        shard = self.shard_seqlen
        for r in range(self.cp_size):
            ids = self.position_ids(r)
            if ids.shape[0] < shard:
                ids = np.concatenate(
                    [
                        ids,
                        np.full(
                            shard - ids.shape[0],
                            self.total_seqlen,
                            np.int32,
                        ),
                    ]
                )
            parts.append(ids)
        return np.concatenate(parts)

    @property
    def unperm_idx(self) -> np.ndarray:
        """Inverse map: x[i] = dispatched[unperm_idx[i]], int32 [total]."""
        perm = self.perm_idx
        valid = perm < self.total_seqlen
        inv = np.empty(self.total_seqlen, dtype=np.int32)
        inv[perm[valid]] = np.arange(perm.shape[0], dtype=np.int32)[valid]
        return inv


def make_global_bucket_from_qk_ranges(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    attn_mask_type: Sequence[AttnMaskType],
    total_seqlen_q: int,
    chunk_size: int,
) -> AttnBucket:
    """Slice the global mask into per-chunk AttnSlices with exact areas.

    (reference _make_dispatch_meta.py:450 make_global_bucket_from_qk_ranges)
    """
    if total_seqlen_q % chunk_size != 0:
        raise ValueError(
            f"total_seqlen_q {total_seqlen_q} must be a chunk_size "
            f"{chunk_size} multiple (apply padding first; "
            f"{len(q_ranges)} mask slices)"
        )
    num_chunks = total_seqlen_q // chunk_size
    # sort slices by q start for deterministic per-chunk ordering
    order = sorted(
        range(len(attn_mask_type)),
        key=lambda i: (q_ranges[i].start, q_ranges[i].end, k_ranges[i].start),
    )
    bucket = AttnBucket()
    for c in range(num_chunks):
        chunk_range = AttnRange(c * chunk_size, (c + 1) * chunk_size)
        chunk = AttnChunk(chunk_id=c, q_range=chunk_range)
        for i in order:
            qi = q_ranges[i].intersect(chunk_range)
            if qi.is_empty():
                continue
            s = truncate_slice_q(
                q_ranges[i], k_ranges[i], AttnMaskType(attn_mask_type[i]), qi
            )
            if s is not None:
                s.slice_id = i
                chunk.attn_slices.append(s)
                chunk.sample_ids.append(i)
        bucket.q_chunks.append(chunk)
    return bucket


def _solve_q_partitions(
    bucket: AttnBucket,
    num_chunks: int,
    cp_size: int,
    dispatch_config: DispatchConfig,
) -> list[list[int]]:
    """Area-balanced chunk->rank assignment shared by the self- and
    cross-attention meta builders (incl. the partition-validity guards)."""
    if cp_size == 1:
        return [list(range(num_chunks))]
    workloads = [float(c.area) for c in bucket.q_chunks]
    affinities = None
    if dispatch_config.alg.is_affinity_considered:
        affinities = [
            IOUAffinity.from_ranges(c.k_ranges.merge()) for c in bucket.q_chunks
        ]
    t0 = time.perf_counter()
    solution = DispatchSolver(dispatch_config.alg).solve(
        DispatchData(
            jobs=DispatchJob.from_job_list(workloads, affinities),
            num_buckets=cp_size,
        )
    )
    solve_s = time.perf_counter() - t0
    if not solution.bucket_partitions:
        raise ValueError(
            f"{dispatch_config.alg.type} does not return partitions; "
            "choose a partition-returning algorithm for dispatch "
            f"({num_chunks} chunks over {cp_size} ranks)"
        )
    partitions = [sorted(p) for p in solution.bucket_partitions]
    covered = sorted(x for p in partitions for x in p)
    if covered != list(range(num_chunks)):
        raise ValueError(
            f"dispatch solution does not cover every chunk exactly once: "
            f"{cp_size} rank partitions cover {len(covered)} chunk slots "
            f"of {num_chunks} chunks "
            f"(alg={dispatch_config.alg.type}, "
            f"missing={sorted(set(range(num_chunks)) - set(covered))[:8]}, "
            f"dupes={sorted({x for x in covered if covered.count(x) > 1})[:8]})"
        )
    from .. import telemetry

    if telemetry.enabled():  # the O(num_chunks) sums stay off the disabled path
        telemetry.record_dispatch_solution(
            dispatch_config.alg.type.value, solution.minimax_workload,
            [sum(workloads[i] for i in p) for p in partitions], solve_s)
    return partitions


def make_cross_attn_dispatch_meta(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    attn_mask_type: Sequence[AttnMaskType],
    total_seqlen_q: int,
    total_seqlen_k: int,
    chunk_size_q: int,
    chunk_size_k: int,
    cp_size: int,
    dispatch_config: DispatchConfig | None = None,
) -> tuple[DispatchMeta, DispatchMeta, AttnBucket]:
    """Cross-attention dispatch (the reference's dispatch_qo/dispatch_kv
    split): queries are chunk-balanced by mask area; keys/values get their
    own sequential partition over [0, total_seqlen_k) — the memory side has
    no per-row cost imbalance to solve, only ownership for the group cast.
    """
    if dispatch_config is None:
        dispatch_config = DispatchConfig()
    num_chunks_k = total_seqlen_k // chunk_size_k
    if total_seqlen_k % chunk_size_k != 0:
        raise ValueError(
            f"total_seqlen_k {total_seqlen_k} must be a chunk_size_k "
            f"{chunk_size_k} multiple (apply k-side padding first)"
        )
    if num_chunks_k % cp_size != 0:
        raise ValueError(
            f"k chunks {num_chunks_k} (total_seqlen_k {total_seqlen_k} / "
            f"chunk_size_k {chunk_size_k}) must be divisible by cp_size "
            f"{cp_size}"
        )
    num_chunks_q = total_seqlen_q // chunk_size_q
    if total_seqlen_q % chunk_size_q != 0:
        raise ValueError(
            f"total_seqlen_q {total_seqlen_q} must be a chunk_size_q "
            f"{chunk_size_q} multiple (apply q-side padding first)"
        )
    if num_chunks_q % cp_size != 0:
        raise ValueError(
            f"q chunks {num_chunks_q} (total_seqlen_q {total_seqlen_q} / "
            f"chunk_size_q {chunk_size_q}) must be divisible by cp_size "
            f"{cp_size}"
        )

    bucket = make_global_bucket_from_qk_ranges(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, chunk_size_q
    )
    partitions = _solve_q_partitions(
        bucket, num_chunks_q, cp_size, dispatch_config
    )

    meta_q = DispatchMeta(
        total_seqlen=total_seqlen_q,
        chunk_size=chunk_size_q,
        num_chunks=num_chunks_q,
        cp_size=cp_size,
        partitions=tuple(tuple(p) for p in partitions),
    )
    per_rank_k = num_chunks_k // cp_size
    meta_k = DispatchMeta(
        total_seqlen=total_seqlen_k,
        chunk_size=chunk_size_k,
        num_chunks=num_chunks_k,
        cp_size=cp_size,
        partitions=tuple(
            tuple(range(r * per_rank_k, (r + 1) * per_rank_k))
            for r in range(cp_size)
        ),
    )
    from .. import telemetry

    telemetry.record_dispatch_meta(meta_q)
    return meta_q, meta_k, bucket


def make_dispatch_meta_from_qk_ranges(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    attn_mask_type: Sequence[AttnMaskType],
    total_seqlen_q: int,
    total_seqlen_k: int,
    chunk_size: int,
    cp_size: int,
    dispatch_config: DispatchConfig | None = None,
) -> tuple[DispatchMeta, DispatchMeta, AttnBucket]:
    """Build (query meta, key meta, global bucket) for a self-attention mask.

    Self-attention: queries and keys share the permutation so K/V shards
    line up with Q shards.
    """
    if total_seqlen_q != total_seqlen_k:
        raise ValueError(
            f"self-attention dispatch requires equal q/k seqlens, got "
            f"total_seqlen_q={total_seqlen_q} != total_seqlen_k="
            f"{total_seqlen_k} (cross-attention dispatches roles "
            "separately via make_cross_attn_dispatch_meta)"
        )
    if dispatch_config is None:
        dispatch_config = DispatchConfig()
    num_chunks = total_seqlen_q // chunk_size
    if not dispatch_config.uneven_shard and num_chunks % cp_size != 0:
        raise ValueError(
            f"num_chunks {num_chunks} (total_seqlen_q {total_seqlen_q} / "
            f"chunk_size {chunk_size}) must be divisible by cp_size "
            f"{cp_size} (apply padding first, or set "
            "DispatchConfig(uneven_shard=True))"
        )

    bucket = make_global_bucket_from_qk_ranges(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, chunk_size
    )
    partitions = _solve_q_partitions(
        bucket, num_chunks, cp_size, dispatch_config
    )

    meta = DispatchMeta(
        total_seqlen=total_seqlen_q,
        chunk_size=chunk_size,
        num_chunks=num_chunks,
        cp_size=cp_size,
        partitions=tuple(tuple(p) for p in partitions),
    )
    from .. import telemetry

    telemetry.record_dispatch_meta(meta)
    # self-attn: K/V follow the same partition
    return meta, meta, bucket
