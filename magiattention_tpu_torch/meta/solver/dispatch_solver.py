"""Load-balance bin-packing solver: chunk workloads -> cp ranks.

The port's own copy of the JAX package's ``meta/solver/dispatch_solver.py``
(ten algorithms + two affinity classes), line for line so that a mask
dispatches to the same partitions. ``RandomSelectDispatchAlg`` shuffles
with Python's global ``random``, as the JAX package does: seed it with
``random.seed`` for a reproducible partition. The solver minimizes the
maximum bucket workload ("minimax"), where workload = exact attention-mask
area (FLOPs proxy) of each sequence chunk; affinities bias assignment so
chunks attending overlapping KV land on the same rank (reducing remote-KV
traffic).
"""

from __future__ import annotations

import heapq
import math
import random
from abc import ABC, abstractmethod
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional, TypeVar

from ...common.enum import DispatchAlgType
from ...common.range import AttnRange
from ...common.ranges import AttnRanges


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _argsort_desc(vals) -> list[int]:
    """Stable argsort by descending value."""
    return sorted(range(len(vals)), key=lambda i: (-vals[i], i))


# ---------------------------------------------------------------------------
# affinities
# ---------------------------------------------------------------------------

T = TypeVar("T", bound="BaseDispatchAffinity")


class BaseDispatchAffinity(ABC):
    """Distance-comparable affinity attached to a job / accumulated per bucket."""

    @abstractmethod
    def distance_to(self: T, other: T) -> float:
        ...

    @abstractmethod
    def update(self: T, other: T) -> None:
        """Absorb ``other`` into self (bucket accumulates its jobs' affinity)."""

    def get_closest_affinity_idx(self: T, others: list[T]) -> int:
        return min(range(len(others)), key=lambda i: self.distance_to(others[i]))


class SampleIDAffinity(BaseDispatchAffinity):
    """Affinity by sample-id histogram: closer = more tokens of my dominant
    sample already in the bucket (distance = -count)."""

    def __init__(self) -> None:
        self.sample_id_cnt: dict[int, int] = defaultdict(int)

    @staticmethod
    def from_list(ids: list[int]) -> "SampleIDAffinity":
        a = SampleIDAffinity()
        for i in ids:
            a.add_sample_id(i)
        return a

    def add_sample_id(self, sample_id: int) -> None:
        assert sample_id >= 0
        self.sample_id_cnt[sample_id] += 1

    def get_count(self, sample_id: int) -> int:
        return self.sample_id_cnt.get(sample_id, 0)

    def is_empty(self) -> bool:
        return not self.sample_id_cnt

    def distance_to(self, other: "SampleIDAffinity") -> float:
        if self.is_empty():
            return 0.0
        dominant = max(self.sample_id_cnt, key=lambda k: self.sample_id_cnt[k])
        return -other.get_count(dominant)

    def update(self, other: "SampleIDAffinity") -> None:
        for sid, cnt in other.sample_id_cnt.items():
            self.sample_id_cnt[sid] += cnt


class IOUAffinity(BaseDispatchAffinity):
    """Affinity by K-range overlap: distance = -|self.ranges ∩ other.ranges|."""

    def __init__(self) -> None:
        self.iou_ranges = AttnRanges()

    @staticmethod
    def from_ranges(ranges: AttnRanges) -> "IOUAffinity":
        a = IOUAffinity()
        a.extend(ranges)
        return a

    def append(self, attn_range: AttnRange) -> None:
        self.iou_ranges.append(attn_range)

    def extend(self, attn_ranges: AttnRanges) -> None:
        self.iou_ranges.extend(attn_ranges)

    def distance_to(self, other: "IOUAffinity") -> float:
        return -self.iou_ranges.intersect_size_with(other.iou_ranges)

    def update(self, other: "IOUAffinity") -> None:
        self.iou_ranges.extend(other.iou_ranges)


# ---------------------------------------------------------------------------
# job / data / solution
# ---------------------------------------------------------------------------


@dataclass
class DispatchJob:
    job_id: int
    workload: float = 0.0
    affinity: Optional[BaseDispatchAffinity] = None

    @staticmethod
    def from_job_list(
        workloads: list[float],
        affinities: Optional[list[BaseDispatchAffinity]] = None,
    ) -> list["DispatchJob"]:
        if affinities is None:
            return [DispatchJob(i, w) for i, w in enumerate(workloads)]
        assert len(affinities) == len(workloads)
        return [
            DispatchJob(i, w, a) for i, (w, a) in enumerate(zip(workloads, affinities))
        ]


@dataclass
class DispatchData:
    jobs: list[DispatchJob]
    num_buckets: int


@dataclass
class DispatchSolution:
    minimax_workload: float
    bucket_partitions: list[list[int]] = field(default_factory=list)

    def bucket_workloads(self, jobs: list[DispatchJob]) -> list[float]:
        return [
            sum(jobs[i].workload for i in p) for p in self.bucket_partitions
        ]


# ---------------------------------------------------------------------------
# algorithm configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DispatchAlg:
    type: DispatchAlgType = DispatchAlgType.MIN_HEAP
    # optional knobs for specific algorithms
    top_p: float = 0.0
    num_of_select_chunk: int = 1
    allocation_ratio: float = 1.0

    @property
    def is_partitions_returned(self) -> bool:
        return self.type not in (
            DispatchAlgType.LOWER_BOUND,
            DispatchAlgType.DYNAMIC_PROGRAMMING,
        )

    @property
    def is_equal_num_workloads(self) -> bool:
        return self.type in (
            DispatchAlgType.BACKTRACK_PRUNING,
            DispatchAlgType.TOPP_HEAP,
            DispatchAlgType.RANDOM_SELECT,
            DispatchAlgType.BATCH_TOPP_HEAP,
            DispatchAlgType.SORTED_SEQUENTIAL_SELECT,
        )

    @property
    def is_affinity_considered(self) -> bool:
        return self.type in (
            DispatchAlgType.TOPP_HEAP,
            DispatchAlgType.BATCH_TOPP_HEAP,
        )


def MinHeapDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.MIN_HEAP)


def LBDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.LOWER_BOUND)


def DPDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.DYNAMIC_PROGRAMMING)


def BSDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.BINARY_SEARCH)


def BTPDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.BACKTRACK_PRUNING)


def ToppHeapDispatchAlg(top_p: float = 0.0) -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.TOPP_HEAP, top_p=top_p)


def RandomSelectDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.RANDOM_SELECT)


def SequentialDispatchAlg() -> DispatchAlg:
    return DispatchAlg(DispatchAlgType.SEQUENTIAL_SELECT)


def BatchToppHeapDispatchAlg(
    top_p: float = 0.0, num_of_select_chunk: int = 1
) -> DispatchAlg:
    return DispatchAlg(
        DispatchAlgType.BATCH_TOPP_HEAP,
        top_p=top_p,
        num_of_select_chunk=num_of_select_chunk,
    )


def SortedSequentialSelectAlg(allocation_ratio: float = 1.0) -> DispatchAlg:
    return DispatchAlg(
        DispatchAlgType.SORTED_SEQUENTIAL_SELECT, allocation_ratio=allocation_ratio
    )


@dataclass(frozen=True)
class DispatchConfig:
    """Config for load-balanced dispatching (reference dispatch_solver.py:359)."""

    chunk_size: Optional[int] = None
    uneven_shard: bool = False
    alg: DispatchAlg = field(default_factory=MinHeapDispatchAlg)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


class DispatchSolver:
    """Minimize the maximum bucket workload under the chosen algorithm's
    constraints (equal job counts, affinity, optimality — see DispatchAlg)."""

    def __init__(self, alg: DispatchAlg) -> None:
        self.alg = alg
        self._solvers = {
            DispatchAlgType.LOWER_BOUND: self._solve_lb,
            DispatchAlgType.DYNAMIC_PROGRAMMING: self._solve_dp,
            DispatchAlgType.BINARY_SEARCH: self._solve_bs,
            DispatchAlgType.MIN_HEAP: self._solve_minheap,
            DispatchAlgType.BACKTRACK_PRUNING: self._solve_btp,
            DispatchAlgType.TOPP_HEAP: self._solve_topp_heap,
            DispatchAlgType.RANDOM_SELECT: self._solve_random,
            DispatchAlgType.SEQUENTIAL_SELECT: self._solve_sequential,
            DispatchAlgType.BATCH_TOPP_HEAP: self._solve_batch_topp_heap,
            DispatchAlgType.SORTED_SEQUENTIAL_SELECT: self._solve_sorted_sequential,
        }

    def solve(self, dispatch_data: DispatchData) -> DispatchSolution:
        assert dispatch_data.num_buckets > 0
        minimax, partitions = self._solvers[self.alg.type](dispatch_data)
        return DispatchSolution(
            minimax_workload=minimax, bucket_partitions=partitions
        )

    # -- trivial bounds ----------------------------------------------------

    def _solve_lb(self, data: DispatchData):
        total = sum(j.workload for j in data.jobs)
        return total / data.num_buckets, []

    def _solve_dp(self, data: DispatchData):
        """Optimal minimax via bitmask DP (small n only); no partitions."""
        w = [j.workload for j in data.jobs]
        n = len(w)
        assert n <= 20, "DP algorithm is exponential; use it only for tiny inputs"
        m = 1 << n
        subset_sum = [0.0] * m
        for i, v in enumerate(w):
            bit = 1 << i
            for j in range(bit):
                subset_sum[bit | j] = subset_sum[j] + v
        dp = subset_sum.copy()
        for _ in range(1, data.num_buckets):
            for j in range(m - 1, 0, -1):
                s = j
                while s:
                    cand = max(dp[j ^ s], subset_sum[s])
                    if cand < dp[j]:
                        dp[j] = cand
                    s = (s - 1) & j
        return dp[-1], []

    # -- search-based ------------------------------------------------------

    def _solve_bs(self, data: DispatchData):
        """Binary search on capacity + DFS feasibility; optimal, no count cap."""
        w = [j.workload for j in data.jobs]
        if not w:
            return 0.0, [[] for _ in range(data.num_buckets)]
        order = _argsort_desc(w)
        sw = [w[i] for i in order]
        k = data.num_buckets

        best_partition: list[list[int]] = []

        def feasible(cap: float) -> bool:
            buckets = [0.0] * k
            parts: list[list[int]] = [[] for _ in range(k)]

            def place(i: int) -> bool:
                if i == len(sw):
                    nonlocal best_partition
                    best_partition = [list(p) for p in parts]
                    return True
                seen: set[float] = set()
                for b in range(k):
                    if buckets[b] + sw[i] <= cap and buckets[b] not in seen:
                        seen.add(buckets[b])
                        buckets[b] += sw[i]
                        parts[b].append(i)
                        if place(i + 1):
                            return True
                        buckets[b] -= sw[i]
                        parts[b].pop()
                return False

            return place(0)

        lo, hi = max(sw), sum(sw)
        # integer workloads binary search mirrors the reference; for float
        # workloads fall back to a tolerance loop
        if all(float(x).is_integer() for x in sw):
            lo_i, hi_i = int(lo), int(sum(sw))
            while lo_i < hi_i:
                mid = (lo_i + hi_i) // 2
                if feasible(mid):
                    hi_i = mid
                else:
                    lo_i = mid + 1
            feasible(lo_i)
            minimax = float(lo_i)
        else:
            for _ in range(50):
                mid = (lo + hi) / 2
                if feasible(mid):
                    hi = mid
                else:
                    lo = mid
            feasible(hi)
            minimax = hi
        partitions = [[order[i] for i in p] for p in best_partition]
        return minimax, partitions

    def _solve_btp(self, data: DispatchData):
        """Backtracking+pruning; optimal under equal-job-count constraint."""
        w = [j.workload for j in data.jobs]
        k = data.num_buckets
        n = len(w)
        assert n % k == 0, f"job count {n} must divide num_buckets {k}"
        limit = n // k
        order = _argsort_desc(w)
        sw = [w[i] for i in order]

        nums = [0] * k
        loads = [0.0] * k
        parts: list[list[int]] = [[] for _ in range(k)]
        best = [math.inf]
        best_parts: list[list[int]] = [[] for _ in range(k)]

        def backtrack(i: int, cur_max: float) -> None:
            if i == n:
                if cur_max < best[0]:
                    best[0] = cur_max
                    best_parts[:] = [list(p) for p in parts]
                return
            for b in range(k):
                if nums[b] >= limit:
                    continue
                new_load = loads[b] + sw[i]
                if max(new_load, cur_max) >= best[0]:
                    continue
                nums[b] += 1
                loads[b] += sw[i]
                parts[b].append(i)
                backtrack(i + 1, max(new_load, cur_max))
                nums[b] -= 1
                loads[b] -= sw[i]
                parts[b].pop()
                if nums[b] == 0:
                    break  # symmetry pruning

        backtrack(0, 0.0)
        partitions = [[order[i] for i in p] for p in best_parts]
        return best[0], partitions

    # -- greedy heap family ------------------------------------------------

    def _solve_minheap(self, data: DispatchData):
        """Greedy: each job (desc) goes to the least-loaded non-full bucket;
        bucket capacity = ceil(n / k) jobs (the default algorithm)."""
        w = [j.workload for j in data.jobs]
        k = data.num_buckets
        n = len(w)
        limit = _ceil_div(n, k) if n else 0
        order = _argsort_desc(w)

        loads = [0.0] * k
        nums = [0] * k
        parts: list[list[int]] = [[] for _ in range(k)]
        heap = [(0.0, b) for b in range(k)]
        heapq.heapify(heap)
        for i in order:
            while heap:
                load, b = heapq.heappop(heap)
                if nums[b] < limit:
                    loads[b] = load + w[i]
                    nums[b] += 1
                    parts[b].append(i)
                    heapq.heappush(heap, (loads[b], b))
                    break
            else:
                raise RuntimeError("no bucket available")
        return (max(loads) if loads else 0.0), parts

    def _topp_heap_assign(self, data: DispatchData, top_p: float, batch: int):
        """Shared core of (Batch)ToppHeap: fetch top-m least-loaded buckets,
        choose the one with closest affinity; equal job counts enforced."""
        jobs = data.jobs
        k = data.num_buckets
        n = len(jobs)
        assert n % k == 0, f"job count {n} must divide num_buckets {k}"
        limit = n // k
        assert 0.0 <= top_p <= 1.0
        m = max(1, math.ceil(k * top_p))
        assert all(j.affinity is not None for j in jobs), (
            "topp-heap requires per-job affinities"
        )
        aff_cls = type(jobs[0].affinity)

        w = [j.workload for j in jobs]
        order = _argsort_desc(w)

        nums = [0] * k
        loads = [0.0] * k
        parts: list[list[int]] = [[] for _ in range(k)]
        bucket_affs = [aff_cls() for _ in range(k)]
        counter = 0  # heap tiebreak
        heap = [(0.0, b, b) for b in range(k)]
        heapq.heapify(heap)

        idx = 0
        while idx < n:
            group = order[idx : idx + batch]
            idx += batch
            # fetch the m least-loaded buckets with spare capacity, continuing
            # until their aggregate spare capacity can absorb the whole group
            cands: list[int] = []
            spare = 0
            while heap and (len(cands) < m or spare < len(group)):
                _, _, b = heapq.heappop(heap)
                if nums[b] < limit:
                    cands.append(b)
                    spare += limit - nums[b]
            if spare < len(group):
                raise RuntimeError("no bucket available for job group")
            # each job in the group goes to its closest candidate with room
            for i in group:
                open_cands = [b for b in cands if nums[b] < limit]
                ci = jobs[i].affinity.get_closest_affinity_idx(
                    [bucket_affs[b] for b in open_cands]
                )
                b = open_cands[ci]
                parts[b].append(i)
                loads[b] += w[i]
                nums[b] += 1
                bucket_affs[b].update(jobs[i].affinity)
            for b in cands:
                counter += 1
                heapq.heappush(heap, (loads[b], k + counter, b))
        return max(loads), parts

    def _solve_topp_heap(self, data: DispatchData):
        return self._topp_heap_assign(data, self.alg.top_p, 1)

    def _solve_batch_topp_heap(self, data: DispatchData):
        return self._topp_heap_assign(
            data, self.alg.top_p, max(1, self.alg.num_of_select_chunk)
        )

    # -- simple orders -----------------------------------------------------

    def _solve_random(self, data: DispatchData):
        w = [j.workload for j in data.jobs]
        k = data.num_buckets
        n = len(w)
        assert n % k == 0, f"job count {n} must divide num_buckets {k}"
        limit = n // k
        idxs = list(range(n))
        random.shuffle(idxs)
        parts = [idxs[b * limit : (b + 1) * limit] for b in range(k)]
        loads = [sum(w[i] for i in p) for p in parts]
        return max(loads), parts

    def _solve_sequential(self, data: DispatchData):
        """Contiguous equal-count split in job order (no balancing)."""
        w = [j.workload for j in data.jobs]
        k = data.num_buckets
        n = len(w)
        limit = _ceil_div(n, k) if n else 0
        parts = [list(range(b * limit, min((b + 1) * limit, n))) for b in range(k)]
        loads = [sum(w[i] for i in p) for p in parts]
        return (max(loads) if loads else 0.0), parts

    def _solve_sorted_sequential(self, data: DispatchData):
        """Sort desc, fill buckets sequentially up to
        allocation_ratio * (total / k) workload, equal job counts."""
        w = [j.workload for j in data.jobs]
        k = data.num_buckets
        n = len(w)
        assert n % k == 0, f"job count {n} must divide num_buckets {k}"
        limit = n // k
        cap = self.alg.allocation_ratio * (sum(w) / k)
        order = _argsort_desc(w)
        parts: list[list[int]] = [[] for _ in range(k)]
        loads = [0.0] * k
        b = 0
        leftovers: list[int] = []
        for i in order:
            while b < k and (
                len(parts[b]) >= limit or (parts[b] and loads[b] + w[i] > cap)
            ):
                b += 1
            if b >= k:
                leftovers.append(i)
                continue
            parts[b].append(i)
            loads[b] += w[i]
        # distribute leftovers to least-loaded non-full buckets
        for i in leftovers:
            cands = [b for b in range(k) if len(parts[b]) < limit]
            tgt = min(cands, key=lambda b: loads[b])
            parts[tgt].append(i)
            loads[tgt] += w[i]
        return max(loads), parts
