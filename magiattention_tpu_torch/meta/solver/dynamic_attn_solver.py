"""Dynamic (qo-comm) solvers: partition the attention plane itself across
ranks. The port's copy of the JAX package's
``meta/solver/dynamic_attn_solver.py``, host only; its solutions are the
JAX solvers' for the same inputs, rank for rank and rectangle for
rectangle.

Instead of assigning whole q-chunks (the dispatch solver), the workload is
modelled as ``AttnRectangles`` in the (q, k) plane and cut into cp regions
— the planning core of qo-comm, where both Q/O and K/V move:

- :class:`DynamicAttnSolver` — binary-greedy KD split (default): recursive
  halving with alternating q/k cut lines placed by binary search. Best
  pure area balance; placement-oblivious.
- :class:`NCQDynamicSolver` — zero Q/O comm: cut only along the host
  q-shard boundaries so every rank computes exactly its own q rows; only
  K/V moves.
- :class:`LocalityGreedySolver` — balance/locality trade-off: cut work
  units at host boundaries, then greedily assign largest-first to the
  rank minimizing load + penalty x non-local Q/KV rows.
- :class:`GridLocalitySolver` — cut at host q AND k boundaries into grid
  cells, then a dedup-aware greedy with random restarts: comm is counted
  on the MERGED per-rank row sets (what a group cast actually sends).

The flow-based SNF solver lives in :mod:`.snf_solver`;
:func:`dynamic_solver_for` maps every ``DynamicAttnAlgType`` member to its
implementation, and :class:`AutoDynamicSolver` keeps the candidate with
the least :func:`modeled_step_cost`.
"""

from __future__ import annotations

import dataclasses
import random

from ...common.ranges import AttnRanges
from ...common.rectangle import AttnRectangles


@dataclasses.dataclass(frozen=True)
class DynamicAttnSolution:
    """Per-rank workload regions; areas sum exactly to the input area."""

    rank_rects: tuple[AttnRectangles, ...]

    @property
    def areas(self) -> tuple[int, ...]:
        return tuple(r.area for r in self.rank_rects)

    @property
    def balance_ratio(self) -> float:
        areas = self.areas
        total = sum(areas)
        if total == 0:
            return 1.0
        return max(areas) / (total / len(areas))


class DynamicAttnSolver:
    """Binary-greedy KD partition (reference BinaryGreedyParallel default)."""

    def __init__(self, alternate: bool = True):
        self.alternate = alternate

    def solve(
        self, rects: AttnRectangles, cp_size: int, total_seqlen: int | None = None
    ) -> DynamicAttnSolution:
        parts = self._split(rects, cp_size, axis_q=True)
        assert len(parts) == cp_size
        return DynamicAttnSolution(rank_rects=tuple(parts))

    def _split(
        self, rects: AttnRectangles, n: int, axis_q: bool
    ) -> list[AttnRectangles]:
        if n == 1:
            return [rects]
        n_left = n // 2
        frac = n_left / n
        left, right = self._cut_for_fraction(rects, frac, axis_q)
        next_axis = (not axis_q) if self.alternate else axis_q
        return self._split(left, n_left, next_axis) + self._split(
            right, n - n_left, next_axis
        )

    def _cut_for_fraction(
        self, rects: AttnRectangles, frac: float, axis_q: bool
    ) -> tuple[AttnRectangles, AttnRectangles]:
        """Binary-search the cut line so the first side holds ~frac of area."""
        total = rects.area
        if total == 0 or len(rects) == 0:
            return rects, AttnRectangles()
        from ... import csrc

        if csrc.host_enabled():
            # the native probe loop (csrc/entry_table.cpp), bit for bit the
            # Python search below
            pos = csrc.cut_pos_native(rects.to_array(), frac, axis_q)
            return rects.cut_q(pos) if axis_q else rects.cut_k(pos)
        if axis_q:
            lo = min(r.q_range.start for r in rects)
            hi = max(r.q_range.end for r in rects)
            area_left = rects.area_left_of_q
            cut = rects.cut_q
        else:
            lo = min(r.k_range.start for r in rects)
            hi = max(r.k_range.end for r in rects)
            area_left = rects.area_left_of_k
            cut = rects.cut_k
        target = frac * total
        # probe with closed-form areas only; build pieces once at the end
        best_pos, best_err = lo, abs(area_left(lo) - target)
        while lo < hi:
            mid = (lo + hi) // 2
            a = area_left(mid)
            err = abs(a - target)
            if err < best_err:
                best_pos, best_err = mid, err
            if a < target:
                lo = mid + 1
            else:
                hi = mid
        if abs(area_left(lo) - target) < best_err:
            best_pos = lo
        return cut(best_pos)


def _infer_total(rects: AttnRectangles, total_seqlen: int | None) -> int:
    if total_seqlen is not None:
        return total_seqlen
    return max((r.q_range.end for r in rects), default=0)


def grid_cells(
    rects: AttnRectangles, cp_size: int, shard: int, total: int
) -> list[tuple[int, int, int, AttnRectangles, AttnRanges, AttnRanges]]:
    """Cut the plane at every host q- AND k-shard boundary.

    Returns ``(area, q_home, k_home, cell, q_extent, k_extent)`` per
    non-empty cell, extents merged. Shared by the grid-greedy and SNF
    solvers. Raises if the mask extends past ``total`` on either axis
    (a solution's areas must sum exactly to the input area)."""
    cells: list[tuple[int, int, int, AttnRectangles, AttnRanges, AttnRanges]] = []
    rest = rects
    for i in range(cp_size):
        band, rest = rest.cut_q(min((i + 1) * shard, total))
        for j in range(cp_size):
            cell, band = band.cut_k(min((j + 1) * shard, total))
            if cell.area > 0:
                q_ext, k_ext = AttnRanges(), AttnRanges()
                for r in cell:
                    q_ext.append(r.q_range.clone())
                    k_ext.append(r.k_range.clone())
                cells.append(
                    (cell.area, i, j, cell, q_ext.merge(), k_ext.merge())
                )
        if band.area > 0:
            raise ValueError(
                f"mask extends past total_seqlen={total} on k "
                f"(leftover area {band.area})"
            )
    if rest.area > 0:
        raise ValueError(
            f"mask extends past total_seqlen={total} on q "
            f"(leftover area {rest.area})"
        )
    return cells


class NCQDynamicSolver:
    """Zero-Q/O-communication partition (role of reference ncq.py): every
    rank keeps exactly the attention rows of its own contiguous q shard,
    so Q and O never move — only KV is cast. Area balance is whatever the
    mask shape dictates."""

    def solve(
        self, rects: AttnRectangles, cp_size: int, total_seqlen: int | None = None
    ) -> DynamicAttnSolution:
        total = _infer_total(rects, total_seqlen)
        shard = -(-total // cp_size)
        parts: list[AttnRectangles] = []
        rest = rects
        for r in range(cp_size - 1):
            left, rest = rest.cut_q((r + 1) * shard)
            parts.append(left)
        parts.append(rest)
        return DynamicAttnSolution(rank_rects=tuple(parts))


class LocalityGreedySolver:
    """Balance/locality tradeoff (role of the reference snf / fast_snf /
    grg algorithms): work units are the mask rectangles cut at host
    q-shard boundaries (each unit has a home rank); units are assigned
    largest-first to the rank minimizing

        load[rank] + penalty_qo * qo_rows + penalty_kv * kv_rows

    where qo_rows is the unit's q extent when placed off its home rank and
    kv_rows the part of its k extent outside the rank's k shard. With both
    penalties 0 this degenerates to pure greedy balance; with a dominant
    qo penalty it reproduces :class:`NCQDynamicSolver` placement.
    """

    def __init__(
        self,
        penalty_qo_rows_to_area: float | None = None,
        penalty_kv_rows_to_area: float | None = None,
        max_unit_frac: float = 0.25,
    ):
        self.penalty_qo = penalty_qo_rows_to_area
        self.penalty_kv = penalty_kv_rows_to_area
        self.max_unit_frac = max_unit_frac

    def solve(
        self, rects: AttnRectangles, cp_size: int, total_seqlen: int | None = None
    ) -> DynamicAttnSolution:
        total = _infer_total(rects, total_seqlen)
        shard = -(-total // cp_size)
        # default penalties: moving one row costs as much area as attending
        # ~1/8 of a shard (comm is cheap relative to compute); Q/O
        # movement also pays the O lse-reduce return trip, so weight it 2x
        pkv = (
            self.penalty_kv if self.penalty_kv is not None else shard / 8
        )
        pqo = (
            self.penalty_qo if self.penalty_qo is not None else shard / 4
        )

        # work units cut at host boundaries, each tagged with its home rank
        units: list[tuple[int, object]] = []
        rest = rects
        for r in range(cp_size):
            left, rest = rest.cut_q(min((r + 1) * shard, total))
            for rect in left:
                units.append((r, rect))
        # refine: halve oversized units along q so balance is reachable
        cap = max(rects.area * self.max_unit_frac / cp_size, 1)
        refined: list[tuple[int, object]] = []
        stack = units
        while stack:
            home, rect = stack.pop()
            if rect.area > cap and rect.q_range.seqlen > 1:
                mid = (rect.q_range.start + rect.q_range.end) // 2
                top, bottom = rect.cut_q(mid)
                for piece in (top, bottom):
                    if piece is not None and piece.area > 0:
                        stack.append((home, piece))
            else:
                refined.append((home, rect))

        refined.sort(key=lambda u: -u[1].area)
        loads = [0.0] * cp_size
        buckets: list[list] = [[] for _ in range(cp_size)]
        for home, rect in refined:
            k0, k1 = rect.k_range.start, rect.k_range.end

            def cost(r: int) -> float:
                qo = 0 if r == home else rect.q_range.seqlen
                k_lo, k_hi = r * shard, (r + 1) * shard
                local_k = max(0, min(k1, k_hi) - max(k0, k_lo))
                kv = (k1 - k0) - local_k
                return loads[r] + pqo * qo + pkv * kv

            best = min(range(cp_size), key=cost)
            loads[best] += rect.area
            buckets[best].append(rect)
        parts = []
        for b in buckets:
            rr = AttnRectangles()
            for rect in b:
                rr.append(rect)
            parts.append(rr)
        return DynamicAttnSolution(rank_rects=tuple(parts))


class GridLocalitySolver:
    """GRG-grade grid partition (role of reference grg/snf/fast_snf).

    The plane is cut at every host q-shard AND k-shard boundary into grid
    cells; cells are assigned to ranks greedily (largest-first) under

        load[rank] + c2a * (2 * added_remote_q + added_remote_kv)

    where ``added_remote_*`` are the NEW rows rank would have to receive:
    rows already in the rank's merged need-set (from earlier cells) or
    inside its own contiguous shard are free — matching what the qo-comm
    runtime's merged group-casts actually transfer. Q movement is
    weighted 2x (cast out + O lse-reduce back, the reference's
    cast/reduce split, grg.py:_eval_greedy_algorithm).

    ``restarts`` greedy passes run with jittered orderings (the "random"
    in greedy-random-grid); the pass with the best global cost wins.
    Deterministic for a fixed seed.
    """

    def __init__(
        self,
        comm_rows_to_area: float | None = None,
        restarts: int = 4,
        seed: int = 0,
    ):
        self.c2a = comm_rows_to_area
        self.restarts = max(1, restarts)
        self.seed = seed

    def solve(
        self,
        rects: AttnRectangles,
        cp_size: int,
        total_seqlen: int | None = None,
    ) -> DynamicAttnSolution:
        total = _infer_total(rects, total_seqlen)
        shard = -(-total // cp_size)
        area_total = rects.area
        if area_total == 0 or cp_size == 1:
            parts = [rects] + [AttnRectangles() for _ in range(cp_size - 1)]
            return DynamicAttnSolution(rank_rects=tuple(parts))
        # a received row is worth this much area: the reference's constant
        # (its TPU ratio of wire time per row to matrix time per (q, k)
        # pair), kept as it is so that the plans stay the JAX package's
        c2a = self.c2a if self.c2a is not None else 1024.0

        units = grid_cells(rects, cp_size, shard, total)
        units.sort(key=lambda u: -u[0])

        rng = random.Random(self.seed)
        best = None
        for trial in range(self.restarts):
            order = list(units)
            if trial:  # jitter: swap nearby entries in the sorted order
                for idx in range(len(order) - 1):
                    if rng.random() < 0.5:
                        order[idx], order[idx + 1] = (
                            order[idx + 1], order[idx],
                        )
            sol = self._greedy(order, cp_size, shard, total, c2a)
            if best is None or sol[0] < best[0]:
                best = sol
        buckets = best[1]
        parts = []
        for b in buckets:
            rr = AttnRectangles()
            for cell in b:
                rr.extend(cell)
            parts.append(rr)
        return DynamicAttnSolution(rank_rects=tuple(parts))

    @staticmethod
    def _added_remote(ext, need, own) -> int:
        """Rows of ``ext`` not already in ``need`` and not in ``own``."""
        added = ext.union_size_with(need) - need.union_size()
        ext_own = ext.find_overlap_ranges(own)
        need_own = need.find_overlap_ranges(own)
        added_local = (
            ext_own.union_size_with(need_own) - need_own.union_size()
        )
        return added - added_local

    def _greedy(self, order, cp, shard, total, c2a):
        loads = [0.0] * cp
        q_need = [AttnRanges() for _ in range(cp)]
        k_need = [AttnRanges() for _ in range(cp)]
        own = [_own_shard_ranges(r, shard, total) for r in range(cp)]
        buckets: list[list[AttnRectangles]] = [[] for _ in range(cp)]
        q_rem = [0] * cp
        kv_rem = [0] * cp
        for area, i, j, cell, q_ext, k_ext in order:
            # candidate ranks: q home, k home, and the least-loaded rank
            # (enough in practice; evaluating all cp ranks barely helps
            # and costs cp x the range ops)
            cands = {i, j, min(range(cp), key=loads.__getitem__)}
            best_r, best_cost, best_dq, best_dk = None, None, 0, 0
            for r in cands:
                dq = self._added_remote(q_ext, q_need[r], own[r])
                dk = self._added_remote(k_ext, k_need[r], own[r])
                cost = loads[r] + area + c2a * (2 * dq + dk)
                if best_cost is None or cost < best_cost - 1e-9:
                    best_r, best_cost, best_dq, best_dk = r, cost, dq, dk
            loads[best_r] += area
            q_need[best_r].extend(q_ext)
            q_need[best_r] = q_need[best_r].merge()
            k_need[best_r].extend(k_ext)
            k_need[best_r] = k_need[best_r].merge()
            buckets[best_r].append(cell)
            q_rem[best_r] += best_dq
            kv_rem[best_r] += best_dk
        # score restarts by the same overlap-aware slowest-rank model the
        # solution is judged on (modeled_step_cost): per rank, comm hides
        # under compute when smaller
        global_cost = max(
            max(loads[r], c2a * (2 * q_rem[r] + kv_rem[r]))
            for r in range(cp)
        )
        return (global_cost, buckets)


def dynamic_solver_for(alg, **kwargs):
    """Factory: a working solver for every ``DynamicAttnAlgType`` member.

    BINARY_GREEDY / BINARY_GREEDY_PARALLEL are one algorithm here (the
    parallelism in the reference name is a CPU-thread detail,
    binary_greedy_parallel.py); SIMPLEX_NETWORK_FLOW and
    FAST_SIMPLEX_NETWORK_FLOW are served by the single flow-based
    implementation (see snf_solver.py header for why the reference's
    ILP backend split is not reproduced)."""
    from ...common.enum import DynamicAttnAlgType as T
    from .snf_solver import SNFDynamicSolver

    table = {
        T.BINARY_GREEDY_PARALLEL: DynamicAttnSolver,
        T.BINARY_GREEDY: DynamicAttnSolver,
        T.FAST_SIMPLEX_NETWORK_FLOW: SNFDynamicSolver,
        T.SIMPLEX_NETWORK_FLOW: SNFDynamicSolver,
        T.GREEDY_RANDOM_GRID: GridLocalitySolver,
        T.NON_COMMUNICATION_QO: NCQDynamicSolver,
    }
    return table[alg](**kwargs)


def _own_shard_ranges(rank: int, shard: int, total: int) -> AttnRanges:
    """Contiguous ownership of one rank, clamped to the sequence — ranks
    entirely past ``total`` (cp_size not dividing total_seqlen) own
    nothing rather than an invalid reversed range."""
    lo = min(rank * shard, total)
    hi = min((rank + 1) * shard, total)
    if lo >= hi:
        return AttnRanges()
    return AttnRanges.from_ranges([(lo, hi)])


def rank_comm_rows(
    sol: DynamicAttnSolution, total_seqlen: int, cp_size: int
) -> list[tuple[int, int]]:
    """Per-rank (q_remote, kv_remote) rows under contiguous ownership —
    the rows the qo-comm runtime's merged group-casts transfer."""
    shard = -(-total_seqlen // cp_size)
    out = []
    for r, rr in enumerate(sol.rank_rects):
        own = _own_shard_ranges(r, shard, total_seqlen)
        qs, ks = AttnRanges(), AttnRanges()
        for rect in rr:
            qs.append(rect.q_range.clone())
            ks.append(rect.k_range.clone())
        qs, ks = qs.merge(), ks.merge()
        out.append(
            (
                qs.total_seqlen - qs.intersect_size_with(own),
                ks.total_seqlen - ks.intersect_size_with(own),
            )
        )
    return out


def modeled_step_cost(
    sol: DynamicAttnSolution,
    total_seqlen: int,
    cp_size: int,
    comm_rows_to_area: float = 1024.0,
) -> float:
    """Overlap-aware step-time model: per rank the comm (cast Q 2x for
    the O return + cast KV) hides under compute when smaller, so rank
    time = max(area, c2a * rows); step time = slowest rank. The default
    c2a = 1024 area-units/row is the reference's h=8/d=128 bf16 ratio of
    wire time per row to matrix time per (q, k) pair, kept unrefitted so
    that the choice stays the JAX package's."""
    rows = rank_comm_rows(sol, total_seqlen, cp_size)
    areas = sol.areas
    return max(
        max(float(a), comm_rows_to_area * (2.0 * q + kv))
        for a, (q, kv) in zip(areas, rows)
    )


class AutoDynamicSolver:
    """Pick the best partition by the modeled step cost.

    Runs every candidate solver (all are host-side, ms-scale) and keeps
    the solution minimizing :func:`modeled_step_cost` — the role of the
    reference's manually-selected algorithm family, made automatic: KD
    wins dense masks (free-position cuts), NCQ wins q-overlap-heavy
    masks (zero Q/O movement), the grid solver the varlen middle ground.
    """

    def __init__(self, comm_rows_to_area: float = 1024.0, candidates=None):
        from .snf_solver import SNFDynamicSolver

        self.c2a = comm_rows_to_area
        self.candidates = candidates or (
            DynamicAttnSolver(),
            NCQDynamicSolver(),
            GridLocalitySolver(comm_rows_to_area=comm_rows_to_area),
            SNFDynamicSolver(),
        )

    def solve(
        self,
        rects: AttnRectangles,
        cp_size: int,
        total_seqlen: int | None = None,
    ) -> DynamicAttnSolution:
        total = _infer_total(rects, total_seqlen)
        best, best_cost = None, None
        for solver in self.candidates:
            sol = solver.solve(rects, cp_size, total_seqlen=total)
            cost = modeled_step_cost(sol, total, cp_size, self.c2a)
            if best_cost is None or cost < best_cost:
                best, best_cost = sol, cost
        return best
