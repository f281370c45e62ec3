"""Simplex-network-flow dynamic solver: the port's copy of the JAX
package's ``meta/solver/snf_solver.py`` (host only, the same float
arithmetic and queue order, so that the flow's ties resolve as JAX's do).

It finds the **minimum per-rank communication budget** T such that

1. a set of comm links — "band i's Q rows are cast to rank r" /
   "band j's KV rows are cast to rank r" — fits every rank's send+recv
   budget T, and
2. under the (q, k)-availability those links create, the grid cells of
   the attention plane admit a **perfectly area-balanced** assignment to
   ranks (a max-flow feasibility certificate),

then, at that budget, prefers home placement (diagonal cells on their own
rank) via a min-cost assignment. One small min-cost max-flow core (SPFA +
blocking augmentation) serves both the feasibility check (zero costs) and
the final home-preferring pass (0/1 costs); links are valued by the
pair-completion area they unlock. ``DynamicAttnAlgType.SIMPLEX_NETWORK_FLOW``
and ``FAST_SIMPLEX_NETWORK_FLOW`` are both served by this one
implementation.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from ...common.rectangle import AttnRectangles
from .dynamic_attn_solver import (
    DynamicAttnSolution,
    _infer_total,
    grid_cells,
)


class _MinCostFlow:
    """Min-cost max-flow on a small static graph (successive shortest
    paths: SPFA distances + blocking-flow augmentation on the equality
    subgraph). Flat edge arrays; O(V*E) per phase — the graphs here are
    2 + cp + #cell-groups nodes, well under a millisecond at cp<=64."""

    def __init__(self, n: int):
        self.n = n
        self.to: list[int] = []
        self.cap: list[float] = []
        self.cost: list[float] = []
        self.head: list[int] = [-1] * n
        self.nxt: list[int] = []

    def add_edge(self, u: int, v: int, cap: float, cost: float = 0.0) -> int:
        """Returns the forward-edge id (flow = cap0 - cap[id] afterwards);
        the reverse edge is always ``id ^ 1``."""
        eid = len(self.to)
        self.to.append(v)
        self.cap.append(cap)
        self.cost.append(cost)
        self.nxt.append(self.head[u])
        self.head[u] = eid
        self.to.append(u)
        self.cap.append(0.0)
        self.cost.append(-cost)
        self.nxt.append(self.head[v])
        self.head[v] = eid + 1
        return eid

    def run(self, s: int, t: int) -> tuple[float, float]:
        total_flow, total_cost = 0.0, 0.0
        n = self.n
        while True:
            # SPFA over residual edges (costs may be negative on reverses)
            dist = [float("inf")] * n
            dist[s] = 0.0
            inq = [False] * n
            queue = deque([s])
            inq[s] = True
            while queue:
                u = queue.popleft()
                inq[u] = False
                e = self.head[u]
                while e != -1:
                    if self.cap[e] > 1e-9:
                        v = self.to[e]
                        nd = dist[u] + self.cost[e]
                        if nd < dist[v] - 1e-9:
                            dist[v] = nd
                            if not inq[v]:
                                queue.append(v)
                                inq[v] = True
                    e = self.nxt[e]
            if dist[t] == float("inf"):
                return total_flow, total_cost
            # blocking augmentation along dist-tight edges (iterative DFS)
            it = list(self.head)
            visiting = [False] * n

            def augment(u: int, limit: float) -> float:
                if u == t or limit <= 1e-9:
                    return limit
                visiting[u] = True
                pushed = 0.0
                while it[u] != -1:
                    e = it[u]
                    v = self.to[e]
                    if (
                        not visiting[v]
                        and self.cap[e] > 1e-9
                        and abs(dist[u] + self.cost[e] - dist[v]) < 1e-9
                    ):
                        got = augment(v, min(limit - pushed, self.cap[e]))
                        if got > 1e-9:
                            self.cap[e] -= got
                            self.cap[e ^ 1] += got
                            pushed += got
                            if pushed >= limit - 1e-9:
                                visiting[u] = False
                                return pushed
                    it[u] = self.nxt[e]
                visiting[u] = False
                return pushed

            while True:
                got = augment(s, float("inf"))
                if got <= 1e-9:
                    break
                total_flow += got
                total_cost += got * dist[t]


@dataclasses.dataclass(frozen=True)
class _Link:
    is_q: bool  # True: Q/O link (band -> rank), False: KV link
    band: int
    rank: int
    cost: float  # comm volume charged to both endpoints


class SNFDynamicSolver:
    """Balance-optimal dynamic partition via budget search + flow.

    Parameters
    ----------
    unbalance_rate : allowed max-load / average-load (1.0 = perfect
        balance up to cell granularity, the reference default,
        fast_snf.py:841).
    iters : binary-search iterations over the comm budget.
    num_heads_q / num_heads_kv : relative comm weight of a Q row vs a KV
        row; Q links are additionally charged 2x for the O lse-reduce
        return trip (the runtime's cast + reduce pair, qo_comm.py).
    """

    def __init__(
        self,
        unbalance_rate: float = 1.0,
        iters: int = 14,
        num_heads_q: int = 1,
        num_heads_kv: int = 1,
        max_cell_frac: float = 0.25,
    ):
        assert unbalance_rate >= 1.0
        self.unbalance_rate = unbalance_rate
        self.iters = iters
        self.hq = num_heads_q
        self.hkv = num_heads_kv
        self.max_cell_frac = max_cell_frac

    # -- link candidates ---------------------------------------------------

    def _candidate_links(self, cp: int, band_len: list[int]) -> list[_Link]:
        links = []
        for b in range(cp):
            if band_len[b] == 0:
                continue
            for r in range(cp):
                if r == b:
                    continue
                links.append(_Link(True, b, r, 2.0 * self.hq * band_len[b]))
                links.append(_Link(False, b, r, float(self.hkv * band_len[b])))
        return links

    def _select_links(
        self,
        links: list[_Link],
        cp: int,
        budget: float,
        cells: list[tuple[float, int, int, int]],
        assign: dict[int, int],
    ) -> list[_Link]:
        """Greedy value/cost selection under per-rank send+recv budgets.

        A link's value is the cell area it *completes*: for a Q link
        (i -> r), cells (i, j) whose KV side is already at r (j == r, or
        the previous round's assignment put them on r) become computable
        at r; symmetrically for KV links. Unassigned area contributes
        1/(2*cp) of itself (it could end up anywhere, and completing it
        needs the other side's link half the time)."""
        row_area: dict[int, float] = {}
        col_area: dict[int, float] = {}
        by_q: dict[tuple[int, int], float] = {}
        by_k: dict[tuple[int, int], float] = {}
        for area, i, j, cid in cells:
            row_area[i] = row_area.get(i, 0.0) + area
            col_area[j] = col_area.get(j, 0.0) + area
            r = assign.get(cid, -1)
            if r >= 0:
                by_q[(i, r)] = by_q.get((i, r), 0.0) + area
                by_k[(j, r)] = by_k.get((j, r), 0.0) + area
            else:
                # unassigned: complete-at-k-home for the q link and vice
                # versa, else spread
                by_q[(i, j)] = by_q.get((i, j), 0.0) + area
                by_k[(j, i)] = by_k.get((j, i), 0.0) + area
        scored = []
        for l in links:
            if l.is_q:
                v = by_q.get((l.band, l.rank), 0.0) + row_area.get(
                    l.band, 0.0
                ) / (2.0 * cp)
            else:
                v = by_k.get((l.band, l.rank), 0.0) + col_area.get(
                    l.band, 0.0
                ) / (2.0 * cp)
            scored.append((v / max(l.cost, 1e-9), l))
        scored.sort(key=lambda x: -x[0])
        used = [0.0] * cp
        chosen = []
        for _, l in scored:
            if used[l.band] + l.cost <= budget and used[l.rank] + l.cost <= budget:
                used[l.band] += l.cost
                used[l.rank] += l.cost
                chosen.append(l)
        return chosen

    # -- assignment via flow ----------------------------------------------

    @staticmethod
    def _masks(
        chosen: list[_Link], cp: int
    ) -> tuple[list[int], list[int]]:
        qmask = [1 << b for b in range(cp)]
        kmask = [1 << b for b in range(cp)]
        for l in chosen:
            if l.is_q:
                qmask[l.band] |= 1 << l.rank
            else:
                kmask[l.band] |= 1 << l.rank
        return qmask, kmask

    def _assign(
        self,
        cells: list[tuple[float, int, int, int]],
        qmask: list[int],
        kmask: list[int],
        cp: int,
        area_avg: float,
        home_cost: bool,
    ) -> tuple[bool, dict[int, int]]:
        """Flow the cell areas into rank capacities.

        ``home_cost=False``: pure feasibility (can the allowed masks carry
        a balanced assignment?). ``home_cost=True``: 0/1-cost variant that
        maximizes the area staying on its home rank at equal balance."""
        groups: dict[tuple[int, int], float] = {}
        for area, i, j, _cid in cells:
            mask = qmask[i] & kmask[j]
            if mask == 0:
                return False, {}
            home = i if i == j else -1
            groups[(mask, home)] = groups.get((mask, home), 0.0) + area
        keys = sorted(groups)
        total_area = sum(groups.values())
        cap = area_avg * self.unbalance_rate + 1e-6

        src, dst = 0, 1
        rank0, grp0 = 2, 2 + cp
        net = _MinCostFlow(grp0 + len(keys))
        for r in range(cp):
            net.add_edge(src, rank0 + r, cap)
        grp_edges: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for g, key in enumerate(keys):
            mask, home = key
            area = groups[key]
            edges = []
            for r in range(cp):
                if (mask >> r) & 1:
                    cost = 0.0 if (not home_cost or r == home) else 1.0
                    eid = net.add_edge(rank0 + r, grp0 + g, area, cost)
                    edges.append((r, eid))
            grp_edges[key] = edges
            net.add_edge(grp0 + g, dst, area)
        flow, _ = net.run(src, dst)
        ok = flow >= total_area - max(1e-3, 1e-6 * total_area)

        # recover: per-group per-rank flow -> per-cell rank (largest
        # remaining flow first; cells are atomic so recovery rounds to
        # cell granularity)
        remaining: dict[tuple[int, int], dict[int, float]] = {}
        for key, edges in grp_edges.items():
            remaining[key] = {}
            for r, eid in edges:
                pushed = groups[key] - net.cap[eid]
                if pushed > 1e-9:
                    remaining[key][r] = pushed
        assign: dict[int, int] = {}
        for area, i, j, cid in sorted(cells, key=lambda c: -c[0]):
            key = (qmask[i] & kmask[j], i if i == j else -1)
            pool = remaining.get(key, {})
            if not pool:
                assign[cid] = i  # fall back to q home
                continue
            best = max(pool, key=pool.__getitem__)
            assign[cid] = best
            pool[best] -= area
            if pool[best] <= 1e-9:
                del pool[best]
        return ok, assign

    # -- public ------------------------------------------------------------

    def solve(
        self,
        rects: AttnRectangles,
        cp_size: int,
        total_seqlen: int | None = None,
    ) -> DynamicAttnSolution:
        total = _infer_total(rects, total_seqlen)
        cp = cp_size
        if rects.area == 0 or cp == 1:
            parts = [rects] + [AttnRectangles() for _ in range(cp - 1)]
            return DynamicAttnSolution(rank_rects=tuple(parts))
        shard = -(-total // cp)
        band_len = [
            max(0, min((r + 1) * shard, total) - r * shard) for r in range(cp)
        ]
        units = grid_cells(rects, cp, shard, total)
        area_avg = sum(a for a, _, _, _, _, _ in units) / cp

        # subdivide oversized cells along q: the flow splits area
        # fractionally but recovery assigns whole cells, so the atom size
        # bounds the achievable balance (reference inherits the same
        # granularity from its KD grid split; smaller atoms are free here)
        cap_area = max(area_avg * self.max_cell_frac, 1.0)
        cells: list[tuple[float, int, int, int]] = []
        cell_rects: list[AttnRectangles] = []
        stack = [(cell, i, j) for _, i, j, cell, _, _ in units]
        while stack:
            cell, i, j = stack.pop()
            q_lo = min(r.q_range.start for r in cell)
            q_hi = max(r.q_range.end for r in cell)
            if cell.area > cap_area and q_hi - q_lo > 1:
                left, right = cell.cut_q((q_lo + q_hi) // 2)
                for piece in (left, right):
                    if piece.area > 0:
                        stack.append((piece, i, j))
                continue
            cells.append((float(cell.area), i, j, len(cell_rects)))
            cell_rects.append(cell)

        links = self._candidate_links(cp, band_len)
        t_hi = 2.0 * self.hq * sum(band_len) + 2.0 * self.hkv * sum(band_len)

        # binary search the minimal feasible budget
        lo, hi = 0.0, t_hi
        best: tuple[float, dict] | None = None
        prev_assign: dict[int, int] = {}
        for it in range(self.iters):
            mid = (lo + hi) / 2.0
            if it == 0:
                chosen = links  # t_hi admits everything; skip selection
                mid = t_hi
            else:
                chosen = self._select_links(
                    links, cp, mid, cells, prev_assign
                )
            qmask, kmask = self._masks(chosen, cp)
            ok, assign = self._assign(
                cells, qmask, kmask, cp, area_avg, home_cost=False
            )
            if ok:
                best = (mid, assign)
                hi = mid
            else:
                lo = mid
            if assign:
                prev_assign = assign
            if hi - lo <= 1e-2 * max(hi, 1.0) and lo > 0:
                break

        if best is None:
            # even the full link set failed (can't happen: full masks make
            # every cell placeable anywhere) — NCQ-style q-home fallback
            assign = {cid: i for _, i, _j, cid in cells}
        else:
            # final pass at the found budget: same balance, most area home
            budget, assign = best
            chosen = self._select_links(links, cp, budget, cells, assign)
            qmask, kmask = self._masks(chosen, cp)
            ok, better = self._assign(
                cells, qmask, kmask, cp, area_avg, home_cost=True
            )
            if ok:
                assign = better

        buckets = [AttnRectangles() for _ in range(cp)]
        for cid, r in assign.items():
            buckets[r].extend(cell_rects[cid])
        return DynamicAttnSolution(rank_rects=tuple(buckets))
