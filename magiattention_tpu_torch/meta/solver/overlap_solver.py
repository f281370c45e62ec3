"""OverlapSolver: partition remote work into multi-stage-overlap stages.

The port's own copy of the JAX package's ``meta/solver/overlap_solver.py``
(the same plans for an integer degree): given per-chunk
(comm_cost, calc_cost) pairs for a rank's remote KV, assign chunks to
``overlap_degree`` stages so that per-stage communication can hide under the
previous stage's computation. Degree semantics (reference OverlapConfig
:71-157): 0 = no overlap (single blocking merged call), >= 1 = that many
remote stages.

The port realizes the schedule by issuing each stage's group cast on a side
CUDA stream, so that it overlaps the previous stage's kernel
(``parallel/dist_attn.py``); the solver's job is only the partition.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ...common.enum import OverlapAlgType


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """degree=0: no-overlap blocking path (single merged kernel call);
    degree>=1: that many remote stages (1 reproduces degree-0 compute with
    async comm; >=2 is true multi-stage overlap); degree=None: auto — the
    plan builder picks the degree that minimizes a pipelined timeline cost
    model built from the cost factors (reference OverlapConfig degree=None +
    dynamic_max_degree, overlap_solver.py:71-157)."""

    degree: int | None = 0
    alg: OverlapAlgType = OverlapAlgType.UNIFORM
    min_stage_rows: int = 512  # don't create stages smaller than this
    calc_cost_factor: float = 1.0  # sec per unit area (relative ok)
    comm_cost_factor: float = 1.0  # sec per row (relative ok)
    # auto-degree (degree=None) knobs:
    dynamic_max_degree: int = 8  # search 1..this for the best stage count
    max_num_chunks: int = 64  # cap on stage-granularity blocks per rank
    stage_overhead_s: float = 30e-6  # fixed cost per extra stage (launch)
    # sec per row over the slow inter hop of a hierarchical (2-D cp) cast;
    # None = single-level comm (comm_cost_factor covers everything)
    comm_cost_factor_inter: float | None = None


def simulate_overlap_timeline(
    host_calc_s: float,
    stage_comm_s: Sequence[float],
    stage_calc_s: Sequence[float],
    stage_overhead_s: float,
) -> float:
    """Pipelined timeline: casts issue back-to-back in stage order while the
    kernel chain runs concurrently (the side-stream cast model);
    stage i's kernel starts when its cast has landed AND the previous
    kernel finished. Returns the makespan."""
    t_comm_end = 0.0
    t_kernel_end = host_calc_s
    for c, a in zip(stage_comm_s, stage_calc_s):
        t_comm_end += c
        t_kernel_end = max(t_kernel_end, t_comm_end) + a + stage_overhead_s
    return t_kernel_end


@dataclasses.dataclass(frozen=True)
class OverlapStageCost:
    comm_cost: float
    calc_cost: float


@dataclasses.dataclass(frozen=True)
class OverlapSolution:
    # stage_of[i]: stage index assigned to remote chunk i
    stage_of: tuple[int, ...]
    num_stages: int


class OverlapSolver:
    """Assign remote chunks to stages (reference OverlapSolver.solve :222)."""

    def __init__(self, config: OverlapConfig):
        self.config = config

    def solve(
        self,
        chunk_costs: Sequence[OverlapStageCost],
        degree: int | None = None,
    ) -> OverlapSolution:
        n = len(chunk_costs)
        if degree is None:
            degree = self.config.degree
        assert degree is not None, (
            "degree=None (auto) must be resolved by the plan builder before "
            "calling OverlapSolver.solve"
        )
        degree = max(1, degree)
        degree = min(degree, max(n, 1))
        if n == 0:
            return OverlapSolution(stage_of=(), num_stages=degree)
        if self.config.alg == OverlapAlgType.UNIFORM:
            # contiguous equal-count split in chunk order (keeps recv-buffer
            # locality — chunks arrive ordered by (src, position))
            per = -(-n // degree)
            stage_of = tuple(min(i // per, degree - 1) for i in range(n))
            return OverlapSolution(stage_of=stage_of, num_stages=degree)
        # GREEDY: balance total per-stage cost; chunks sorted desc by cost,
        # each to the least-loaded stage
        cost = [
            c.comm_cost * self.config.comm_cost_factor
            + c.calc_cost * self.config.calc_cost_factor
            for c in chunk_costs
        ]
        order = sorted(range(n), key=lambda i: -cost[i])
        loads = [0.0] * degree
        stage_of_l = [0] * n
        for i in order:
            s = min(range(degree), key=lambda j: loads[j])
            stage_of_l[i] = s
            loads[s] += cost[i]
        self._record_quality(loads, degree, n)
        return OverlapSolution(stage_of=tuple(stage_of_l), num_stages=degree)

    @staticmethod
    def _record_quality(stage_loads, degree: int, n_chunks: int) -> None:
        """How evenly the greedy pass spread the weighted chunk costs over
        the stages (max / mean, 1.0 = even), as the JAX package records it.
        A uniform split is structural: nothing to record. The per-rank
        builds overwrite one series: the last plan's."""
        from ... import telemetry

        if not telemetry.enabled():
            return
        mean = sum(stage_loads) / max(degree, 1)
        reg = telemetry.get_registry()
        reg.gauge_set("magi_overlap_solver_chunks", n_chunks)
        reg.gauge_set("magi_overlap_solver_stage_balance_ratio",
                      (max(stage_loads) / mean) if mean else 1.0)


class UniformOverlapAlg:
    """Reference-compat spelling (overlap_solver.py:41): calling it yields
    the enum member our :class:`OverlapConfig` takes —
    ``OverlapConfig(alg=UniformOverlapAlg())`` is drop-in. The reference
    dataclass's fields (random_costs/random_seed etc.) are accepted and
    ignored: its randomized cost probing has no role in the
    deterministic timeline model here."""

    def __new__(cls, *args, **kwargs):
        return OverlapAlgType.UNIFORM


class GreedyOverlapAlg:
    """Reference-compat spelling (overlap_solver.py:58); see
    :class:`UniformOverlapAlg`."""

    def __new__(cls, *args, **kwargs):
        return OverlapAlgType.GREEDY
