"""The dispatch solver (chunks -> cp ranks), the overlap solver (remote
rows -> stages) and the dynamic solvers (the attention plane -> cp
regions, for qo-comm)."""

from .dispatch_solver import DispatchConfig, DispatchSolver, MinHeapDispatchAlg
from .dynamic_attn_solver import (
    AutoDynamicSolver,
    DynamicAttnSolution,
    DynamicAttnSolver,
    GridLocalitySolver,
    LocalityGreedySolver,
    NCQDynamicSolver,
    dynamic_solver_for,
    modeled_step_cost,
    rank_comm_rows,
)
from .overlap_solver import OverlapConfig, OverlapSolver, simulate_overlap_timeline
from .snf_solver import SNFDynamicSolver

__all__ = [
    "AutoDynamicSolver",
    "DispatchConfig",
    "DispatchSolver",
    "DynamicAttnSolution",
    "DynamicAttnSolver",
    "GridLocalitySolver",
    "LocalityGreedySolver",
    "MinHeapDispatchAlg",
    "NCQDynamicSolver",
    "OverlapConfig",
    "OverlapSolver",
    "SNFDynamicSolver",
    "dynamic_solver_for",
    "modeled_step_cost",
    "rank_comm_rows",
    "simulate_overlap_timeline",
]
