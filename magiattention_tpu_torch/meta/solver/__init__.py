"""The dispatch solver (chunks -> cp ranks) and the overlap solver (remote
rows -> stages)."""

from .dispatch_solver import DispatchConfig, DispatchSolver, MinHeapDispatchAlg
from .overlap_solver import OverlapConfig, OverlapSolver, simulate_overlap_timeline

__all__ = [
    "DispatchConfig",
    "DispatchSolver",
    "MinHeapDispatchAlg",
    "OverlapConfig",
    "OverlapSolver",
    "simulate_overlap_timeline",
]
