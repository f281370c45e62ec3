"""Host-side planning: the dispatch containers, the dispatch metas
(self-attention, and cross-attention's two roles) and the
solvers (``meta/solver``) that balance chunks over cp ranks, split
remote work into overlap stages and, for qo-comm, cut the attention plane
into cp regions; and the mask canonicalisation and plan fingerprints of
bucketed plan reuse."""

from .containers import AttnBucket, AttnChunk, AttnSlice
from .dispatch_meta import (
    DispatchMeta,
    make_cross_attn_dispatch_meta,
    make_dispatch_meta_from_qk_ranges,
    make_global_bucket_from_qk_ranges,
)
from .plan_fingerprint import (
    CanonicalMask,
    PlanFingerprint,
    PlanReuseCache,
    ReuseEntry,
    RowMaps,
    bucket_len,
    canonicalize_mask,
    make_plan_fingerprint,
    try_incremental_update,
)
from .solver.dynamic_attn_solver import (
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
from .solver.snf_solver import SNFDynamicSolver

__all__ = [
    "AttnBucket",
    "AttnChunk",
    "AttnSlice",
    "AutoDynamicSolver",
    "CanonicalMask",
    "DispatchMeta",
    "DynamicAttnSolution",
    "DynamicAttnSolver",
    "GridLocalitySolver",
    "LocalityGreedySolver",
    "NCQDynamicSolver",
    "PlanFingerprint",
    "PlanReuseCache",
    "ReuseEntry",
    "RowMaps",
    "SNFDynamicSolver",
    "bucket_len",
    "canonicalize_mask",
    "dynamic_solver_for",
    "make_cross_attn_dispatch_meta",
    "make_dispatch_meta_from_qk_ranges",
    "make_global_bucket_from_qk_ranges",
    "make_plan_fingerprint",
    "modeled_step_cost",
    "rank_comm_rows",
    "try_incremental_update",
]
