"""Enums shared across the port.

``AttnMaskType``'s int codes are the kernel ABI, unchanged from the JAX
package: 0=FULL, 1=CAUSAL, 2=INVCAUSAL, 3=BICAUSAL, so that bit 0 = "causal
lower bound" and bit 1 = "inv-causal upper bound", which the kernels read
directly from the slice-bounds table.
"""

from __future__ import annotations

import enum


class AttnMaskType(enum.IntEnum):
    """Unit mask types applied per (q_range, k_range) attention slice.

    CAUSAL    : bottom-right aligned — allow iff (k - k_end) <= (q - q_end),
                i.e. the *last* q row sees the whole k_range.
    INVCAUSAL : top-left aligned — allow iff (k - k_start) >= (q - q_start),
                i.e. the *first* q row sees the whole k_range.
    BICAUSAL  : intersection of CAUSAL and INVCAUSAL.
    FULL      : every q in q_range attends every k in k_range.
    """

    FULL = 0
    CAUSAL = 1
    INVCAUSAL = 2
    BICAUSAL = 3

    @property
    def is_causal_bound(self) -> bool:
        return bool(self.value & 1)

    @property
    def is_inv_causal_bound(self) -> bool:
        return bool(self.value & 2)


class DispatchAlgType(enum.Enum):
    """Load-balancing algorithms of the dispatch solver
    (``meta/solver/dispatch_solver.py``)."""

    LOWER_BOUND = "lower_bound"
    DYNAMIC_PROGRAMMING = "dynamic_programming"
    BINARY_SEARCH = "binary_search"
    MIN_HEAP = "min_heap"
    BACKTRACK_PRUNING = "backtrack_pruning"
    TOPP_HEAP = "topp_heap"
    RANDOM_SELECT = "random_select"
    SEQUENTIAL_SELECT = "sequential_select"
    BATCH_TOPP_HEAP = "batch_topp_heap"
    SORTED_SEQUENTIAL_SELECT = "sorted_sequential_select"


class OverlapAlgType(enum.Enum):
    """Stage-assignment algorithms of the overlap solver
    (``meta/solver/overlap_solver.py``)."""

    UNIFORM = "uniform"
    GREEDY = "greedy"


class DynamicAttnAlgType(enum.Enum):
    """Partitions of the attention plane for qo-comm
    (``meta/solver/dynamic_attn_solver.py::dynamic_solver_for``)."""

    BINARY_GREEDY_PARALLEL = "binary_greedy_parallel"
    BINARY_GREEDY = "binary_greedy"
    FAST_SIMPLEX_NETWORK_FLOW = "fast_simplex_network_flow"
    SIMPLEX_NETWORK_FLOW = "simplex_network_flow"
    GREEDY_RANDOM_GRID = "greedy_random_grid"
    NON_COMMUNICATION_QO = "non_communication_qo"
