"""Group collectives (GroupCast, GroupReduce with the sum and LSE ops),
their hierarchical two-level form over (inter, intra) subgroups, and
variable-size primitives over ``torch.distributed``."""

from .group_collective import (
    GroupCast,
    GroupCollectiveMeta,
    ReturnRows,
    cast_transpose,
    group_cast,
    group_cast_m,
    group_reduce_lse,
    group_reduce_sum,
    rank_routing,
    return_rows,
)
from .hier import (
    GroupCastHier,
    HierCpGroups,
    HierGroupCollectiveMeta,
    HierRouting,
    group_cast_hier,
    group_reduce_hier,
    hier_rank_routing,
    make_hier_cp_groups,
    node_crossing_rows,
)
from .primitives import all2all_v, all_gather_v, replicated, scatter_v

__all__ = [
    "GroupCast",
    "GroupCastHier",
    "GroupCollectiveMeta",
    "HierCpGroups",
    "HierGroupCollectiveMeta",
    "HierRouting",
    "ReturnRows",
    "all2all_v",
    "all_gather_v",
    "cast_transpose",
    "group_cast",
    "group_cast_m",
    "group_cast_hier",
    "group_reduce_hier",
    "group_reduce_lse",
    "group_reduce_sum",
    "hier_rank_routing",
    "make_hier_cp_groups",
    "node_crossing_rows",
    "rank_routing",
    "replicated",
    "return_rows",
    "scatter_v",
]
