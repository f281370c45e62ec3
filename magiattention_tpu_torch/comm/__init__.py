"""Group collectives (GroupCast, GroupReduce with the sum and LSE ops) and
variable-size primitives over ``torch.distributed``."""

from .group_collective import (
    GroupCast,
    GroupCollectiveMeta,
    ReturnRows,
    group_cast,
    group_reduce_lse,
    group_reduce_sum,
    rank_routing,
    return_rows,
)
from .primitives import all2all_v, all_gather_v, replicated, scatter_v

__all__ = [
    "GroupCast",
    "GroupCollectiveMeta",
    "ReturnRows",
    "all2all_v",
    "all_gather_v",
    "group_cast",
    "group_reduce_lse",
    "group_reduce_sum",
    "rank_routing",
    "replicated",
    "return_rows",
    "scatter_v",
]
