"""Group collectives (GroupCast / GroupReduce) and variable-size
primitives over ``torch.distributed``."""

from .group_collective import (
    GroupCast,
    GroupCollectiveMeta,
    group_cast,
    group_reduce_sum,
    rank_routing,
)
from .primitives import all2all_v, all_gather_v, replicated, scatter_v

__all__ = [
    "GroupCast",
    "GroupCollectiveMeta",
    "all2all_v",
    "all_gather_v",
    "group_cast",
    "group_reduce_sum",
    "rank_routing",
    "replicated",
    "scatter_v",
]
