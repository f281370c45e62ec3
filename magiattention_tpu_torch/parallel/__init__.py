"""Context parallelism over ``torch.distributed``: dispatch / undispatch
and the distributed flex-attention plan and runtime."""

from .dispatch import dispatch, position_ids, undispatch
from .dist_attn import (
    DistAttnPlan,
    StagePlan,
    StageTables,
    build_dist_attn_plan,
    dist_attn_local,
    make_attn_params,
    rank_tables,
)

__all__ = [
    "DistAttnPlan",
    "StagePlan",
    "StageTables",
    "build_dist_attn_plan",
    "dispatch",
    "dist_attn_local",
    "make_attn_params",
    "position_ids",
    "rank_tables",
    "undispatch",
]
