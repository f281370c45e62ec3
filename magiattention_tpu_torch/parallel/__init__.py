"""Context parallelism over ``torch.distributed``: dispatch / undispatch
and roll, the padded-index adapters of bucketed plan reuse, the
distributed flex-attention plan and runtime (K/V comm, flat or
hierarchical over (inter, intra) subgroups, self- or cross-attention),
and qo-comm (a dynamic partition of the attention plane, Q/O moving as
well)."""

from .dispatch import (
    PaddedDispatch,
    dispatch,
    padded_dispatch_indices,
    padded_position_ids,
    padded_undispatch_indices,
    position_ids,
    roll,
    roll_plan,
    undispatch,
)
from .dist_attn import (
    DistAttnPlan,
    StagePlan,
    StageTables,
    build_dist_attn_plan,
    dist_attn_local,
    make_attn_params,
    rank_tables,
)
from .qo_comm import QoCommPlan, build_qo_comm_plan, qo_comm_attn_local, qo_rank_tables

__all__ = [
    "DistAttnPlan",
    "PaddedDispatch",
    "QoCommPlan",
    "StagePlan",
    "StageTables",
    "build_dist_attn_plan",
    "build_qo_comm_plan",
    "dispatch",
    "dist_attn_local",
    "make_attn_params",
    "padded_dispatch_indices",
    "padded_position_ids",
    "padded_undispatch_indices",
    "position_ids",
    "qo_comm_attn_local",
    "qo_rank_tables",
    "rank_tables",
    "roll",
    "roll_plan",
    "undispatch",
]
