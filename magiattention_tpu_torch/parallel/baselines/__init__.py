"""The cp baselines (reference ``exps/dist_attn/baselines/``): ring
attention, Ulysses, USP (Ulysses x ring over two subgroups), the LoongTrain
double ring, Megatron-style hybrid cp (zigzag all-gather), and the NSA /
USP-NSA sparse-attention baselines: the comparison points of MagiAttention's
zero-redundant GroupCast. Each ``make_*_attn_fn(plan, group(s), params)``
returns ``fn(q, k, v)`` on this rank's shard, differentiable through the
comm layer's collectives and the flex kernels."""

from .hybrid_dcp import (
    HybridDcpPlan,
    build_hybrid_dcp_plan,
    hybrid_dcp_attn_local,
    make_hybrid_dcp_attn_fn,
    zigzag_dispatch,
    zigzag_undispatch,
)
from .loongtrain import (
    DoubleRingPlan,
    build_double_ring_plan,
    double_ring_attn_local,
    make_double_ring_attn_fn,
)
from .nsa import NsaConfig, make_usp_nsa_attn_fn, nsa_attn
from .ring import RingAttnPlan, build_ring_attn_plan, make_ring_attn_fn, ring_attn_local
from .ulysses import (
    UlyssesPlan,
    build_ulysses_plan,
    make_ulysses_attn_fn,
    ulysses_attn_local,
)
from .usp import USPPlan, build_usp_plan, make_usp_attn_fn, usp_attn_local

__all__ = [
    "DoubleRingPlan",
    "HybridDcpPlan",
    "NsaConfig",
    "RingAttnPlan",
    "UlyssesPlan",
    "USPPlan",
    "build_double_ring_plan",
    "build_hybrid_dcp_plan",
    "build_ring_attn_plan",
    "build_ulysses_plan",
    "build_usp_plan",
    "double_ring_attn_local",
    "hybrid_dcp_attn_local",
    "make_double_ring_attn_fn",
    "make_hybrid_dcp_attn_fn",
    "make_ring_attn_fn",
    "make_ulysses_attn_fn",
    "make_usp_attn_fn",
    "make_usp_nsa_attn_fn",
    "nsa_attn",
    "ring_attn_local",
    "ulysses_attn_local",
    "usp_attn_local",
    "zigzag_dispatch",
    "zigzag_undispatch",
]
