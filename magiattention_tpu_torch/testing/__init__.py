"""Testing library: the fp64 dense oracle and its online twin, the precision
assertions, the flag-combination generator, the naive dispatch oracle, the
reference mask workloads (``testing.workloads``) and the rank spawner of
multi-rank runs (``testing.dist``)."""

from .flag_generator import PORT_FLAG_SPACE, FlagCombGenerator
from .gt_dispatcher import GroundTruthDispatcher
from .precision import (
    MISMATCH_THRES_RATIO,
    assert_close,
    assert_close_to_ref,
    calc_inf_norm,
    calc_rel_err,
)
from .ref_attn import ref_attn, ref_attn_from_ranges, ref_attn_online

__all__ = [
    "MISMATCH_THRES_RATIO",
    "PORT_FLAG_SPACE",
    "FlagCombGenerator",
    "GroundTruthDispatcher",
    "assert_close",
    "assert_close_to_ref",
    "calc_inf_norm",
    "calc_rel_err",
    "ref_attn",
    "ref_attn_from_ranges",
    "ref_attn_online",
]
