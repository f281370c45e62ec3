"""The kernel autotuner: the port of the JAX package's ``tuning/``, aimed at
the H100.

- :mod:`.fingerprint`: a stable, hashable, bucketed description of a
  workload (extents, heads, dtype, mask-shape statistics, the card);
- :mod:`.cost_model`: the mask counting and the ranking of the kernel
  choices the build can launch (tile, grid, head_block), with an
  efficiency and slot fees fitted on the H100;
- :mod:`.cache`: the process's winners, backed by
  ``MAGI_ATTENTION_AUTOTUNE_CACHE_DIR`` on disk;
- :mod:`.autotuner`: :func:`select_block_config` behind
  ``MAGI_ATTENTION_AUTOTUNE`` (``off`` | ``model`` | ``measure``), the
  decode and tick split tuners, and :func:`resolve_block_config` for the
  keyed cp runtime.

Consumers: ``ops.flex_attn.auto_kernel_config`` / ``auto_block_config``,
``serving.decode_attn.resolve_num_splits``,
``serving.unified_tick.resolve_tick_splits``, ``api.magi_attn_flex_key`` /
``magi_attn_cross_key`` and ``models._common.resolve_harness_blocking``.
"""

from .autotuner import (
    TuningDecision,
    resolve_block_config,
    select_block_config,
    select_decode_splits,
    select_tick_splits,
)
from .cache import TuningCache, TuningRecord, get_tuning_cache, reset_tuning_cache
from .cost_model import (
    SPARSE_DENSITY_THRESHOLD,
    CandidateScore,
    estimate_entries,
    exact_mask_area,
    mask_density,
    rank_candidates,
)
from .fingerprint import (
    DecodeFingerprint,
    TickFingerprint,
    WorkloadFingerprint,
    make_decode_fingerprint,
    make_fingerprint,
    make_tick_fingerprint,
)

__all__ = [
    "CandidateScore",
    "DecodeFingerprint",
    "SPARSE_DENSITY_THRESHOLD",
    "TickFingerprint",
    "TuningCache",
    "TuningDecision",
    "TuningRecord",
    "WorkloadFingerprint",
    "estimate_entries",
    "exact_mask_area",
    "get_tuning_cache",
    "make_decode_fingerprint",
    "make_fingerprint",
    "make_tick_fingerprint",
    "mask_density",
    "rank_candidates",
    "reset_tuning_cache",
    "resolve_block_config",
    "select_block_config",
    "select_decode_splits",
    "select_tick_splits",
]
