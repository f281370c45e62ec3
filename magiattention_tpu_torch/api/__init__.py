"""The port's public API: the mask and padding helpers of
``api/functools.py`` and the keyed context-parallel runtime of
``api/interface.py`` (``magi_attn_flex_key`` / ``magi_attn_varlen_key`` ->
``dispatch`` -> ``calc_attn`` -> ``undispatch``)."""

from .functools import (
    compute_pad_size,
    full_attention_mask,
    infer_attn_mask_from_cu_seqlens,
    infer_varlen_mask_from_batch,
    infer_window_mask_per_range,
    pad_at_dim,
    unpad_at_dim,
)
from .interface import (
    DistAttnRuntimeKey,
    DistAttnRuntimeMgr,
    calc_attn,
    dispatch,
    get_most_recent_key,
    get_position_ids,
    get_runtime_mgr,
    magi_attn_flex_key,
    magi_attn_varlen_key,
    undispatch,
)

__all__ = [
    "DistAttnRuntimeKey",
    "DistAttnRuntimeMgr",
    "calc_attn",
    "compute_pad_size",
    "dispatch",
    "full_attention_mask",
    "get_most_recent_key",
    "get_position_ids",
    "get_runtime_mgr",
    "infer_attn_mask_from_cu_seqlens",
    "infer_varlen_mask_from_batch",
    "infer_window_mask_per_range",
    "magi_attn_flex_key",
    "magi_attn_varlen_key",
    "pad_at_dim",
    "undispatch",
    "unpad_at_dim",
]
