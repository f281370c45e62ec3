"""The port's public API: the mask and padding helpers of
``api/functools.py`` and the keyed context-parallel runtime of
``api/interface.py`` (``magi_attn_flex_key`` / ``magi_attn_varlen_key`` ->
``dispatch`` -> ``calc_attn`` -> ``undispatch``; cross-attention keys with
``dispatch_kv``; new masks on an existing dispatch; ``roll``)."""

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
    XAttnArgs,
    calc_attn,
    dispatch,
    dispatch_kv,
    get_most_recent_key,
    get_position_ids,
    get_runtime_mgr,
    get_xattn_args,
    magi_attn_cross_key,
    magi_attn_flex_key,
    magi_attn_varlen_key,
    make_flex_key_for_new_mask_after_dispatch,
    make_varlen_key_for_new_mask_after_dispatch,
    roll,
    roll_simple,
    undispatch,
    undispatch_kv,
)

__all__ = [
    "DistAttnRuntimeKey",
    "DistAttnRuntimeMgr",
    "XAttnArgs",
    "calc_attn",
    "compute_pad_size",
    "dispatch",
    "dispatch_kv",
    "full_attention_mask",
    "get_most_recent_key",
    "get_position_ids",
    "get_runtime_mgr",
    "get_xattn_args",
    "infer_attn_mask_from_cu_seqlens",
    "infer_varlen_mask_from_batch",
    "infer_window_mask_per_range",
    "magi_attn_cross_key",
    "magi_attn_flex_key",
    "magi_attn_varlen_key",
    "make_flex_key_for_new_mask_after_dispatch",
    "make_varlen_key_for_new_mask_after_dispatch",
    "pad_at_dim",
    "roll",
    "roll_simple",
    "undispatch",
    "undispatch_kv",
    "unpad_at_dim",
]
