"""The port's public helpers. This slice has the mask and padding helpers
of ``api/functools.py``; the keyed runtime (``magi_attn_flex_key``,
``dispatch``/``calc_attn``/``undispatch``) is the context-parallel slice's
work (ROADMAP queue A item 9)."""

from .functools import (
    compute_pad_size,
    full_attention_mask,
    infer_attn_mask_from_cu_seqlens,
    infer_varlen_mask_from_batch,
    infer_window_mask_per_range,
    pad_at_dim,
    unpad_at_dim,
)

__all__ = [
    "compute_pad_size",
    "full_attention_mask",
    "infer_attn_mask_from_cu_seqlens",
    "infer_varlen_mask_from_batch",
    "infer_window_mask_per_range",
    "pad_at_dim",
    "unpad_at_dim",
]
