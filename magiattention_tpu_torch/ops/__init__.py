"""Host kernel planning, LSE correction and flex attention (forward and
backward, row-major and sparse grids)."""

from .block_meta import FlexAttnBlockMeta, build_block_meta
from .correction import (
    correct_attn_lse,
    correct_attn_lse_with_sink,
    correct_attn_out,
    correct_attn_out_lse,
    correct_attn_out_lse_with_sink,
    correct_attn_out_with_sink,
    merge_partials,
    safe_lse_merge,
)
from .flex_attn import (
    FlexAttnParams,
    auto_kernel_config,
    flex_attn_with_meta,
    flex_flash_attn_func,
)

__all__ = [
    "FlexAttnBlockMeta",
    "FlexAttnParams",
    "auto_kernel_config",
    "build_block_meta",
    "correct_attn_lse",
    "correct_attn_lse_with_sink",
    "correct_attn_out",
    "correct_attn_out_lse",
    "correct_attn_out_lse_with_sink",
    "correct_attn_out_with_sink",
    "flex_attn_with_meta",
    "flex_flash_attn_func",
    "merge_partials",
    "safe_lse_merge",
]
