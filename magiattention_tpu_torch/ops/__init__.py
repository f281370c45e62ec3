"""Host kernel planning, LSE correction and flex attention (forward and
backward, row-major and sparse grids), and the block-sparse, index and
sparse-load entry points over it."""

from .block_meta import FlexAttnBlockMeta, build_block_meta
from .block_sparse import (
    BlockEnumeration,
    TickEnumeration,
    TickSegment,
    block_sparse_attn_func,
    build_block_meta_from_block_mask,
    build_block_meta_from_occupancy,
)
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
from .index_attn import index_attn_func, sparse_load_attn_func

__all__ = [
    "BlockEnumeration",
    "FlexAttnBlockMeta",
    "FlexAttnParams",
    "TickEnumeration",
    "TickSegment",
    "auto_kernel_config",
    "block_sparse_attn_func",
    "build_block_meta",
    "build_block_meta_from_block_mask",
    "build_block_meta_from_occupancy",
    "correct_attn_lse",
    "correct_attn_lse_with_sink",
    "correct_attn_out",
    "correct_attn_out_lse",
    "correct_attn_out_lse_with_sink",
    "correct_attn_out_with_sink",
    "flex_attn_with_meta",
    "flex_flash_attn_func",
    "index_attn_func",
    "merge_partials",
    "safe_lse_merge",
    "sparse_load_attn_func",
]
