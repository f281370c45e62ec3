"""Common host-side types: the mask-type enum, dense-mask semantics, and
the range types the mask helpers return."""

from .enum import AttnMaskType
from .mask import make_attn_mask_from_ranges, slice_mask
from .range import AttnRange, NaiveRange, RangeError
from .ranges import AttnRanges

__all__ = [
    "AttnMaskType",
    "AttnRange",
    "AttnRanges",
    "NaiveRange",
    "RangeError",
    "make_attn_mask_from_ranges",
    "slice_mask",
]
