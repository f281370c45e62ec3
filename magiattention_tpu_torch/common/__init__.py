"""Common host-side types: the mask-type enum, dense-mask semantics and
slice areas, the range algebra and the rectangles the planners cut."""

from .enum import AttnMaskType, DispatchAlgType, DynamicAttnAlgType, OverlapAlgType
from .mask import make_attn_mask_from_ranges, slice_area, slice_mask
from .range import AttnRange, NaiveRange, RangeError
from .ranges import AttnRanges
from .rectangle import AttnRectangle, AttnRectangles

__all__ = [
    "AttnMaskType",
    "AttnRange",
    "AttnRanges",
    "AttnRectangle",
    "AttnRectangles",
    "DispatchAlgType",
    "DynamicAttnAlgType",
    "NaiveRange",
    "OverlapAlgType",
    "RangeError",
    "make_attn_mask_from_ranges",
    "slice_area",
    "slice_mask",
]
