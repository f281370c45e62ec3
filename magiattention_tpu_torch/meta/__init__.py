"""Host-side planning: the dispatch containers, the dispatch meta and the
solvers (``meta/solver``) that balance chunks over cp ranks and split
remote work into overlap stages."""

from .containers import AttnBucket, AttnChunk, AttnSlice
from .dispatch_meta import (
    DispatchMeta,
    make_dispatch_meta_from_qk_ranges,
    make_global_bucket_from_qk_ranges,
)

__all__ = [
    "AttnBucket",
    "AttnChunk",
    "AttnSlice",
    "DispatchMeta",
    "make_dispatch_meta_from_qk_ranges",
    "make_global_bucket_from_qk_ranges",
]
