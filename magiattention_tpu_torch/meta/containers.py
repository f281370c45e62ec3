"""Planning containers: AttnSlice / AttnChunk / AttnBucket.

The port's own copy of the JAX package's ``meta/containers.py``: the
host-side workload geometry produced by slicing the global mask into
per-chunk pieces and grouping chunks into per-rank buckets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..common.enum import AttnMaskType
from ..common.mask import slice_area
from ..common.range import AttnRange
from ..common.ranges import AttnRanges


@dataclass
class AttnSlice:
    """One (q_range, k_range, mask_type) unit of attention workload."""

    q_range: AttnRange
    k_range: AttnRange
    mask_type: AttnMaskType
    slice_id: Optional[int] = None  # originating global slice, if tracked

    @property
    def area(self) -> int:
        return slice_area(
            self.q_range.start,
            self.q_range.end,
            self.k_range.start,
            self.k_range.end,
            self.mask_type,
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"AttnSlice(q={self.q_range}, k={self.k_range}, "
            f"type={self.mask_type.name.lower()}, area={self.area})"
        )


def truncate_slice_q(
    q_range: AttnRange,
    k_range: AttnRange,
    mask_type: AttnMaskType,
    new_q: AttnRange,
) -> Optional[AttnSlice]:
    """Restrict a slice to a sub-q-interval, preserving mask alignment.

    The defining property of the mask types (reference slice_maker.py): when
    cutting rows [a, b) out of [qs, qe),
      - a causal (bottom-right aligned) bound moves the k *end* with the
        bottom row: new_ke = ke - (qe - b);
      - an inv-causal (top-left aligned) bound moves the k *start* with the
        top row: new_ks = ks + (a - qs).
    Returns None when the cut rows attend no keys at all.
    """
    a, b = new_q.start, new_q.end
    assert q_range.start <= a and b <= q_range.end and a < b
    ks, ke = k_range.start, k_range.end
    if mask_type.is_causal_bound:
        ke = ke - (q_range.end - b)
    if mask_type.is_inv_causal_bound:
        ks = ks + (a - q_range.start)
    if ke <= ks:
        return None
    return AttnSlice(AttnRange(a, b), AttnRange(ks, ke), mask_type)


@dataclass
class AttnChunk:
    """One contiguous q-interval of chunk_size rows + its mask slices."""

    chunk_id: int
    q_range: AttnRange
    attn_slices: list[AttnSlice] = field(default_factory=list)
    sample_ids: list[int] = field(default_factory=list)  # per-slice global ids

    @property
    def area(self) -> int:
        return sum(s.area for s in self.attn_slices)

    @property
    def k_ranges(self) -> AttnRanges:
        out = AttnRanges()
        for s in self.attn_slices:
            out.append(s.k_range.clone())
        return out


@dataclass
class AttnBucket:
    """The chunks assigned to one cp rank."""

    cp_rank: Optional[int] = None
    q_chunks: list[AttnChunk] = field(default_factory=list)

    @property
    def area(self) -> int:
        return sum(c.area for c in self.q_chunks)

    @property
    def q_ranges(self) -> AttnRanges:
        out = AttnRanges()
        for c in self.q_chunks:
            out.append(c.q_range.clone())
        return out

    @property
    def k_ranges(self) -> AttnRanges:
        out = AttnRanges()
        for c in self.q_chunks:
            out.extend(c.k_ranges)
        return out

    @property
    def attn_slices(self) -> list[AttnSlice]:
        return [s for c in self.q_chunks for s in c.attn_slices]
