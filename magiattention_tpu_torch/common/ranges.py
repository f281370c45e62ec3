"""AttnRanges: an ordered collection of AttnRange intervals.

The port's own copy of the JAX package's ``common/ranges.py`` (pure host
Python, kept line for line): the set algebra (merge, chunk, hole and
overlap ranges, local-coordinate translation) the dispatch solver and the
plan builder call.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterator, Sequence, Union

import numpy as np

from .range import AttnRange, NaiveRange, RangeError

NaiveRanges = Sequence[NaiveRange]


def is_valid_cu_seqlens(cu_seqlens: Sequence[int], seq_len: int) -> bool:
    """True iff cu_seqlens is a non-decreasing [0, ..., seq_len] prefix list."""
    if len(cu_seqlens) == 0:
        return False
    if cu_seqlens[0] != 0 or cu_seqlens[-1] != seq_len:
        return False
    return all(a <= b for a, b in zip(cu_seqlens, cu_seqlens[1:]))


def check_valid_cu_seqlens(cu_seqlens: Sequence[int], seq_len: int) -> None:
    if not is_valid_cu_seqlens(cu_seqlens, seq_len):
        raise ValueError(
            f"invalid cu_seqlens {cu_seqlens} for total seqlen {seq_len}"
        )


class AttnRanges:
    """A list of AttnRange with interval set-algebra.

    Unless a method says otherwise, ranges may be unsorted / overlapping;
    predicates (:meth:`is_sorted`, :meth:`is_merged`, :meth:`is_non_overlap`)
    report the current state.
    """

    __slots__ = ("_ranges",)

    def __init__(self) -> None:
        self._ranges: list[AttnRange] = []

    # -- construction ------------------------------------------------------

    @classmethod
    def from_ranges(cls, ranges, check: bool = False) -> "AttnRanges":
        """Build from a sequence of AttnRange or (start, end) 2-sequences."""
        out = cls()
        for r in ranges:
            if isinstance(r, AttnRange):
                out.append(r.clone(), check=check)
            else:
                out.append(AttnRange.from_range(r, check=check), check=check)
        return out

    @classmethod
    def from_cu_seqlens(cls, cu_seqlens: Sequence[int], seq_len: int) -> "AttnRanges":
        """Build consecutive ranges from a cumulative-seqlen prefix list."""
        check_valid_cu_seqlens(cu_seqlens, seq_len)
        out = cls()
        for s, e in zip(cu_seqlens, cu_seqlens[1:]):
            out.append(AttnRange(s, e))
        return out

    def clone(self) -> "AttnRanges":
        out = AttnRanges()
        out._ranges = [r.clone() for r in self._ranges]
        return out

    # -- list ops ----------------------------------------------------------

    def append(self, attn_range: AttnRange, check: bool = False) -> None:
        if check:
            attn_range.check_valid()
        self._ranges.append(attn_range)

    def insert(self, idx: int, attn_range: AttnRange, check: bool = False) -> None:
        if check:
            attn_range.check_valid()
        self._ranges.insert(idx, attn_range)

    def extend(self, attn_ranges: "AttnRanges", check: bool = False) -> None:
        for r in attn_ranges:
            self.append(r, check=check)

    def pop(self, idx: int = -1) -> AttnRange:
        return self._ranges.pop(idx)

    def clear_empty(self) -> "AttnRanges":
        """Return a copy with empty ranges removed."""
        out = AttnRanges()
        out._ranges = [r.clone() for r in self._ranges if not r.is_empty()]
        return out

    # -- normalization -----------------------------------------------------

    def sort(self) -> "AttnRanges":
        """Return a copy sorted ascending by (start, end)."""
        out = AttnRanges()
        out._ranges = sorted(
            (r.clone() for r in self._ranges), key=lambda r: (r.start, r.end)
        )
        return out

    def merge(self) -> "AttnRanges":
        """Return sorted ranges with overlapping/adjacent ranges coalesced."""
        out = AttnRanges()
        for r in self.sort():
            if r.is_empty():
                continue
            if out._ranges and r.start <= out._ranges[-1].end:
                if r.end > out._ranges[-1].end:
                    out._ranges[-1].end = r.end
            else:
                out._ranges.append(r.clone())
        return out

    def merge_with_split_alignment(self, split_alignment: int = 1) -> "AttnRanges":
        """Merge after rounding each range outward to split_alignment boundaries."""
        out = AttnRanges()
        for r in self.sort():
            if r.is_empty():
                continue
            lo = r.start // split_alignment * split_alignment
            hi = -(-r.end // split_alignment) * split_alignment
            if out._ranges and lo <= out._ranges[-1].end:
                if hi > out._ranges[-1].end:
                    out._ranges[-1].end = hi
            else:
                out._ranges.append(AttnRange(lo, hi))
        return out

    def chunk(self, chunk_size: int, check: bool = True) -> list["AttnRanges"]:
        """Greedily split into consecutive groups of exactly chunk_size tokens
        (last group may be smaller). Ranges crossing a chunk boundary are cut.
        """
        if check and not self.is_non_overlap():
            raise ValueError("ranges must be non-overlapping to be chunked")
        chunks: list[AttnRanges] = []
        cur = AttnRanges()
        cnt = 0
        for r in self._ranges:
            start, remaining = r.start, r.seqlen
            while cnt + remaining >= chunk_size:
                take = chunk_size - cnt
                cur.append(AttnRange(start, start + take))
                chunks.append(cur)
                cur = AttnRanges()
                start += take
                remaining -= take
                cnt = 0
            if remaining > 0:
                cur.append(AttnRange(start, r.end))
                cnt += remaining
        if len(cur) > 0:
            chunks.append(cur)
        return chunks

    def truncate(
        self, start: int | None = None, end: int | None = None
    ) -> "AttnRanges":
        """Clamp each range into [start, end), dropping emptied ranges."""
        out = AttnRanges()
        for r in self._ranges:
            t = r.truncate(start, end)
            if not t.is_empty():
                out.append(t)
        return out

    # -- predicates --------------------------------------------------------

    def is_valid(self, start: int | None = None, end: int | None = None) -> bool:
        return all(r.is_valid_close(start, end) for r in self._ranges)

    def check_valid(self, start: int | None = None, end: int | None = None) -> None:
        for r in self._ranges:
            r.check_valid(start, end)

    def is_sorted(self) -> bool:
        return all(
            a.start <= b.start for a, b in zip(self._ranges, self._ranges[1:])
        )

    def is_merged(self) -> bool:
        """Sorted, non-empty, with strict gaps between consecutive ranges."""
        if any(r.is_empty() for r in self._ranges):
            return False
        return all(a.end < b.start for a, b in zip(self._ranges, self._ranges[1:]))

    def is_non_overlap(self) -> bool:
        rs = sorted(self._ranges, key=lambda r: (r.start, r.end))
        return all(a.end <= b.start for a, b in zip(rs, rs[1:]))

    def is_cu_seqlens(self, seqlen: int) -> bool:
        """True iff ranges exactly tile [0, seqlen) consecutively in order."""
        if self.is_empty():
            return seqlen == 0
        if self._ranges[0].start != 0 or self._ranges[-1].end != seqlen:
            return False
        return all(
            a.end == b.start for a, b in zip(self._ranges, self._ranges[1:])
        )

    def is_empty(self) -> bool:
        return len(self._ranges) == 0

    # -- conversions -------------------------------------------------------

    def to_cu_seqlens(self, seq_len: int) -> list[int]:
        if not self.is_cu_seqlens(seq_len):
            raise ValueError("the ranges cannot be converted to cu_seqlens")
        if self.is_empty():
            return [0]
        return [0] + [r.end for r in self._ranges]

    def to_naive_ranges(self) -> list[NaiveRange]:
        return [r.to_naive_range() for r in self._ranges]

    def to_tensor(self) -> np.ndarray:
        """[N, 2] int32 numpy array (host-side; device transfer is the caller's)."""
        if self.is_empty():
            return np.empty((0, 2), dtype=np.int32)
        return np.asarray(self.to_naive_ranges(), dtype=np.int32)

    # -- local-coordinate translation --------------------------------------

    def _merged_with_prefix(
        self, is_self_merged: bool
    ) -> tuple["AttnRanges", list[int]]:
        merged = self if is_self_merged else self.merge()
        prefix: list[int] = []
        acc = 0
        for r in merged:
            prefix.append(acc)
            acc += r.seqlen
        return merged, prefix

    def make_range_local(
        self,
        other_attn_range: AttnRange,
        is_self_merged: bool = False,
    ) -> tuple[AttnRange, AttnRange]:
        """Map a global range into local coordinates of self's concatenation.

        Returns (local_range, covering_global_range). Raises if
        ``other_attn_range`` is not contained in one merged range of self.
        """
        merged, prefix = self._merged_with_prefix(is_self_merged)
        starts = [r.start for r in merged]
        idx = bisect.bisect_right(starts, other_attn_range.start) - 1
        if idx < 0:
            raise ValueError(
                f"{other_attn_range} not within ranges {merged}"
            )
        target = merged[idx]
        if not other_attn_range.is_subrange_of(target):
            raise ValueError(
                f"{other_attn_range} not within (even merged) ranges {merged}"
            )
        start = prefix[idx] + other_attn_range.start - target.start
        return AttnRange(start, start + other_attn_range.seqlen), target

    def make_ranges_local(
        self,
        other_attn_ranges: "AttnRanges",
        is_self_merged: bool = False,
    ) -> "AttnRanges":
        """Map each range of ``other_attn_ranges`` into self-local coordinates."""
        merged, prefix = self._merged_with_prefix(is_self_merged)
        starts = [r.start for r in merged]
        out = AttnRanges()
        for other in other_attn_ranges:
            idx = bisect.bisect_right(starts, other.start) - 1
            contained = (
                idx >= 0
                and other.start <= merged[idx].end
                and (other.is_empty() or other.is_subrange_of(merged[idx]))
            )
            if not contained:
                raise ValueError(f"{other} not within ranges {merged}")
            start = prefix[idx] + other.start - merged[idx].start
            out.append(AttnRange(start, start + other.seqlen))
        return out

    # -- set algebra -------------------------------------------------------

    def find_hole_ranges(
        self,
        other_attn_ranges: "AttnRanges",
        is_self_merged: bool = False,
        is_other_merged: bool = False,
    ) -> "AttnRanges":
        """Set difference ``self - other`` as merged ranges."""
        a = (self if is_self_merged else self.merge()).clone()
        b = other_attn_ranges if is_other_merged else other_attn_ranges.merge()
        out = AttnRanges()
        p1 = p2 = 0
        while p1 < len(a) and p2 < len(b):
            r1, r2 = a[p1], b[p2]
            if r1.end > r2.end:
                p2 += 1
            else:
                p1 += 1
            if r1.start < r2.start:
                out.append(AttnRange(r1.start, min(r1.end, r2.start)))
            if r1.start < r2.end:
                try:
                    r1.start = r2.end
                except RangeError:
                    pass
        for r in a[p1:]:
            if not r.is_empty():
                out.append(r.clone())
        return out

    def find_overlap_ranges(
        self,
        other_attn_ranges: "AttnRanges",
        is_self_merged: bool = False,
        is_other_merged: bool = False,
    ) -> "AttnRanges":
        """Set intersection ``self ∩ other`` as merged ranges."""
        a = self if is_self_merged else self.merge()
        b = other_attn_ranges if is_other_merged else other_attn_ranges.merge()
        out = AttnRanges()
        p1 = p2 = 0
        while p1 < len(a) and p2 < len(b):
            r1, r2 = a[p1], b[p2]
            if r1.end > r2.end:
                p2 += 1
            else:
                p1 += 1
            if r1.is_overlap_with(r2):
                out.append(r1.intersect(r2))
        return out

    # -- size metrics ------------------------------------------------------

    def intersect_size(self) -> int:
        """Total size of pairwise self-overlap (how many tokens are covered >1x)."""
        return self.total_seqlen - self.union_size()

    def intersect_size_with(self, other: "AttnRanges") -> int:
        return sum(r.seqlen for r in self.find_overlap_ranges(other))

    def union_size(self) -> int:
        return sum(r.seqlen for r in self.merge())

    def union_size_with(self, other: "AttnRanges") -> int:
        both = self.clone()
        both.extend(other)
        return both.union_size()

    @property
    def total_seqlen(self) -> int:
        return sum(r.seqlen for r in self._ranges)

    @property
    def max_seqlen(self) -> int:
        return max((r.seqlen for r in self._ranges), default=0)

    @property
    def start(self) -> int:
        """Smallest start among ranges."""
        if self.is_empty():
            raise ValueError("empty AttnRanges has no start")
        return min(r.start for r in self._ranges)

    @property
    def end(self) -> int:
        """Largest end among ranges."""
        if self.is_empty():
            raise ValueError("empty AttnRanges has no end")
        return max(r.end for r in self._ranges)

    @property
    def size(self) -> int:
        return len(self._ranges)

    @property
    def points(self) -> list[int]:
        """Sorted unique endpoints of all ranges."""
        pts: set[int] = set()
        for r in self._ranges:
            pts.add(r.start)
            pts.add(r.end)
        return sorted(pts)

    # -- dunder ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ranges)

    def __getitem__(self, idx: Union[int, slice]):
        if isinstance(idx, slice):
            out = AttnRanges()
            out._ranges = self._ranges[idx]
            return out
        return self._ranges[idx]

    def __setitem__(self, idx, value) -> None:
        if isinstance(idx, slice):
            assert isinstance(value, AttnRanges)
            self._ranges[idx] = value._ranges
        else:
            assert isinstance(value, AttnRange)
            self._ranges[idx] = value

    def __iter__(self) -> Iterator[AttnRange]:
        return iter(self._ranges)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, AttnRanges):
            return self._ranges == other._ranges
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple((r.start, r.end) for r in self._ranges))

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self._ranges}"
