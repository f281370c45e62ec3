"""AttnRange: a half-open [start, end) index interval.

The port's own copy of the JAX package's ``common/range.py`` (pure host
Python, kept line for line so that the planners built on it give the same
plans): the interval algebra (intersect, union, diff, truncate, offset,
subrange predicates) the dispatch solver and the plan builder call.
"""

from __future__ import annotations

from typing import Any, Tuple

NaiveRange = Tuple[int, int]


class RangeError(Exception):
    """Raised when a range is (or would become) invalid."""


class AttnRange:
    """A half-open integer interval ``[start, end)`` with 0 <= start <= end."""

    __slots__ = ("_start", "_end")

    def __init__(self, start: int, end: int) -> None:
        if not (0 <= start <= end):
            raise RangeError(f"invalid range: [{start}, {end})")
        self._start = int(start)
        self._end = int(end)

    # -- basic accessors ---------------------------------------------------

    @property
    def start(self) -> int:
        return self._start

    @start.setter
    def start(self, value: int) -> None:
        if not (0 <= value <= self._end):
            raise RangeError(f"invalid start {value} for end {self._end}")
        self._start = int(value)

    @property
    def end(self) -> int:
        return self._end

    @end.setter
    def end(self, value: int) -> None:
        if not (self._start <= value):
            raise RangeError(f"invalid end {value} for start {self._start}")
        self._end = int(value)

    @property
    def seqlen(self) -> int:
        return self._end - self._start

    def to_naive_range(self) -> NaiveRange:
        return (self._start, self._end)

    @classmethod
    def from_range(cls, naive_range, check: bool = False) -> "AttnRange":
        """Build from any 2-sequence ``(start, end)``."""
        start, end = naive_range[0], naive_range[1]
        if check and not (0 <= start <= end):
            raise RangeError(f"invalid range: [{start}, {end})")
        return cls(start=start, end=end)

    def clone(self) -> "AttnRange":
        return AttnRange(self._start, self._end)

    # -- arithmetic --------------------------------------------------------

    def offset(self, offset: int) -> "AttnRange":
        """Return a new range shifted by ``offset`` (must stay >= 0)."""
        return AttnRange(self._start + offset, self._end + offset)

    def truncate(
        self, start: int | None = None, end: int | None = None
    ) -> "AttnRange":
        """Return this range clamped into [start, end)."""
        lo = self._start if start is None else max(self._start, start)
        hi = self._end if end is None else min(self._end, end)
        if lo >= hi:
            return AttnRange(0, 0)
        return AttnRange(lo, hi)

    def intersect(self, other: "AttnRange") -> "AttnRange":
        lo = max(self._start, other._start)
        hi = min(self._end, other._end)
        if lo >= hi:
            return AttnRange(0, 0)
        return AttnRange(lo, hi)

    def intersect_size(self, other: "AttnRange") -> int:
        return max(0, min(self._end, other._end) - max(self._start, other._start))

    def union(self, other: "AttnRange") -> list["AttnRange"]:
        """Union as a list of disjoint ranges (1 if touching/overlapping, else 2)."""
        if self.is_empty():
            return [other.clone()] if not other.is_empty() else []
        if other.is_empty():
            return [self.clone()]
        a, b = sorted((self, other), key=lambda r: (r._start, r._end))
        if b._start <= a._end:  # overlapping or adjacent
            return [AttnRange(a._start, max(a._end, b._end))]
        return [a.clone(), b.clone()]

    def union_size(self, other: "AttnRange") -> int:
        return self.seqlen + other.seqlen - self.intersect_size(other)

    def diff_by(self, other: "AttnRange") -> list["AttnRange"]:
        """Return ``self - other`` as a list of disjoint non-empty ranges."""
        inter = self.intersect(other)
        if inter.is_empty():
            return [self.clone()] if not self.is_empty() else []
        out: list[AttnRange] = []
        if self._start < inter._start:
            out.append(AttnRange(self._start, inter._start))
        if inter._end < self._end:
            out.append(AttnRange(inter._end, self._end))
        return out

    # -- predicates --------------------------------------------------------

    def is_subrange_of(self, other: "AttnRange") -> bool:
        if self.is_empty():
            return True
        return other._start <= self._start and self._end <= other._end

    def is_overlap_with(self, other: "AttnRange") -> bool:
        return self.intersect_size(other) > 0

    def is_empty(self) -> bool:
        return self._start == self._end

    def is_valid_close(self, start: int | None = None, end: int | None = None) -> bool:
        """Valid within the closed bound [start, end] (both endpoints allowed)."""
        lo = 0 if start is None else start
        hi = self._end if end is None else end
        return lo <= self._start <= self._end <= hi

    def is_valid_open(self, start: int | None = None, end: int | None = None) -> bool:
        """Valid and non-empty within [start, end)."""
        return self.is_valid_close(start, end) and not self.is_empty()

    def check_valid(self, start: int | None = None, end: int | None = None) -> None:
        if not self.is_valid_close(start, end):
            raise RangeError(f"{self!r} is not valid within [{start}, {end}]")

    # -- dunder ------------------------------------------------------------

    def __len__(self) -> int:
        return self.seqlen

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, AttnRange):
            return self._start == other._start and self._end == other._end
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self._start, self._end))

    def __repr__(self) -> str:  # pragma: no cover
        return f"[{self._start}, {self._end})"
