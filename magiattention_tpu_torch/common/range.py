"""AttnRange: a half-open [start, end) index interval.

The port's own copy of the part of the JAX package's ``common/range.py``
(pure host Python) that the mask helpers need, so that the port imports
nothing of that package. The interval algebra (intersect, union, diff,
truncate, offset) comes with the dispatch solver that uses it (ROADMAP
queue A item 1).
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

    @property
    def start(self) -> int:
        return self._start

    @property
    def end(self) -> int:
        return self._end

    @property
    def seqlen(self) -> int:
        return self._end - self._start

    def to_naive_range(self) -> NaiveRange:
        return (self._start, self._end)

    @classmethod
    def from_range(cls, naive_range) -> "AttnRange":
        """Build from any 2-sequence ``(start, end)``."""
        return cls(naive_range[0], naive_range[1])

    def clone(self) -> "AttnRange":
        return AttnRange(self._start, self._end)

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
