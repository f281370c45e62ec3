"""AttnRanges: an ordered collection of AttnRange intervals.

The port's own copy of the part of the JAX package's ``common/ranges.py``
(pure host Python) that the mask helpers return and the planner reads. The
set algebra (merge, chunk, hole and overlap ranges, local coordinates)
comes with the dispatch solver that uses it (ROADMAP queue A item 1).
"""

from __future__ import annotations

from typing import Any, Iterator, Sequence, Union

from .range import AttnRange, NaiveRange


def check_valid_cu_seqlens(cu_seqlens: Sequence[int], seq_len: int) -> None:
    """Raise unless cu_seqlens is a non-decreasing [0, ..., seq_len] list."""
    ok = (
        len(cu_seqlens) > 0
        and cu_seqlens[0] == 0
        and cu_seqlens[-1] == seq_len
        and all(a <= b for a, b in zip(cu_seqlens, cu_seqlens[1:]))
    )
    if not ok:
        raise ValueError(f"invalid cu_seqlens {cu_seqlens} for total seqlen {seq_len}")


class AttnRanges:
    """A list of AttnRange, in the order given (unsorted, overlaps allowed)."""

    __slots__ = ("_ranges",)

    def __init__(self) -> None:
        self._ranges: list[AttnRange] = []

    @classmethod
    def from_ranges(cls, ranges) -> "AttnRanges":
        """Build from a sequence of AttnRange or (start, end) 2-sequences."""
        out = cls()
        out._ranges = [
            r.clone() if isinstance(r, AttnRange) else AttnRange.from_range(r) for r in ranges
        ]
        return out

    @classmethod
    def from_cu_seqlens(cls, cu_seqlens: Sequence[int], seq_len: int) -> "AttnRanges":
        """Build consecutive ranges from a cumulative-seqlen prefix list."""
        check_valid_cu_seqlens(cu_seqlens, seq_len)
        return cls.from_ranges(zip(cu_seqlens, cu_seqlens[1:]))

    def clone(self) -> "AttnRanges":
        return AttnRanges.from_ranges(self._ranges)

    def to_naive_ranges(self) -> list[NaiveRange]:
        return [r.to_naive_range() for r in self._ranges]

    def __len__(self) -> int:
        return len(self._ranges)

    def __getitem__(self, idx: Union[int, slice]):
        if isinstance(idx, slice):
            return AttnRanges.from_ranges(self._ranges[idx])
        return self._ranges[idx]

    def __iter__(self) -> Iterator[AttnRange]:
        return iter(self._ranges)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, AttnRanges):
            return self._ranges == other._ranges
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple(r.to_naive_range() for r in self._ranges))

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self._ranges}"
