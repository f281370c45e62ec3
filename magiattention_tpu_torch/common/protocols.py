"""Structural typing protocols of the host planner's data structures.

The counterpart of the JAX package's ``common/protocols.py``: the
interval-algebra surface the solvers rely on (:class:`RangeProtocol`,
:class:`RangesProtocol`, :class:`RectangleProtocol`,
:class:`RectanglesProtocol`), and the callable contracts of the native seam
(:class:`EntryEmitter`, :class:`SliceAreaFn`) that both the Python loops of
``ops/block_meta.py`` and the native library's wrappers in ``csrc``
(``emit_entries_native``, ``slice_area_runs_native``) satisfy. Conformance
and the byte parity of the two emitters are held in
``tests/test_torch_entry_table.py``.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class RangeProtocol(Protocol):
    """[start, end) interval algebra (``common/range.py``)."""

    @property
    def start(self) -> int: ...

    @property
    def end(self) -> int: ...

    @property
    def seqlen(self) -> int: ...

    def clone(self): ...

    def offset(self, offset: int): ...

    def intersect(self, other): ...

    def intersect_size(self, other) -> int: ...

    def union(self, other): ...

    def diff_by(self, other): ...

    def is_subrange_of(self, other) -> bool: ...

    def is_overlap_with(self, other) -> bool: ...

    def is_empty(self) -> bool: ...


@runtime_checkable
class RangesProtocol(Protocol):
    """Ordered list-of-ranges set algebra (``common/ranges.py``)."""

    def append(self, attn_range, check: bool = False) -> None: ...

    def merge(self): ...

    def chunk(self, chunk_size: int, check: bool = True): ...

    def make_ranges_local(self, ranges, check: bool = False): ...

    def find_hole_ranges(self, other, check: bool = False): ...

    def find_overlap_ranges(self, other): ...

    def to_naive_ranges(self): ...

    def is_sorted(self) -> bool: ...

    def is_non_overlap(self) -> bool: ...

    @property
    def total_seqlen(self) -> int: ...


@runtime_checkable
class RectangleProtocol(Protocol):
    """One (q x k) workload region of the dynamic solver
    (``common/rectangle.py``)."""

    @property
    def area(self) -> int: ...

    def cut_q(self, pos: int): ...

    def cut_k_multi(self, positions): ...


@runtime_checkable
class RectanglesProtocol(Protocol):
    """A rectangle collection with plane cuts (``common/rectangle.py``)."""

    def area(self) -> int: ...

    def cut_q(self, pos: int): ...

    def cut_k(self, pos: int): ...


@runtime_checkable
class EntryEmitter(Protocol):
    """The entry-table loop: (slices [S, 5], q runs, k runs, blocking) ->
    the (qblk, kblk, sid, ql0, ql1, kl0, kl1, qoff, koff) entries, as a list
    of 9-tuples or an [E, 9] int64 array, in one order. Implementations:
    ``ops.block_meta._emit_entries`` and ``csrc.emit_entries_native``."""

    def __call__(
        self,
        slices: np.ndarray,
        q_runs: Sequence,
        k_runs: Sequence,
        block_q: int,
        block_k: int,
    ): ...


@runtime_checkable
class SliceAreaFn(Protocol):
    """The exact unmasked-pair count of slices restricted to runs.
    Implementations: ``ops.block_meta._slice_area_runs`` and
    ``csrc.slice_area_runs_native``."""

    def __call__(self, slices: np.ndarray, q_runs: Sequence, k_runs: Sequence) -> int: ...
