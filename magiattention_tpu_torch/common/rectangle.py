"""AttnRectangle(s): 2-D (q_range x k_range x mask) workload geometry.

The port's own copy of the JAX package's ``common/rectangle.py``: each
rectangle is one attention slice viewed as a region of the (q, k) plane
whose unmasked area is the FLOPs cost. The plan builder's auto overlap
degree cuts them along k lines to price a rank's own-shard work
(``parallel/dist_attn.py::_slice_area_within_k``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

from .enum import AttnMaskType
from .mask import slice_area
from .range import AttnRange


@dataclasses.dataclass
class AttnRectangle:
    """One (q_range, k_range, mask_type) region of the attention plane."""

    q_range: AttnRange
    k_range: AttnRange
    mask_type: AttnMaskType = AttnMaskType.FULL

    @property
    def area(self) -> int:
        return slice_area(
            self.q_range.start,
            self.q_range.end,
            self.k_range.start,
            self.k_range.end,
            self.mask_type,
        )

    def is_empty(self) -> bool:
        return self.area == 0

    def clone(self) -> "AttnRectangle":
        return AttnRectangle(
            self.q_range.clone(), self.k_range.clone(), self.mask_type
        )

    # -- cuts (the solver primitives) -------------------------------------

    def cut_q(self, pos: int) -> tuple[Optional["AttnRectangle"], Optional["AttnRectangle"]]:
        """Split along the horizontal line q=pos, preserving mask alignment
        (the same transformation as chunk slicing: a causal bound moves the
        k end with the bottom row, an inv-causal bound moves the k start
        with the top row)."""
        qs, qe = self.q_range.start, self.q_range.end
        if pos <= qs:
            return None, self.clone()
        if pos >= qe:
            return self.clone(), None
        top = _truncate_q(self, qs, pos)
        bottom = _truncate_q(self, pos, qe)
        return top, bottom

    def cut_k_multi(
        self, pos: int
    ) -> tuple[list["AttnRectangle"], list["AttnRectangle"]]:
        """Split at k=pos into exact piece lists (1-2 rectangles per side)."""
        ks, ke = self.k_range.start, self.k_range.end
        if pos <= ks:
            return [], [self.clone()]
        if pos >= ke:
            return [self.clone()], []
        qs, qe = self.q_range.start, self.q_range.end
        mt = self.mask_type
        left: list[AttnRectangle] = []
        right: list[AttnRectangle] = []

        if mt == AttnMaskType.FULL:
            left.append(AttnRectangle(self.q_range.clone(), AttnRange(ks, pos), mt))
            right.append(AttnRectangle(self.q_range.clone(), AttnRange(pos, ke), mt))
            return left, right

        # crossing rows where the diagonal(s) meet k=pos
        # causal diagonal: k = q + (ke - qe)  ->  q* = pos - ke + qe
        # inv diagonal:    k = q + (ks - qs)  ->  q* = pos - ks + qs
        if mt == AttnMaskType.CAUSAL:
            q_cross = pos - ke + qe  # rows >= q_cross see k < pos fully
            top, bottom = self.cut_q(q_cross)
            # top piece (rows < q_cross): strictly left of pos -> causal as-is
            if top is not None and not top.is_empty():
                lpiece, _ = _clip_k(top, ks, pos)
                if lpiece is not None:
                    left.append(lpiece)
            if bottom is not None and not bottom.is_empty():
                # bottom rows: [ks, pos) fully visible; [pos, ke) causal
                bl = AttnRectangle(
                    bottom.q_range.clone(), AttnRange(ks, pos), AttnMaskType.FULL
                )
                if bl.area > 0:
                    left.append(bl)
                br = AttnRectangle(
                    bottom.q_range.clone(),
                    AttnRange(pos, bottom.k_range.end),
                    AttnMaskType.CAUSAL,
                )
                if br.area > 0:
                    right.append(br)
            return left, right

        if mt == AttnMaskType.INVCAUSAL:
            q_cross = pos - ks + qs  # rows < q_cross start left of pos
            top, bottom = self.cut_q(q_cross)
            if top is not None and not top.is_empty():
                # top rows: [k_start(q), pos) inv-causal; [pos, ke) full
                tl = AttnRectangle(
                    top.q_range.clone(),
                    AttnRange(top.k_range.start, pos),
                    AttnMaskType.INVCAUSAL,
                )
                if tl.area > 0:
                    left.append(tl)
                tr = AttnRectangle(
                    top.q_range.clone(), AttnRange(pos, ke), AttnMaskType.FULL
                )
                if tr.area > 0:
                    right.append(tr)
            if bottom is not None and not bottom.is_empty():
                rpiece = AttnRectangle(
                    bottom.q_range.clone(),
                    AttnRange(bottom.k_range.start, ke),
                    AttnMaskType.INVCAUSAL,
                )
                if rpiece.area > 0:
                    right.append(rpiece)
            return left, right

        # BICAUSAL: cut q at both crossings, pieces become causal/inv/full
        q_cross_c = pos - ke + qe
        q_cross_i = pos - ks + qs  # note q_cross_i <= q_cross_c (band width)
        lo, hi = sorted((q_cross_c, q_cross_i))
        top, rest = self.cut_q(lo)
        mid, bottom = (rest.cut_q(hi) if rest is not None else (None, None))
        for piece in (top, mid, bottom):
            if piece is None or piece.is_empty():
                continue
            # cut_q preserves BICAUSAL; each piece is clipped as a band
            pl, pr = _bicausal_clip(piece, pos)
            left.extend(pl)
            right.extend(pr)
        return left, right

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"AttnRectangle(q={self.q_range}, k={self.k_range}, "
            f"type={self.mask_type.name.lower()}, area={self.area})"
        )


def _truncate_q(rect: AttnRectangle, a: int, b: int) -> Optional[AttnRectangle]:
    """Rows [a, b) of rect with alignment-preserving k adjustment."""
    ks, ke = rect.k_range.start, rect.k_range.end
    if rect.mask_type.is_causal_bound:
        ke = ke - (rect.q_range.end - b)
    if rect.mask_type.is_inv_causal_bound:
        ks = ks + (a - rect.q_range.start)
    if ke <= ks:
        return None
    return AttnRectangle(AttnRange(a, b), AttnRange(ks, ke), rect.mask_type)


def _clip_k(rect: AttnRectangle, lo: int, hi: int) -> tuple[Optional[AttnRectangle], None]:
    k = rect.k_range.truncate(lo, hi)
    if k.is_empty():
        return None, None
    out = AttnRectangle(rect.q_range.clone(), k, rect.mask_type)
    return (out if out.area > 0 else None), None


def _bicausal_clip(rect: AttnRectangle, pos: int):
    """Bicausal band that is entirely on one side after the q cuts."""
    ks, ke = rect.k_range.start, rect.k_range.end
    if ke <= pos:
        return [rect.clone()], []
    if ks >= pos:
        return [], [rect.clone()]
    # band straddles pos even after cuts (can happen when band width > 1
    # crosses within a single row range); fall back to q-row split
    left: list[AttnRectangle] = []
    right: list[AttnRectangle] = []
    qs, qe = rect.q_range.start, rect.q_range.end
    for q in range(qs, qe):  # bands are narrow; host-side only
        lo = ks + (q - qs)
        hi = ke - (qe - 1 - q)
        if hi <= lo:
            continue
        if hi <= pos:
            left.append(
                AttnRectangle(AttnRange(q, q + 1), AttnRange(lo, hi), AttnMaskType.FULL)
            )
        elif lo >= pos:
            right.append(
                AttnRectangle(AttnRange(q, q + 1), AttnRange(lo, hi), AttnMaskType.FULL)
            )
        else:
            left.append(
                AttnRectangle(AttnRange(q, q + 1), AttnRange(lo, pos), AttnMaskType.FULL)
            )
            right.append(
                AttnRectangle(AttnRange(q, q + 1), AttnRange(pos, hi), AttnMaskType.FULL)
            )
    return left, right


class AttnRectangles:
    """A collection of rectangles with solver-facing aggregate ops."""

    __slots__ = ("_rects",)

    def __init__(self) -> None:
        self._rects: list[AttnRectangle] = []

    @classmethod
    def from_ranges(
        cls,
        q_ranges,
        k_ranges,
        attn_type_map: Sequence[AttnMaskType | int],
    ) -> "AttnRectangles":
        out = cls()
        for q, k, t in zip(q_ranges, k_ranges, attn_type_map):
            out.append(
                AttnRectangle(
                    AttnRange(q[0], q[1]) if not isinstance(q, AttnRange) else q.clone(),
                    AttnRange(k[0], k[1]) if not isinstance(k, AttnRange) else k.clone(),
                    AttnMaskType(int(t)),
                )
            )
        return out

    def append(self, rect: AttnRectangle) -> None:
        if not rect.is_empty():
            self._rects.append(rect)

    def extend(self, rects: "AttnRectangles | list[AttnRectangle]") -> None:
        for r in rects:
            self.append(r)

    @property
    def area(self) -> int:
        return sum(r.area for r in self._rects)

    def cut_q(self, pos: int) -> tuple["AttnRectangles", "AttnRectangles"]:
        """Partition all rectangles at the q=pos line."""
        top, bottom = AttnRectangles(), AttnRectangles()
        for r in self._rects:
            t, b = r.cut_q(pos)
            if t is not None:
                top.append(t)
            if b is not None:
                bottom.append(b)
        return top, bottom

    def cut_k(self, pos: int) -> tuple["AttnRectangles", "AttnRectangles"]:
        """Partition all rectangles at the k=pos line."""
        left, right = AttnRectangles(), AttnRectangles()
        for r in self._rects:
            pl, pr = r.cut_k_multi(pos)
            left.extend(pl)
            right.extend(pr)
        return left, right

    def area_left_of_q(self, pos: int) -> int:
        """Area of the sub-region with q < pos (no piece construction)."""
        total = 0
        for r in self._rects:
            t = _truncate_q(r, r.q_range.start, min(max(pos, r.q_range.start), r.q_range.end)) if pos > r.q_range.start else None
            if t is not None:
                total += t.area
        return total

    def area_left_of_k(self, pos: int) -> int:
        """Area of the sub-region with k < pos — closed form per rect
        (O(1) per rectangle per probe; no row materialization)."""
        from .mask import slice_area_left_of_k

        total = 0
        for r in self._rects:
            total += slice_area_left_of_k(
                r.q_range.start,
                r.q_range.end,
                r.k_range.start,
                r.k_range.end,
                r.mask_type,
                pos,
            )
        return total

    def to_array(self):
        """[n, 5] int64 (qs, qe, ks, ke, mask_type) — the flat form the
        native solver accelerators consume."""
        import numpy as np

        out = np.empty((len(self._rects), 5), dtype=np.int64)
        for i, r in enumerate(self._rects):
            out[i] = (
                r.q_range.start,
                r.q_range.end,
                r.k_range.start,
                r.k_range.end,
                int(r.mask_type.value),
            )
        return out

    def __len__(self) -> int:
        return len(self._rects)

    def __iter__(self) -> Iterator[AttnRectangle]:
        return iter(self._rects)

    def __getitem__(self, i: int) -> AttnRectangle:
        return self._rects[i]

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self._rects}"
