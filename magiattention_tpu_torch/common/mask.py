"""Dense attention-mask materialization from (q_range, k_range, mask_type)
slices: the ground-truth mask semantics, used by the oracle and the tests,
never on the hot path; and the exact per-slice areas (closed forms, copied
from the JAX package's ``common/mask.py``) that the dispatch solver balances
and the plan builder counts."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .enum import AttnMaskType


def slice_mask(
    q_start: int,
    q_end: int,
    k_start: int,
    k_end: int,
    mask_type: AttnMaskType | int,
    total_q: int,
    total_k: int,
) -> np.ndarray:
    """Dense bool mask [total_q, total_k] contributed by one attention slice.

    CAUSAL is bottom-right aligned: allow iff (k - k_end) <= (q - q_end).
    INVCAUSAL is top-left aligned: allow iff (k - k_start) >= (q - q_start).
    BICAUSAL is their intersection; FULL is the whole rectangle.
    """
    mt = AttnMaskType(int(mask_type))
    q = np.arange(total_q)[:, None]
    k = np.arange(total_k)[None, :]
    m = (q >= q_start) & (q < q_end) & (k >= k_start) & (k < k_end)
    if mt.is_causal_bound:
        m &= (k - k_end) <= (q - q_end)
    if mt.is_inv_causal_bound:
        m &= (k - k_start) >= (q - q_start)
    return m


def _tri_sum(lo: int, hi: int) -> int:
    """Sum of integers lo..hi inclusive (0 if hi < lo)."""
    if hi < lo:
        return 0
    return (hi + lo) * (hi - lo + 1) // 2


def _sum_clamp_linear(n: int, b: int, cap: int) -> int:
    """sum_{i=0}^{n-1} clamp(b + i, 0, cap) in closed form."""
    if cap <= 0 or n <= 0:
        return 0
    n0 = min(max(-b, 0), n)  # below: clamped to 0
    n1 = min(max(cap - b, 0), n)  # from here on: saturated at cap
    return _tri_sum(b + n0, b + n1 - 1) + (n - n1) * cap


def slice_area(
    q_start: int, q_end: int, k_start: int, k_end: int, mask_type: AttnMaskType | int
) -> int:
    """Exact number of unmasked (q, k) pairs in one slice — the FLOPs proxy.

    Closed forms per mask type (reference _make_dispatch_meta.py:541-619
    trapezoid/parallelogram/rectangle formulas, re-derived):

    - FULL: sq * sk.
    - CAUSAL (bottom-right): row q (relative, 0-based) attends
      ``clamp(sk - sq + q + 1, 0, sk)`` keys — a trapezoid/triangle.
    - INVCAUSAL (top-left): row q attends ``clamp(sk - q, 0, sk)`` keys.
    - BICAUSAL: row q attends ``clamp(min(sk-sq+q+1, sk) - max(q, 0), 0, .)``
      intersection band.
    """
    sq = q_end - q_start
    sk = k_end - k_start
    if sq <= 0 or sk <= 0:
        return 0
    mt = AttnMaskType(int(mask_type))
    if mt == AttnMaskType.FULL:
        return sq * sk

    if mt == AttnMaskType.CAUSAL:
        # per-row key count c(q) = clamp(sk - sq + q + 1, 0, sk), q in [0, sq)
        if sk >= sq:
            return _tri_sum(sk - sq + 1, sk)  # trapezoid
        return _tri_sum(1, sk)  # triangle; rows [0, sq - sk) are fully masked
    if mt == AttnMaskType.INVCAUSAL:
        # per-row key count c(q) = clamp(sk - q, 0, sk)
        n_pos = min(sq, sk)
        return _tri_sum(sk - n_pos + 1, sk)
    # BICAUSAL: row band [q, sk - sq + q] in relative coords → constant width
    width = sk - sq + 1
    return sq * width if width > 0 else 0


def slice_area_left_of_k(
    q_start: int,
    q_end: int,
    k_start: int,
    k_end: int,
    mask_type: AttnMaskType | int,
    pos: int,
) -> int:
    """Unmasked (q, k) pairs of the slice with ``k < pos`` — closed form.

    The dynamic solver's k-cut binary search probes this O(log range)
    times per level; the closed forms keep each probe O(1) per rectangle
    (the reference's C++ `magi_attn_ext` accelerates the same loop).

    Per absolute row q (i = q - q_start): the visible keys are
    [lo_i, hi_i) with lo_i = k_start (+ i for inv-causal bounds) and
    hi_i = k_end (- sq + i + 1 for causal bounds); the left-of-pos count
    is ``max(0, min(hi_i, pos) - lo_i)``, summed in closed form.
    """
    sq = q_end - q_start
    sk = k_end - k_start
    if sq <= 0 or sk <= 0 or pos <= k_start:
        return 0
    mt = AttnMaskType(int(mask_type))
    if mt == AttnMaskType.FULL:
        return sq * (min(pos, k_end) - k_start)
    if mt == AttnMaskType.CAUSAL:
        # hi linear: cnt_i = clamp((sk - sq + 1) + i, 0, pos - k_start)
        return _sum_clamp_linear(sq, sk - sq + 1, pos - k_start)
    if mt == AttnMaskType.INVCAUSAL:
        # lo linear: cnt_i = max(0, P - i), P = min(pos, k_end) - k_start
        p = min(pos, k_end) - k_start
        n_pos = min(p, sq)
        return _tri_sum(p - n_pos + 1, p)
    # BICAUSAL: constant band width w above the pos-crossing row, then a
    # decreasing tail
    w = sk - sq + 1
    if w <= 0:
        return 0
    h0 = k_end - sq + 1  # absolute exclusive hi of row i=0
    n_const = min(max(pos - h0 + 1, 0), sq)  # rows fully left of pos
    total = n_const * w
    p2 = pos - k_start
    hi_idx = min(sq, p2)  # rows i < p2 have a positive partial count
    if hi_idx > n_const:
        total += _tri_sum(p2 - hi_idx + 1, p2 - n_const)
    return total


def make_attn_mask_from_ranges(
    q_ranges: Sequence[Sequence[int]],
    k_ranges: Sequence[Sequence[int]],
    attn_type_map: Sequence[AttnMaskType | int],
    total_q: int,
    total_k: int,
) -> np.ndarray:
    """Union of all slice masks — the dense ground-truth mask [total_q, total_k]."""
    assert len(q_ranges) == len(k_ranges) == len(attn_type_map)
    mask = np.zeros((total_q, total_k), dtype=bool)
    for (qs, qe), (ks, ke), mt in zip(q_ranges, k_ranges, attn_type_map):
        mask |= slice_mask(qs, qe, ks, ke, mt, total_q, total_k)
    return mask
