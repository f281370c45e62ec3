"""Sanity checks behind ``MAGI_ATTENTION_SANITY_CHECK``: the port's copy of
the JAX package's ``common/sanity.py`` (host only).

The check that matters most is *disjoint (q, k) coverage*: slices may
share q rows (multi-k attention) but no (q, k) cell may be covered twice —
the kernels sum per-slice contributions, so overlapping coverage silently
double-counts keys in the softmax.
"""

from __future__ import annotations

from typing import Sequence

from .enum import AttnMaskType
from .ranges import AttnRanges


def _row_band(qs, qe, ks, ke, mt, q):
    """Row q's attended k interval [lo, hi) for one slice (linear in q)."""
    lo = ks + (q - qs) if (mt & 2) else ks
    hi = (ke - qe + q + 1) if (mt & 1) else ke
    return lo, hi


def check_slices_non_overlapping(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_type_map: Sequence[AttnMaskType | int],
) -> None:
    """Raise ValueError if any (q, k) cell is covered by two slices.

    Exact O(S^2) pairwise check: each slice's per-row coverage is a linear
    band [lo(q), hi(q)); for two slices overlapping in q, the band
    intersection size max(lo) < min(hi) is piecewise-linear in q, so it
    suffices to test the endpoints of the shared q interval and the (at
    most two) crossing points of the lo/hi envelopes.
    """
    qs_list = (
        q_ranges.to_naive_ranges()
        if isinstance(q_ranges, AttnRanges)
        else [tuple(x) for x in q_ranges]
    )
    ks_list = (
        k_ranges.to_naive_ranges()
        if isinstance(k_ranges, AttnRanges)
        else [tuple(x) for x in k_ranges]
    )
    types = [int(t) for t in attn_type_map]
    n = len(types)
    for i in range(n):
        qi, ki, ti = qs_list[i], ks_list[i], types[i]
        for j in range(i + 1, n):
            qj, kj, tj = qs_list[j], ks_list[j], types[j]
            a = max(qi[0], qj[0])
            b = min(qi[1], qj[1])
            if a >= b:
                continue
            # candidate rows: interval endpoints + envelope crossings
            cands = {a, b - 1}
            # lo_i(q) - lo_j(q) and hi_i(q) - hi_j(q) are linear; their
            # zero crossings are candidates (clip into [a, b))
            lo_i_a, hi_i_a = _row_band(*qi, *ki, ti, a)
            lo_i_b, hi_i_b = _row_band(*qi, *ki, ti, b - 1)
            lo_j_a, hi_j_a = _row_band(*qj, *kj, tj, a)
            lo_j_b, hi_j_b = _row_band(*qj, *kj, tj, b - 1)
            for (fa, fb, ga, gb) in (
                (lo_i_a, lo_i_b, lo_j_a, lo_j_b),
                (hi_i_a, hi_i_b, hi_j_a, hi_j_b),
                (lo_i_a, lo_i_b, hi_j_a, hi_j_b),
                (hi_i_a, hi_i_b, lo_j_a, lo_j_b),
            ):
                d_a = fa - ga
                d_b = fb - gb
                if d_a != d_b and (d_a <= 0) != (d_b <= 0):
                    # linear sign change: crossing at a + d_a*(b-1-a)/(d_a-d_b)
                    t = a + round(d_a * (b - 1 - a) / (d_a - d_b))
                    for c in (t - 1, t, t + 1):
                        if a <= c < b:
                            cands.add(c)
            for q in cands:
                lo_i, hi_i = _row_band(*qi, *ki, ti, q)
                lo_j, hi_j = _row_band(*qj, *kj, tj, q)
                lo_i, hi_i = max(lo_i, ki[0]), min(hi_i, ki[1])
                lo_j, hi_j = max(lo_j, kj[0]), min(hi_j, kj[1])
                if max(lo_i, lo_j) < min(hi_i, hi_j):
                    raise ValueError(
                        f"slices {i} and {j} overlap in (q, k) coverage at "
                        f"q={q}: k bands [{lo_i},{hi_i}) and [{lo_j},{hi_j}) "
                        "intersect — the kernel would double-count these "
                        "keys in the softmax. Make slice coverage disjoint."
                    )
