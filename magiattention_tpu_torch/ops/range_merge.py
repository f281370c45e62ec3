"""Auto range merge: canonicalize a user slice list before planning.

The port's copy of the JAX package's ``ops/range_merge.py`` (the
reference's ``MAGI_ATTENTION_AUTO_RANGE_MERGE`` path): a user slice list
may hold duplicates and overlapping k-ranges for the same q rows; the
kernels sum one softmax contribution per slice, so overlaps count keys
twice. Merging rewrites the list into an equivalent one and shrinks the
kernel tables. Host-side numpy: the list is static per mask.
"""

from __future__ import annotations

import numpy as np

from ..common.enum import AttnMaskType


def merge_ranges(
    q_ranges: np.ndarray,  # [S, 2]
    k_ranges: np.ndarray,  # [S, 2]
    attn_type_map: np.ndarray,  # [S]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort slices, drop empty ones and exact duplicates, and union the
    overlapping or adjacent k-ranges of FULL slices that share one
    q-range.

    Only transformations that keep the mask's (q, k) coverage are applied:
    FULL has no diagonal, so a k-union covers exactly the same pairs; the
    causal family's diagonals are anchored to the slice corners, so those
    slices are only deduplicated.
    """
    q = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    k = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    t = np.asarray(attn_type_map, dtype=np.int64).reshape(-1)
    if not q.shape[0] == k.shape[0] == t.shape[0]:
        raise ValueError(f"merge_ranges: {q.shape[0]} q ranges, {k.shape[0]} k ranges and "
                         f"{t.shape[0]} mask types")
    # canonical order (qs, qe, type, ks, ke): slices sharing one q-range and
    # type become contiguous, so FULL k-union chains never break
    rows = sorted({
        (int(qs), int(qe), int(mt), int(ks), int(ke))
        for (qs, qe), (ks, ke), mt in zip(q, k, t)
        if qe > qs and ke > ks
    })
    merged: list[tuple[int, int, int, int, int]] = []
    for qs, qe, mt, ks, ke in rows:
        if (
            merged
            and mt == int(AttnMaskType.FULL)
            and merged[-1][2] == int(AttnMaskType.FULL)
            and merged[-1][0] == qs
            and merged[-1][1] == qe
            and merged[-1][4] >= ks  # overlapping or adjacent in k
        ):
            prev = merged[-1]
            merged[-1] = (qs, qe, mt, prev[3], max(prev[4], ke))
        else:
            merged.append((qs, qe, mt, ks, ke))
    arr = np.asarray(merged, dtype=np.int64).reshape(-1, 5)
    return arr[:, 0:2], arr[:, 3:5], arr[:, 2]
