"""The mask-shape part of the JAX package's ``tuning/cost_model.py``.

Only what the kernel choice needs comes over: the exact mask area and the
density threshold below which a mask is heterogeneous and takes the
compact sparse grid. The threshold is a property of the mask's shape, so
the port picks the sparse grid for the same masks as the reference. The
rest of the cost model (step overheads, peak rates, rung tables) was
measured on a TPU and has no counterpart here until the H100 has its own
measurements.
"""

from __future__ import annotations

import functools

import numpy as np

# Below this covered fraction (true mask area / dense extent) a mask is
# heterogeneous: ``auto_kernel_config`` then picks the sparse grid.
SPARSE_DENSITY_THRESHOLD = 0.25


def _normalize_slices(q_ranges, k_ranges, attn_type_map):
    """int64 [S, 2], [S, 2], [S] with degenerate slices dropped (an empty
    range attends nothing and must not stretch the extent); a missing type
    map counts every slice as FULL."""
    q = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    k = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    if attn_type_map is None:
        t = np.zeros(q.shape[0], dtype=np.int64)
    else:
        t = np.asarray(attn_type_map, dtype=np.int64).reshape(-1)
    if not q.shape[0] == k.shape[0] == t.shape[0]:
        raise ValueError(
            f"{q.shape[0]} q ranges, {k.shape[0]} k ranges, {t.shape[0]} types"
        )
    live = (q[:, 1] > q[:, 0]) & (k[:, 1] > k[:, 0])
    return q[live], k[live], t[live]


@functools.lru_cache(maxsize=1024)
def _area(q_b: bytes, k_b: bytes, t_b: bytes) -> int:
    q = np.frombuffer(q_b, dtype=np.int64).reshape(-1, 2)
    k = np.frombuffer(k_b, dtype=np.int64).reshape(-1, 2)
    t = np.frombuffer(t_b, dtype=np.int64)
    total = 0
    for (q0, q1), (k0, k1), mt in zip(q.tolist(), k.tolist(), t.tolist()):
        rows = np.arange(q0, q1, dtype=np.int64)
        lo = np.full(rows.shape, k0, dtype=np.int64)
        hi = np.full(rows.shape, k1, dtype=np.int64)
        if mt & 1:  # causal: k - k1 <= q - q1
            hi = np.minimum(hi, k1 - q1 + rows + 1)
        if mt & 2:  # inv-causal: k - k0 >= q - q0
            lo = np.maximum(lo, k0 + (rows - q0))
        total += int(np.maximum(hi - lo, 0).sum())
    return total


def exact_mask_area(q_ranges, k_ranges, attn_type_map) -> int:
    """The exact count of unmasked (q, k) pairs, summed per slice (row by
    row, vectorised numpy), cached per slice list."""
    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    return _area(q.tobytes(), k.tobytes(), t.tobytes())


def mask_density(q_ranges, k_ranges, attn_type_map) -> float:
    """exact_mask_area / (largest q end x largest k end): the covered share
    of the mask's dense extent, as the reference's grid choice computes it."""
    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    sq = int(q[:, 1].max()) if q.size else 0
    sk = int(k[:, 1].max()) if k.size else 0
    return _area(q.tobytes(), k.tobytes(), t.tobytes()) / max(sq * sk, 1)
