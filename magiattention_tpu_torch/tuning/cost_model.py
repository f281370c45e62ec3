"""The mask-shape part of the JAX package's ``tuning/cost_model.py``.

What comes over is the counting, the same code as the reference's: the
exact mask area, the density threshold below which a mask is
heterogeneous and takes the compact sparse grid, and the tile counts a
blocking schedules (:func:`estimate_entries` over
:func:`slice_block_k_spans`, the one counting primitive the roofline and
the occupancy maps share). The reference's per-step fees and rung tables
were fitted on its own hardware and do not come over: the roofline takes
its fees as a parameter (``telemetry/roofline.py``), and the card's own
are to be fitted (ROADMAP A.12).
"""

from __future__ import annotations

import functools
import hashlib

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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def estimate_entries(q_ranges, k_ranges, attn_type_map, block_q: int,
                     block_k: int) -> tuple[int, int, int]:
    """(entries, steps, num_q_blocks) for one blocking: per q block of each
    slice the attended k interval (mask-type-aware, the spans
    ``block_meta`` emits) counted in k-block units; an uncovered q block
    counts one dummy entry (the table's invariant); ``steps`` is the most
    entries of any q block (the row-major grid's inner extent). Memoised on
    a digest of the slices, not the slices themselves."""
    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    key = (slices_digest(q, k, t), int(block_q), int(block_k))
    hit = _ENTRY_MEMO.get(key)
    if hit is None:
        if len(_ENTRY_MEMO) >= _ENTRY_MEMO_CAP:  # a crude bound: never grows past it
            _ENTRY_MEMO.clear()
        hit = _ENTRY_MEMO[key] = _estimate_entries_impl(q, k, t, int(block_q), int(block_k))
    return hit


def slices_digest(q, k, t) -> bytes:
    """A stable 32-byte identity of a normalised slice set."""
    h = hashlib.sha256()
    for a in (q, k, t):
        h.update(np.ascontiguousarray(a).tobytes())
        h.update(b"|")
    return h.digest()


_ENTRY_MEMO: dict = {}
_ENTRY_MEMO_CAP = 4096


def slice_block_k_spans(q0: int, q1: int, k0: int, k1: int, mt: int, block_q: int
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The attended k interval of each q block of ONE slice: (q block index,
    first row, row end, k_lo, k_hi) vectors, mask-type-aware; a block whose
    span is empty has ``k_hi <= k_lo``. The one counting primitive of the
    entry counts, the roofline and the occupancy maps, so they cannot
    disagree about what the kernel schedules."""
    idx = np.arange(q0 // block_q, _cdiv(q1, block_q), dtype=np.int64)
    lo = np.maximum(q0, idx * block_q)  # first row (inclusive)
    hi = np.minimum(q1, (idx + 1) * block_q)  # last row (exclusive)
    k_lo = np.full(idx.shape, k0, dtype=np.int64)
    k_hi = np.full(idx.shape, k1, dtype=np.int64)
    if mt & 1:  # causal: k - ke <= q - qe
        k_hi = np.minimum(k_hi, k1 - q1 + hi)
    if mt & 2:  # inv-causal: k - ks >= q - qs
        k_lo = np.maximum(k_lo, k0 + (lo - q0))
    return idx, lo, hi, k_lo, k_hi


def _estimate_entries_impl(q: np.ndarray, k: np.ndarray, t: np.ndarray, block_q: int,
                           block_k: int) -> tuple[int, int, int]:
    extent_q = int(q[:, 1].max()) if q.size else 0
    nq = max(_cdiv(extent_q, block_q), 1)
    per_block = np.zeros(nq, dtype=np.int64)
    for (q0, q1), (k0, k1), mt in zip(q.tolist(), k.tolist(), t.tolist()):
        if q1 <= q0 or k1 <= k0:
            continue
        idx, _, _, k_lo, k_hi = slice_block_k_spans(q0, q1, k0, k1, mt, block_q)
        covered = k_hi > k_lo
        nkb = np.where(
            covered,
            (np.maximum(k_hi, k_lo + 1) - 1) // block_k - k_lo // block_k + 1,
            0,
        )
        per_block[idx] += nkb
    dummies = int((per_block == 0).sum())
    entries = int(per_block.sum()) + dummies
    steps = max(int(per_block.max()) if per_block.size else 0, 1)
    return entries, steps, nq


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
