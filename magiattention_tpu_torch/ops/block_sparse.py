"""The block-enumeration primitives the flex kernels' entry walks need:
per-major-row ``[start, count]`` over a sorted entry array, the clamped
lookup of a row's j-th entry, and the work list of the persistent
sparse-grid kernels."""

from __future__ import annotations

import numpy as np


def row_tables(major: np.ndarray, num_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-major-row ``(start, count)`` (int32) over a SORTED major array:
    row i's entries are ``start[i] .. start[i]+count[i]``. The flex kernel
    loops over exactly that span for its q block."""
    major = np.asarray(major)
    idx = np.arange(num_rows, dtype=major.dtype)
    rs = np.searchsorted(major, idx, side="left").astype(np.int32)
    re = np.searchsorted(major, idx, side="right").astype(np.int32)
    return rs, (re - rs).astype(np.int32)


def clamped_entry(row_start, row_count, i: int, j: int) -> int:
    """Entry index for step j of major row i: steps past the row's count
    clamp to its last live entry (the caller skips their compute)."""
    return int(row_start[i]) + min(j, max(int(row_count[i]) - 1, 0))


def work_list(row_count: np.ndarray, num_groups: int) -> np.ndarray:
    """Every (head group, major row) item of a persistent entry-walk kernel,
    longest walk first: ``row_count`` descending, ties by group, then by
    row. An item is encoded as ``group * num_rows + row`` (int32); a
    kernel takes the items in this order, so the long walks start in its
    first wave and the short ones fill the tail."""
    rc = np.asarray(row_count, dtype=np.int64)
    n = rc.shape[0]
    groups = np.repeat(np.arange(num_groups, dtype=np.int64), n)
    rows = np.tile(np.arange(n, dtype=np.int64), num_groups)
    order = np.lexsort((rows, groups, -rc[rows]))
    return (groups[order] * n + rows[order]).astype(np.int32)
