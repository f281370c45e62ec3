"""Block-occupancy maps: the active k blocks of each q block of a mask.

The port's copy of the JAX package's ``telemetry/occupancy.py``: the exact
per-q-block active-k-block lists of a slice set at one blocking, counted by
the cost model's own primitive
(:func:`~..tuning.cost_model.slice_block_k_spans`, shared with the
roofline's counts) and memoised on the slices' digest. The map is the
sparse grid's input: :meth:`BlockOccupancyMap.to_enumeration` gives the
``ops.block_sparse.BlockEnumeration`` the compact kernels launch over, and
the JSON artifact (``as_json`` / ``dump`` / ``load``) reads the same files
as the JAX package's.

Exports: :func:`block_occupancy_map` -> :class:`BlockOccupancyMap` with
``as_json()``/``dump()``, ``load()``, ``density_histogram()`` and
``ascii_heatmap()``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..tuning.cost_model import (
    _ENTRY_MEMO_CAP,
    _cdiv,
    _normalize_slices,
    slice_block_k_spans,
    slices_digest,
)

_OCC_MEMO: dict = {}


@dataclasses.dataclass(frozen=True)
class BlockOccupancyMap:
    """Per-q-block active-k-block lists of one mask at one blocking.

    ``active[i]`` is the sorted tuple of k-block ids q-block ``i``
    attends (empty = a dead q-block: the entry table emits one dummy
    there and a block-sparse grid skips the row entirely).
    """

    block_q: int
    block_k: int
    num_q_blocks: int
    num_k_blocks: int
    active: tuple[tuple[int, ...], ...]  # [num_q_blocks] sorted k-block ids

    @property
    def active_blocks_total(self) -> int:
        return sum(len(a) for a in self.active)

    @property
    def dead_q_blocks(self) -> int:
        return sum(1 for a in self.active if not a)

    @property
    def block_density(self) -> float:
        """Active tiles / dense tile grid — the block-granular sparsity a
        block-sparse grid exploits (1.0 = every tile live)."""
        dense = self.num_q_blocks * self.num_k_blocks
        return self.active_blocks_total / dense if dense else 0.0

    def row_counts(self) -> np.ndarray:
        """[num_q_blocks] int64: active k-blocks per q-block — the
        per-row work profile (max = the kernel's static ``steps``)."""
        return np.asarray([len(a) for a in self.active], dtype=np.int64)

    def density_histogram(self, bins: int = 8) -> dict:
        """Histogram of per-q-block row density (active / num_k_blocks):
        ``{"edges": [...], "counts": [...]}`` with ``counts`` summing to
        ``num_q_blocks``. The shape of this histogram is the work-skew
        headline: a spike at 0 is dead rows, a long tail is the straggler
        q-blocks that set the grid extent."""
        dens = self.row_counts() / max(self.num_k_blocks, 1)
        counts, edges = np.histogram(dens, bins=bins, range=(0.0, 1.0))
        return {
            "edges": [float(e) for e in edges],
            "counts": [int(c) for c in counts],
        }

    def as_json(self) -> dict:
        """The block-sparse-grid input artifact: plain-dict, JSON-safe,
        ``active_k_blocks[i]`` = q-block i's sorted active k-block ids."""
        return {
            "block_q": self.block_q,
            "block_k": self.block_k,
            "num_q_blocks": self.num_q_blocks,
            "num_k_blocks": self.num_k_blocks,
            "active_k_blocks": [list(a) for a in self.active],
            "active_blocks_total": self.active_blocks_total,
            "dead_q_blocks": self.dead_q_blocks,
            "block_density": self.block_density,
            "density_histogram": self.density_histogram(),
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @staticmethod
    def from_json(payload: dict) -> "BlockOccupancyMap":
        return BlockOccupancyMap(
            block_q=int(payload["block_q"]),
            block_k=int(payload["block_k"]),
            num_q_blocks=int(payload["num_q_blocks"]),
            num_k_blocks=int(payload["num_k_blocks"]),
            active=tuple(
                tuple(int(b) for b in row)
                for row in payload["active_k_blocks"]
            ),
        )

    @staticmethod
    def load(path: str) -> "BlockOccupancyMap":
        with open(path) as f:
            return BlockOccupancyMap.from_json(json.load(f))

    def to_enumeration(self):
        """The shared sparse-core view of this map
        (``ops.block_sparse.BlockEnumeration``): the flattened
        major->minor walk a compact sparse grid launches over — the
        profiler's measurement output IS the kernel's input format."""
        from ..ops.block_sparse import BlockEnumeration

        return BlockEnumeration.from_occupancy(self)

    def ascii_heatmap(self, max_rows: int = 32, max_cols: int = 64) -> str:
        """Downsampled tile-occupancy picture for the report: rows are
        q-blocks, columns k-blocks, shade = fraction of the cell's tiles
        that are active (``.`` empty .. ``#`` full)."""
        shades = " .:-=+*#"
        nq, nk = self.num_q_blocks, self.num_k_blocks
        r_fold = max(_cdiv(nq, max_rows), 1)
        c_fold = max(_cdiv(nk, max_cols), 1)
        grid = np.zeros((_cdiv(nq, r_fold), _cdiv(nk, c_fold)), np.float64)
        for i, row in enumerate(self.active):
            for kb in row:
                grid[i // r_fold, kb // c_fold] += 1.0
        grid /= float(r_fold * c_fold)
        lines = [
            f"block occupancy {nq}x{nk} tiles "
            f"(block {self.block_q}x{self.block_k}, "
            f"1 cell = {r_fold}x{c_fold} tiles, "
            f"density {self.block_density:.3f})"
        ]
        for r in range(grid.shape[0]):
            cells = (
                shades[min(int(v * (len(shades) - 1) + 0.999), len(shades) - 1)]
                for v in grid[r]
            )
            lines.append("  |" + "".join(cells) + "|")
        return "\n".join(lines)


def block_occupancy_map(
    q_ranges,
    k_ranges,
    attn_type_map,
    block_q: int,
    block_k: int,
    *,
    num_k_blocks: int | None = None,
) -> BlockOccupancyMap:
    """Exact per-q-block active-k-block map of a slice set at one
    blocking. ``num_k_blocks`` widens the k grid beyond the slices' own
    extent (e.g. the dispatched global KV length); defaults to the
    k-extent's block count.

    Memoized on ``(slices_digest, block_q, block_k, num_k_blocks)`` — a
    digest, not the range blobs (large varlen arrays must not be pinned
    as cache keys), exactly like the cost model's entry memo.
    """
    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    key = (
        "occ",
        slices_digest(q, k, t),
        int(block_q),
        int(block_k),
        num_k_blocks,
    )
    hit = _OCC_MEMO.get(key)
    if hit is None:
        if len(_OCC_MEMO) >= _ENTRY_MEMO_CAP:  # crude bound, never grows
            _OCC_MEMO.clear()
        hit = _OCC_MEMO[key] = _build_map(
            q, k, t, int(block_q), int(block_k), num_k_blocks
        )
    return hit


def _build_map(
    q: np.ndarray,
    k: np.ndarray,
    t: np.ndarray,
    block_q: int,
    block_k: int,
    num_k_blocks: int | None,
) -> BlockOccupancyMap:
    extent_q = int(q[:, 1].max()) if q.size else 0
    extent_k = int(k[:, 1].max()) if k.size else 0
    nq = max(_cdiv(extent_q, block_q), 1)
    nk_extent = max(_cdiv(extent_k, block_k), 1)
    if num_k_blocks is None:
        nk = nk_extent
    else:
        nk = int(num_k_blocks)
        if nk < nk_extent:
            # a narrower grid would emit active ids >= num_k_blocks —
            # a silently-corrupt kernel input; widening is the only
            # legal direction
            raise ValueError(
                f"num_k_blocks={nk} is narrower than the slices' own "
                f"k extent ({nk_extent} blocks of {block_k})"
            )
    rows: list[set[int]] = [set() for _ in range(nq)]
    for (q0, q1), (k0, k1), mt in zip(q.tolist(), k.tolist(), t.tolist()):
        if q1 <= q0 or k1 <= k0:
            continue
        idx, _, _, k_lo, k_hi = slice_block_k_spans(
            q0, q1, k0, k1, mt, block_q
        )
        for i, lo, hi in zip(idx.tolist(), k_lo.tolist(), k_hi.tolist()):
            if hi > lo:
                rows[i].update(range(lo // block_k, (hi - 1) // block_k + 1))
    return BlockOccupancyMap(
        block_q=block_q,
        block_k=block_k,
        num_q_blocks=nq,
        num_k_blocks=nk,
        active=tuple(tuple(sorted(r)) for r in rows),
    )
