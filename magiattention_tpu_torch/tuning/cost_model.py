"""Cost model: the mask-shape counting and the ranking of kernel choices.

The port of the JAX package's ``tuning/cost_model.py``, aimed at Hopper.

The counting is the reference's code: the exact mask area, the density
threshold below which a mask is heterogeneous, and the tile counts a
blocking schedules (:func:`estimate_entries` over
:func:`slice_block_k_spans`, the one counting primitive the roofline and
the occupancy maps share).

The ranking (:func:`rank_candidates`) prices each candidate the port can
launch: the tile(s) of ``ops/flex_attn.HOPPER_TILES`` for the head dim, on
the row-major grid and on the compact sparse grid, at head_block 1, G and
2G. A candidate costs its tensor-core work, ``4 d hq entries bq bk`` FLOPs
at the card's peak times a fitted efficiency, plus fixed fees per grid
slot: a live row-major slot, a dead one (a q block's slots past its own
entries, up to the grid's ``steps`` extent) and a live sparse-grid slot.
The efficiency and the three fees were fitted by least squares on the H100
(``chip_smoke.py``'s ``tuning`` phase); none of the reference's TPU
constants (its per-step fees, its peak, its scalar-memory entry budget)
comes over. Candidates within the model's error bar of the best are tied,
and ties go by the Hopper preference order: head_block G first, then the
row-major grid on dense masks and the sparse grid on heterogeneous ones
(below :data:`SPARSE_DENSITY_THRESHOLD`).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

# Below this covered fraction (true mask area / dense extent) a mask is
# heterogeneous: ties inside the model's error bar then go to the sparse grid.
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


# -- the ranking ----------------------------------------------------------------

# The card the efficiency and the fees below were fitted on; the model
# prices that card's datasheet bf16 peak (``utils/cost.py``).
FITTED_CARD = "NVIDIA H100 80GB HBM3"
# Fitted by non-negative least squares on relative residuals over the four
# forward kernels at every candidate of six workloads (``chip_smoke.py``'s
# ``tuning`` phase: the causal 4096 prefill at 32/8 and 32/32, causal 8192
# at 16/8, the hetero mask at 16/8 and 8/8, a sliding window of 512 on
# 8192), on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name,
# power.limit), the phase's first chip run, before the model used them: 32
# samples, predicted / measured 0.60-1.31, rms relative residual 0.20.
MMA_EFFICIENCY = 0.4469  # achieved share of the peak on scheduled tile FLOPs
LIVE_SLOT_S = 2.104e-10  # seconds a live row-major slot: a (head group, entry) visit
DEAD_SLOT_S = 6.781e-10  # seconds a dead row-major slot: past a q block's entries
SPARSE_SLOT_S = 1.392e-09  # seconds a live sparse-grid slot
# Candidates within this relative cost of the best are tied and resolved by
# the preference order (the model is not trusted below its own error bar).
TIE_TOLERANCE = 0.15
# The band on heterogeneous masks, where the fit's residuals are widest
# (predicted / measured 0.60-1.21 on the hetero and window samples).
SPARSE_TIE_TOLERANCE = 0.30
# What the forward launchers take (``ops/flex_attn.py`` ``_launch_fwd``,
# ``_launch_fwd_sparse``): the row-major grid's q blocks are its gridDim.y,
# and lengths and item counts are C ints.
MAX_GRID_Y = 65535
MAX_INT32 = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class CandidateScore:
    """One ranked candidate: its predicted cost and the counts behind it."""

    block_q: int
    block_k: int
    head_block: int  # snapped to the GQA geometry (``_auto_head_block``)
    entries: int  # exact tile count, dummies included
    steps: int  # most entries of any q block: the row-major grid's extent
    feasible: bool  # a launcher of the build takes it
    mma_seconds: float
    step_seconds: float
    grid: str = "row_major"  # or "sparse": the compact entry walk
    live_slots: int = 0  # grid rows x entries: slots that compute
    dead_slots: int = 0  # row-major slots past a q block's entries; 0 on the sparse grid

    @property
    def cost_seconds(self) -> float:
        return self.mma_seconds + self.step_seconds

    @property
    def grid_slots(self) -> int:
        return self.live_slots + self.dead_slots

    @property
    def kernel_config(self) -> tuple[int, int, int, str]:
        return (self.block_q, self.block_k, self.head_block, self.grid)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cost_seconds"] = self.cost_seconds
        d["grid_slots"] = self.grid_slots
        return d


def candidate_tiles(head_dim: int) -> list[tuple[int, int]]:
    """The tiles the kernels are built for at ``head_dim``
    (``HOPPER_TILES``; 64 x 64 for a head dim only the plain versions
    take)."""
    from ..ops.flex_attn import HOPPER_TILES

    return [HOPPER_TILES.get(int(head_dim), (64, 64))]


def slot_counts(entries: int, steps: int, nq: int, hq: int, head_block: int,
                grid: str) -> tuple[int, int]:
    """(live, dead) grid slots of a candidate: hq / head_block grid rows
    times the entries; the row-major grid's rows also hold ``nq * steps``
    slots each, the sparse grid's only their entries."""
    rows = max(hq // max(head_block, 1), 1)
    live = rows * entries
    dead = 0 if grid == "sparse" else max(rows * nq * steps - live, 0)
    return live, dead


def mma_seconds(head_dim: int, hq: int, entries: int, block_q: int, block_k: int) -> float:
    """The candidate's tile FLOPs at the fitted card's peak times
    :data:`MMA_EFFICIENCY`."""
    from ..utils.cost import card_spec

    peak = card_spec(FITTED_CARD).bf16_tflops * 1e12
    return 4.0 * head_dim * hq * entries * block_q * block_k / (peak * MMA_EFFICIENCY)


def step_seconds(live: int, dead: int, grid: str) -> float:
    if grid == "sparse":
        return live * SPARSE_SLOT_S
    return live * LIVE_SLOT_S + dead * DEAD_SLOT_S


def launch_feasible(extent_q: int, extent_k: int, hq: int, hk: int, head_dim: int,
                    block_q: int, block_k: int, head_block: int, grid: str) -> bool:
    """Whether a launcher of the build takes the candidate: the tile is the
    build's for ``head_dim``, head_block is 1 or a multiple of G dividing
    hq, and the grid and lengths fit the launchers' integers."""
    from ..ops.flex_attn import HOPPER_TILES

    if HOPPER_TILES.get(int(head_dim)) != (block_q, block_k):
        return False
    if hk <= 0 or hq % hk:
        return False
    group = hq // hk
    if head_block < 1 or (head_block > 1 and (head_block % group or hq % head_block)):
        return False
    nq = max(_cdiv(extent_q, block_q), 1)
    nk = max(_cdiv(extent_k, block_k), 1)
    if hq * nq * block_q > MAX_INT32 or hk * nk * block_k > MAX_INT32:
        return False
    if grid == "sparse":
        return hq // head_block * nq <= MAX_INT32
    return nq <= MAX_GRID_Y


def _extents(q: np.ndarray, k: np.ndarray) -> tuple[int, int]:
    return (int(q[:, 1].max()) if q.size else 0, int(k[:, 1].max()) if k.size else 0)


def smem_feasible(q_ranges, k_ranges, attn_type_map, block_q: int, block_k: int, *,
                  head_dim: int = 128, num_heads_q: int = 1, num_heads_kv: int = 1,
                  head_block: int = 1, grid: str = "row_major") -> bool:
    """The ranker's feasibility test of ONE candidate on the exact
    workload (:func:`launch_feasible`): it re-validates a tuning-cache hit,
    whose fingerprint's buckets can alias a workload the cached winner does
    not fit. The name is the reference's, whose test is its scalar-memory
    entry budget; the Hopper kernels read their tables from global memory
    and have none."""
    q, k, _t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    tq, tk = _extents(q, k)
    return launch_feasible(tq, tk, int(num_heads_q), int(num_heads_kv), int(head_dim),
                           int(block_q), int(block_k), int(head_block), grid)


def any_feasible_rung(q_ranges, k_ranges, attn_type_map, *, head_dim: int = 128,
                      num_heads_q: int = 1, num_heads_kv: int = 1,
                      max_block_q: int | None = None, max_block_k: int | None = None) -> bool:
    """True when a candidate tile fits the exact workload at head_block 1
    on the row-major grid: the escape hatch of the aliased-hit re-rank (if
    nothing fits, serving the cached winner is as good as re-ranking)."""
    return any(
        smem_feasible(q_ranges, k_ranges, attn_type_map, bq, bk, head_dim=head_dim,
                      num_heads_q=num_heads_q, num_heads_kv=num_heads_kv)
        for bq, bk in candidate_tiles(head_dim)
        if (max_block_q is None or bq <= max_block_q) and (max_block_k is None or bk <= max_block_k)
    )


def rank_candidates(
    q_ranges,
    k_ranges,
    attn_type_map,
    hq: int,
    hk: int,
    *,
    head_dim: int = 128,
    max_block_q: int | None = None,
    max_block_k: int | None = None,
    include_sparse: bool = True,
) -> list[CandidateScore]:
    """Score every candidate for the workload, best first.

    The candidates are each tile of :func:`candidate_tiles` on the
    row-major grid (and the sparse grid unless ``include_sparse`` is
    False: the cp kernels run the row-major grid) at head_block G, 1 and
    2G, snapped by ``ops.flex_attn._auto_head_block``; tiles larger than
    ``max_block_q`` / ``max_block_k`` (a cp rank's shard) are dropped, so
    the list can be empty.

    The order is cost-ascending, except that the candidates within
    :data:`TIE_TOLERANCE` of the best (:data:`SPARSE_TIE_TOLERANCE` on a
    heterogeneous mask, density below :data:`SPARSE_DENSITY_THRESHOLD`)
    lead, in the preference order: head_block G first, then the row-major
    grid on a dense mask, the sparse grid on a heterogeneous one. Where no
    candidate is feasible, every one is returned in the preference order
    with ``feasible=False``: the launch then raises its own error."""
    from ..ops.flex_attn import _auto_head_block

    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    hq, hk, head_dim = int(hq), int(hk), int(head_dim)
    tq, tk = _extents(q, k)
    group = max(hq // max(hk, 1), 1)
    grids = ("row_major", "sparse") if include_sparse else ("row_major",)
    scores: list[CandidateScore] = []
    seen: set = set()
    for bq, bk in candidate_tiles(head_dim):
        if (max_block_q is not None and bq > max_block_q) or (
                max_block_k is not None and bk > max_block_k):
            continue
        entries, steps, nq = estimate_entries(q, k, t, bq, bk)
        for grid in grids:
            for pref in (group, 1, 2 * group):
                hb = _auto_head_block(pref, hq, group)
                if (bq, bk, hb, grid) in seen:  # the snap can collapse preferences
                    continue
                seen.add((bq, bk, hb, grid))
                live, dead = slot_counts(entries, steps, nq, hq, hb, grid)
                scores.append(CandidateScore(
                    block_q=bq, block_k=bk, head_block=hb, entries=entries, steps=steps,
                    feasible=launch_feasible(tq, tk, hq, hk, head_dim, bq, bk, hb, grid),
                    mma_seconds=mma_seconds(head_dim, hq, entries, bq, bk),
                    step_seconds=step_seconds(live, dead, grid), grid=grid,
                    live_slots=live, dead_slots=dead,
                ))
    feasible = [s for s in scores if s.feasible]
    # the heterogeneous regime widens the band whichever grids are ranked:
    # the fit's residuals there are its widest on either grid
    hetero = exact_mask_area(q, k, t) / max(tq * tk, 1) < SPARSE_DENSITY_THRESHOLD
    preferred = "sparse" if hetero and any(s.grid == "sparse" for s in feasible or scores) \
        else "row_major"

    def preference(s: CandidateScore):
        return (s.head_block != group, s.grid != preferred)

    if not feasible:
        return sorted(scores, key=preference)
    best = min(s.cost_seconds for s in feasible)
    tol = SPARSE_TIE_TOLERANCE if hetero else TIE_TOLERANCE
    tied = sorted((s for s in feasible if s.cost_seconds <= best * (1.0 + tol)),
                  key=lambda s: (*preference(s), s.cost_seconds))
    rest = sorted((s for s in scores if s not in tied), key=lambda s: s.cost_seconds)
    return tied + rest
