"""Host-side block metadata (entry tables) for the flex-attention kernel.

Per unique (mask, layout, blocking) the planner precomputes a flattened
*entry table*: one entry per (q-block, k-block, slice, run-pair) tile that
intersects the mask. The kernel walks a q block's entries in a loop inside
one thread block, so accumulation stays on chip and no atomics are needed.

Entries carry *run* fields (local window + local->global offset): a rank's
local Q/K buffers may be permuted concatenations of global segments, and the
kernel evaluates the ORIGINAL global-coordinate mask on (local + offset)
indices. The single-device path uses identity runs.

Tables are built in both orientations:
- q-major (sorted by q-block): the forward kernel,
- k-major (sorted by k-block): the backward dk/dv kernel (built, unused in
  the forward-only serving slice).

Every q-block (resp. k-block) has at least one entry — a dummy all-masked
entry pointing at the sentinel slice — so every output tile is written
(out=0 / lse=-inf for uncovered rows).

The tables are byte-identical to the JAX package's ``ops/block_meta.py``
(held so by ``tests/test_torch_block_meta.py``, and per cp rank by
``tests/test_torch_dist_plan.py``). The entry loop runs in the port's native
emitter (``csrc/entry_table.cpp``, built with g++ on first use) unless
``MAGI_ATTENTION_CPP_BACKEND=0``; its Python twin :func:`_emit_entries`
gives the same bytes (``tests/test_torch_entry_table.py``).
The distributed plan builder (``parallel/dist_attn.py``) describes a rank's
buffers by :func:`runs_from_position_ids` and levels the per-rank tables
to one length with :func:`pad_block_meta`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Fields per slice in the flattened bounds table (global coords).
SLICE_FIELDS = 5  # qs, qe, ks, ke, mask_type
# Fields per entry in the flattened runs table (local windows + offsets).
RUN_FIELDS = 7  # ql0, ql1, kl0, kl1, qoff, koff, needs_mask (diagnostic)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclasses.dataclass(frozen=True)
class Run:
    """A contiguous segment: local rows [local_start, local_start+length)
    hold global positions [global_start, global_start+length)."""

    local_start: int
    global_start: int
    length: int

    @property
    def local_end(self) -> int:
        return self.local_start + self.length

    @property
    def global_end(self) -> int:
        return self.global_start + self.length

    @property
    def offset(self) -> int:
        return self.global_start - self.local_start


def runs_from_position_ids(position_ids: np.ndarray) -> list[Run]:
    """Compress a local->global id map into maximal contiguous runs: run
    boundaries are where the id does not advance by 1."""
    pos = np.asarray(position_ids, dtype=np.int64).reshape(-1)
    n = pos.shape[0]
    if n == 0:
        return []
    starts = np.concatenate(([0], np.flatnonzero(np.diff(pos) != 1) + 1))
    ends = np.concatenate((starts[1:], [n]))
    return [
        Run(local_start=int(s), global_start=int(pos[s]), length=int(e - s))
        for s, e in zip(starts, ends)
    ]


def identity_runs(total: int) -> list[Run]:
    return [Run(0, 0, total)] if total > 0 else []


@dataclasses.dataclass(frozen=True, eq=False)
class FlexAttnBlockMeta:
    """Immutable host-side kernel plan for one (mask, layout, blocking) combo.

    All arrays are numpy int32; the flex wrapper copies them to the device
    once per plan. ``slice_bounds`` is [num_slices+1, SLICE_FIELDS]
    flattened; the last row is the all-zero sentinel used by dummy entries.
    """

    total_q: int  # local q rows (padded to block_q multiple by the wrapper)
    total_k: int
    block_q: int
    block_k: int
    num_q_blocks: int
    num_k_blocks: int
    num_slices: int
    total_area: int  # exact unmasked pair count of the plan

    # q-major table (forward)
    fwd_q_block: np.ndarray  # [E]
    fwd_k_block: np.ndarray  # [E]
    fwd_slice_id: np.ndarray  # [E]
    fwd_runs: np.ndarray  # [E * RUN_FIELDS]

    # k-major table (dk/dv backward)
    bwd_k_block: np.ndarray  # [E2]
    bwd_q_block: np.ndarray  # [E2]
    bwd_slice_id: np.ndarray  # [E2]
    bwd_runs: np.ndarray  # [E2 * RUN_FIELDS]

    slice_bounds: np.ndarray  # [(num_slices+1) * SLICE_FIELDS]

    @property
    def num_fwd_entries(self) -> int:
        return int(self.fwd_q_block.shape[0])

    @property
    def num_bwd_entries(self) -> int:
        return int(self.bwd_k_block.shape[0])

    @property
    def fwd_steps(self) -> int:
        """Max fwd entries on any q block: the kernel's longest entry walk."""
        return max_row_count(self.fwd_q_block, self.num_q_blocks)

    @property
    def bwd_steps(self) -> int:
        """Max bwd entries on any k block."""
        return max_row_count(self.bwd_k_block, self.num_k_blocks)


def max_row_count(major: np.ndarray, num_major: int) -> int:
    """Max entries sharing one major block (>= 1: dummies cover all majors)."""
    if num_major <= 0 or major.size == 0:
        return 1
    return int(np.bincount(np.asarray(major), minlength=num_major).max())


def _slice_k_span(
    gq_lo: int, gq_hi: int, ks: int, ke: int, qs: int, qe: int, mask_type: int
) -> tuple[int, int]:
    """Global k interval attended by global q rows [gq_lo, gq_hi) of a slice."""
    k_lo, k_hi = ks, ke
    if mask_type & 1:  # causal: k - ke <= q - qe; max row gq_hi-1
        k_hi = min(k_hi, ke - qe + gq_hi)
    if mask_type & 2:  # inv-causal: k - ks >= q - qs; min row gq_lo
        k_lo = max(k_lo, ks + (gq_lo - qs))
    return k_lo, k_hi


def _emit_entries(
    slices: np.ndarray,  # [S, 5] (qs, qe, ks, ke, type) global coords
    q_runs: Sequence[Run],
    k_runs: Sequence[Run],
    block_q: int,
    block_k: int,
) -> list[tuple]:
    """All (q_block, k_block, slice, runfields...) tiles intersecting the mask.

    Entry tuple: (qblk, kblk, sid, ql0, ql1, kl0, kl1, qoff, koff).
    """
    out: list[tuple] = []
    for sid in range(slices.shape[0]):
        qs, qe, ks, ke, mt = (int(x) for x in slices[sid])
        if qs >= qe or ks >= ke:
            continue
        for qr in q_runs:
            gq_lo = max(qs, qr.global_start)
            gq_hi = min(qe, qr.global_end)
            if gq_lo >= gq_hi:
                continue
            ql_lo = gq_lo - qr.offset  # local rows
            ql_hi = gq_hi - qr.offset
            for i in range(ql_lo // block_q, _cdiv(ql_hi, block_q)):
                bq_lo = max(ql_lo, i * block_q)
                bq_hi = min(ql_hi, (i + 1) * block_q)
                k_lo, k_hi = _slice_k_span(
                    bq_lo + qr.offset, bq_hi + qr.offset, ks, ke, qs, qe, mt
                )
                if k_hi <= k_lo:
                    continue
                for kr in k_runs:
                    gk_lo = max(k_lo, kr.global_start)
                    gk_hi = min(k_hi, kr.global_end)
                    if gk_lo >= gk_hi:
                        continue
                    kl_lo = gk_lo - kr.offset
                    kl_hi = gk_hi - kr.offset
                    for j in range(kl_lo // block_k, _cdiv(kl_hi, block_k)):
                        out.append(
                            (
                                i,
                                j,
                                sid,
                                bq_lo,
                                bq_hi,
                                max(kl_lo, j * block_k),
                                min(kl_hi, (j + 1) * block_k),
                                qr.offset,
                                kr.offset,
                            )
                        )
    return out


def _needs_mask_flags(
    entries: np.ndarray,  # [E, 9] sorted entries
    slices: np.ndarray,  # [S, 5]
    block_q: int,
    block_k: int,
) -> np.ndarray:
    """1 where the tile's mask constraints actually bind, 0 where it is
    provably fully unmasked. Diagnostic only (``RUN_FIELDS`` slot 6): the
    kernels apply the row-interval mask unconditionally."""
    from .. import env

    e = entries.shape[0]
    if e == 0 or slices.shape[0] == 0 or env.mask_skip_disabled():
        return np.ones((e,), dtype=np.int64)
    qb = entries[:, 0]
    kb = entries[:, 1]
    sid = np.minimum(entries[:, 2], slices.shape[0] - 1)
    dummy = entries[:, 2] >= slices.shape[0]
    ql0, ql1 = entries[:, 3], entries[:, 4]
    kl0, kl1 = entries[:, 5], entries[:, 6]
    qoff, koff = entries[:, 7], entries[:, 8]
    r0 = qb * block_q
    c0 = kb * block_k
    # window covers the whole tile
    full = (ql0 <= r0) & (ql1 >= r0 + block_q) & (kl0 <= c0) & (
        kl1 >= c0 + block_k
    )
    qs, qe = slices[sid, 0], slices[sid, 1]
    ks, ke = slices[sid, 2], slices[sid, 3]
    mt = slices[sid, 4]
    gq_lo, gq_hi = r0 + qoff, r0 + block_q - 1 + qoff
    gk_lo, gk_hi = c0 + koff, c0 + block_k - 1 + koff
    full &= (gq_lo >= qs) & (gq_hi < qe) & (gk_lo >= ks) & (gk_hi < ke)
    causal = (mt & 1) != 0
    inv = (mt & 2) != 0
    # causal worst corner: top row, rightmost col
    full &= ~causal | ((gk_hi - ke) <= (gq_lo - qe))
    # inv-causal worst corner: bottom row, leftmost col
    full &= ~inv | ((gk_lo - ks) >= (gq_hi - qs))
    full &= ~dummy
    return (~full).astype(np.int64)


def _distribute_pad_majors(
    major: np.ndarray, extra: int, num_major: int
) -> np.ndarray:
    """Major-block values for ``extra`` inert pad entries, chosen to keep
    per-major row counts level (always the currently-shortest row)."""
    import heapq

    counts = np.bincount(
        np.asarray(major, dtype=np.int64), minlength=max(num_major, 1)
    )
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    out = np.empty(extra, np.int32)
    for n in range(extra):
        c, i = heapq.heappop(heap)
        out[n] = i
        heapq.heappush(heap, (c + 1, i))
    return out


def _append_pads_leveled(
    major: np.ndarray,
    minor: np.ndarray,
    sid: np.ndarray,
    runs: np.ndarray,
    extra: int,
    num_major: int,
    sentinel: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Append ``extra`` inert (sentinel-slice, all-masked) pad entries with
    leveled major assignment, then stable-resort by major so each major's
    entries stay contiguous (the row-major kernels require it)."""
    pad_major = _distribute_pad_majors(major, extra, num_major)
    pad_runs = np.zeros((extra, RUN_FIELDS), np.int32)
    pad_runs[:, 6] = 1  # diagnostic flag: sentinel-slice pads are all-masked
    major = np.concatenate([major, pad_major])
    minor = np.concatenate([minor, np.zeros(extra, np.int32)])
    sid = np.concatenate([sid, np.full(extra, sentinel, np.int32)])
    runs2 = np.concatenate([runs.reshape(-1, RUN_FIELDS), pad_runs], axis=0)
    order = np.argsort(major, kind="stable")
    return (
        np.ascontiguousarray(major[order]),
        np.ascontiguousarray(minor[order]),
        np.ascontiguousarray(sid[order]),
        np.ascontiguousarray(runs2[order].reshape(-1)),
    )


def _build_table(
    entries: np.ndarray,  # [E, 9] entry tuples
    num_major_blocks: int,
    sentinel_slice: int,
    pad_to: int,
    major_col: int,
    slices: np.ndarray,
    block_q: int,
    block_k: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort by major block, add dummies for uncovered majors, pad length."""
    dummy = [0] * 9
    dummy[2] = sentinel_slice
    covered = np.zeros(num_major_blocks, dtype=bool)
    if entries.size:
        covered[entries[:, major_col]] = True
    dummies = []
    for i in range(num_major_blocks):
        if not covered[i]:
            row = list(dummy)
            row[major_col] = i
            dummies.append(row)
    if dummies:
        d = np.asarray(dummies, dtype=np.int64)
        entries = np.concatenate([entries, d], axis=0) if entries.size else d
    minor_col = 1 - major_col
    order = np.lexsort(
        (entries[:, 2], entries[:, minor_col], entries[:, major_col])
    )
    entries = entries[order]
    e = entries.shape[0]
    target = max(_round_up(e, max(pad_to, 1)), 1)
    if target > e:
        pad = np.tile(np.asarray([dummy], dtype=np.int64), (target - e, 1))
        pad[:, major_col] = _distribute_pad_majors(
            entries[:, major_col], target - e, num_major_blocks
        )
        entries = np.concatenate([entries, pad], axis=0)
        entries = entries[np.argsort(entries[:, major_col], kind="stable")]
    flags = _needs_mask_flags(entries, slices, block_q, block_k)
    major = entries[:, major_col].astype(np.int32)
    minor = entries[:, minor_col].astype(np.int32)
    sid = entries[:, 2].astype(np.int32)
    runs = np.concatenate(
        [entries[:, 3:9], flags[:, None]], axis=1
    ).astype(np.int32).reshape(-1)
    return major, minor, sid, runs


def _sub_area(a, b, c, d, qs, qe, ks, ke, mt) -> int:
    """Unmasked pairs in global sub-rectangle rows [a,b) x cols [c,d)."""
    q = np.arange(a, b, dtype=np.int64)
    lo = (ks + (q - qs)) if (mt & 2) else np.full_like(q, ks)
    hi = (ke - qe + q + 1) if (mt & 1) else np.full_like(q, ke)
    cnt = np.minimum(hi, d) - np.maximum(lo, c)
    return int(np.maximum(cnt, 0).sum())


def _slice_area_runs(slices: np.ndarray, q_runs: Sequence[Run], k_runs: Sequence[Run]) -> int:
    """Exact unmasked pairs of the slices restricted to (q_runs x k_runs):
    each slice intersected with the runs (a slice may reference global
    rows/cols these buffers do not hold). The Python twin of the native
    ``magi_torch_slice_area_runs``."""
    area = 0
    for sid in range(slices.shape[0]):
        qs, qe, ks, ke, mt = (int(x) for x in slices[sid])
        for qr in q_runs:
            a, b = max(qs, qr.global_start), min(qe, qr.global_end)
            if a >= b:
                continue
            k_lo, k_hi = _slice_k_span(a, b, ks, ke, qs, qe, mt)
            for kr in k_runs:
                c, d = max(k_lo, kr.global_start), min(k_hi, kr.global_end)
                if c >= d:
                    continue
                area += _sub_area(a, b, c, d, qs, qe, ks, ke, mt)
    return area


def build_block_meta_general(
    slices: np.ndarray,  # [S, 5] global (qs, qe, ks, ke, type)
    q_runs: Sequence[Run],
    k_runs: Sequence[Run],
    total_q: int,  # local q rows
    total_k: int,  # local k rows
    *,
    block_q: int = 128,
    block_k: int = 128,
    entry_pad: int = 8,
    pad_entries_to: int | None = None,  # uniform E across ranks
    pad_bwd_entries_to: int | None = None,
    num_slices_padded: int | None = None,
) -> FlexAttnBlockMeta:
    """Build entry tables for one local attention problem.

    Local buffers are described by runs (local<->global segment map); the
    mask slices stay in global coordinates. The entries and the exact area
    come from the native emitter (``csrc.emit_entries_native``) under
    ``MAGI_ATTENTION_CPP_BACKEND`` (default on), else from
    :func:`_emit_entries` / :func:`_slice_area_runs`: the same bytes.
    """
    slices = np.asarray(slices, dtype=np.int64).reshape(-1, SLICE_FIELDS)
    q_runs, k_runs = list(q_runs), list(k_runs)
    from .. import csrc

    if csrc.host_enabled():  # the native emitter (csrc/entry_table.cpp): the same bytes
        entries = csrc.emit_entries_native(slices, q_runs, k_runs, block_q, block_k)
        area = csrc.slice_area_runs_native(slices, q_runs, k_runs)
    else:
        ent = _emit_entries(slices, q_runs, k_runs, block_q, block_k)
        entries = np.asarray(ent, dtype=np.int64) if ent else np.empty((0, 9), np.int64)
        area = _slice_area_runs(slices, q_runs, k_runs)

    return assemble_block_meta(
        entries, slices, total_q, total_k, block_q, block_k, int(area),
        entry_pad=entry_pad, pad_entries_to=pad_entries_to,
        pad_bwd_entries_to=pad_bwd_entries_to, num_slices_padded=num_slices_padded,
    )


def assemble_block_meta(
    entries: np.ndarray,  # [E, 9] (qblk, kblk, sid, ql0, ql1, kl0, kl1, qoff, koff)
    slices: np.ndarray,  # [S, SLICE_FIELDS]
    total_q: int,
    total_k: int,
    block_q: int,
    block_k: int,
    total_area: int,
    *,
    entry_pad: int = 8,
    pad_entries_to: int | None = None,
    pad_bwd_entries_to: int | None = None,
    num_slices_padded: int | None = None,
) -> FlexAttnBlockMeta:
    """Entries + slices -> FlexAttnBlockMeta: sort both orientations, add
    dummies and pads, assemble the bounds."""
    S = slices.shape[0]
    nq = max(_cdiv(total_q, block_q), 1)
    nk = max(_cdiv(total_k, block_k), 1)
    fwd = _build_table(entries.copy(), nq, S, entry_pad, 0, slices, block_q, block_k)
    bwd = _build_table(entries.copy(), nk, S, entry_pad, 1, slices, block_q, block_k)

    def _pad_table(table, target, num_major):
        e = table[0].shape[0]
        if target is None or target <= e:
            if target is not None and target != e:
                raise ValueError(f"table length {e} exceeds the requested pad {target}")
            return table
        return _append_pads_leveled(*table, target - e, num_major, S)

    fwd = _pad_table(fwd, pad_entries_to, nq)
    bwd = _pad_table(bwd, pad_bwd_entries_to, nk)

    n_slices_store = S if num_slices_padded is None else num_slices_padded
    if n_slices_store < S:
        raise ValueError(f"num_slices_padded {n_slices_store} < {S} slices")
    bounds = np.zeros((n_slices_store + 1, SLICE_FIELDS), dtype=np.int32)
    bounds[:S] = slices  # rows S.. stay all-zero: sentinels (all-masked)

    return FlexAttnBlockMeta(
        total_q=total_q,
        total_k=total_k,
        block_q=block_q,
        block_k=block_k,
        num_q_blocks=nq,
        num_k_blocks=nk,
        num_slices=n_slices_store,
        total_area=int(total_area),
        fwd_q_block=fwd[0],
        fwd_k_block=fwd[1],
        fwd_slice_id=fwd[2],
        fwd_runs=fwd[3],
        bwd_k_block=bwd[0],
        bwd_q_block=bwd[1],
        bwd_slice_id=bwd[2],
        bwd_runs=bwd[3],
        slice_bounds=bounds.reshape(-1),
    )


def pad_block_meta(
    meta: FlexAttnBlockMeta,
    pad_entries_to: int,
    pad_bwd_entries_to: int,
    num_slices_padded: int,
) -> FlexAttnBlockMeta:
    """Pad a built meta's tables to uniform lengths across cp ranks: pad
    entries take the sentinel slice (all-masked, inert) on the shortest
    major blocks; extra bounds rows are zeros (further sentinels)."""
    S = meta.num_slices
    if num_slices_padded < S:
        raise ValueError(f"num_slices_padded {num_slices_padded} < {S} slices")

    def pad_tab(table, target, num_major):
        e = table[0].shape[0]
        if target < e:
            raise ValueError(f"table length {e} exceeds the pad target {target}")
        if target == e:
            return table
        return _append_pads_leveled(*table, target - e, num_major, S)

    fq, fk, fs, fr = pad_tab(
        (meta.fwd_q_block, meta.fwd_k_block, meta.fwd_slice_id, meta.fwd_runs),
        pad_entries_to, meta.num_q_blocks,
    )
    bk, bq, bs, br = pad_tab(
        (meta.bwd_k_block, meta.bwd_q_block, meta.bwd_slice_id, meta.bwd_runs),
        pad_bwd_entries_to, meta.num_k_blocks,
    )
    bounds = np.zeros(((num_slices_padded + 1) * SLICE_FIELDS,), np.int32)
    bounds[: meta.slice_bounds.shape[0]] = meta.slice_bounds
    return dataclasses.replace(
        meta,
        num_slices=num_slices_padded,
        fwd_q_block=fq,
        fwd_k_block=fk,
        fwd_slice_id=fs,
        fwd_runs=fr,
        bwd_k_block=bk,
        bwd_q_block=bq,
        bwd_slice_id=bs,
        bwd_runs=br,
        slice_bounds=bounds,
    )


def build_block_meta(
    q_ranges: np.ndarray | Sequence[Sequence[int]],
    k_ranges: np.ndarray | Sequence[Sequence[int]],
    attn_type_map: np.ndarray | Sequence[int],
    total_q: int,
    total_k: int,
    *,
    block_q: int = 128,
    block_k: int = 128,
    entry_pad: int = 8,
) -> FlexAttnBlockMeta:
    """Single-device plan: identity runs, slices given as range lists."""
    q_arr = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    k_arr = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    t_arr = np.asarray(attn_type_map, dtype=np.int64).reshape(-1)
    if not q_arr.shape[0] == k_arr.shape[0] == t_arr.shape[0]:
        raise ValueError(
            f"build_block_meta: {q_arr.shape[0]} q ranges, {k_arr.shape[0]} "
            f"k ranges and {t_arr.shape[0]} mask types must agree"
        )
    for s in range(t_arr.shape[0]):
        if not 0 <= q_arr[s, 0] <= q_arr[s, 1] <= total_q:
            raise ValueError(f"slice {s}: bad q_range [{q_arr[s,0]},{q_arr[s,1]})")
        if not 0 <= k_arr[s, 0] <= k_arr[s, 1] <= total_k:
            raise ValueError(f"slice {s}: bad k_range [{k_arr[s,0]},{k_arr[s,1]})")
        if not 0 <= t_arr[s] <= 3:
            raise ValueError(f"slice {s}: bad mask type {t_arr[s]}")
    slices = np.concatenate([q_arr, k_arr, t_arr[:, None]], axis=1)  # [S, 5]
    return build_block_meta_general(
        slices,
        identity_runs(total_q),
        identity_runs(total_k),
        total_q,
        total_k,
        block_q=block_q,
        block_k=block_k,
        entry_pad=entry_pad,
    )
