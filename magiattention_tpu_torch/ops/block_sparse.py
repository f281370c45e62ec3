"""Block-sparse attention: the block-enumeration primitive and the
block-mask driver of the flex kernels.

The counterpart of the JAX package's ``ops/block_sparse.py``. A boolean
block mask ``[num_q_blocks, num_k_blocks]`` says which (block_q x block_k)
tiles of the caller's blocking attend; each one becomes kernel entries
whose run window bounds exactly that tile, against at most two global
slices: FULL for interior tiles, and the bottom-right CAUSAL slice
(``k <= q + total_k - total_q``) for the tiles the diagonal crosses.

:class:`BlockEnumeration` is the flattened major -> minor block walk the
sparse consumers share (per major row, the sorted minor blocks it touches,
with the row tables and the clamped entry lookup): the flex kernels walk it
over the entry tables, the split-KV decode over the paged block table, and
an occupancy map loads straight into it (:meth:`BlockEnumeration.from_occupancy`).

The Hopper kernels take one tile, 64 x 64 (``flex_attn.HOPPER_TILES``),
while a caller's blocking is its own (the JAX default is 128 x 128, its
tests go down to 32, and a blocking need not divide the tile). The mask
means "these caller tiles attend", so :func:`block_sparse_attn_func` builds
the plan the kernel walks at the kernel tile: each selected caller tile
gives one entry per kernel tile it overlaps, the entry's window their
intersection, FULL or CAUSAL by whether the diagonal crosses that window,
windows wholly above the diagonal dropped. At the caller's own blocking the
tables are byte-identical to the JAX package's; at the kernel tile the set
of attended (q, k) pairs is (``tests/test_torch_block_sparse.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .block_meta import FlexAttnBlockMeta, _slice_k_span, _sub_area, assemble_block_meta


def row_tables(major, num_rows: int):
    """Per-major-row ``(start, count)`` (int32) over a SORTED major array
    (numpy or a tensor): row i's entries are ``start[i] .. start[i]+count[i]``.
    The flex kernel loops over exactly that span for its q block."""
    if isinstance(major, torch.Tensor):
        idx = torch.arange(num_rows, dtype=major.dtype, device=major.device)
        rs = torch.searchsorted(major, idx, side="left").to(torch.int32)
        re = torch.searchsorted(major, idx, side="right").to(torch.int32)
        return rs, re - rs
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


@dataclasses.dataclass(frozen=True, eq=False)
class BlockEnumeration:
    """Flattened major -> minor block walk: entry e pairs major row
    ``major[e]`` with minor block ``minor[e]``; ``major`` is sorted
    ascending, so each row's entries are consecutive,
    ``row_start[i] .. row_start[i]+row_count[i]``. Arrays are host numpy
    (kernel planning) or tensors (a block table on the device); a row with
    no entries has ``row_count == 0``."""

    num_rows: int
    major: np.ndarray  # [E] sorted row id per entry
    minor: np.ndarray  # [E] minor block id per entry
    row_start: np.ndarray  # [num_rows]
    row_count: np.ndarray  # [num_rows]

    @property
    def num_entries(self) -> int:
        return int(self.major.shape[0])

    def entry(self, i: int, j: int) -> int:
        """Clamped entry index of step j in row i (:func:`clamped_entry`)."""
        return clamped_entry(self.row_start, self.row_count, i, j)

    def occupied_pairs(self) -> np.ndarray:
        """[E, 2] (major, minor) pairs on the host."""
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

        return np.stack([host(self.major), host(self.minor)], axis=1)

    @staticmethod
    def from_sorted(major, minor, num_rows: int) -> "BlockEnumeration":
        """Wrap already-sorted (major, minor) arrays, the flex entry tables'
        orientation (numpy or tensors)."""
        rs, rc = row_tables(major, num_rows)
        return BlockEnumeration(num_rows=int(num_rows), major=major, minor=minor,
                                row_start=rs, row_count=rc)

    @staticmethod
    def from_active_lists(active, num_rows: int | None = None) -> "BlockEnumeration":
        """From per-row lists of active minor blocks (the ``active_k_blocks``
        of an occupancy map)."""
        rows = [sorted(int(b) for b in row) for row in active]
        if num_rows is None:
            num_rows = len(rows)
        if len(rows) != num_rows:
            raise ValueError(f"block enumeration: {len(rows)} active rows != num_rows {num_rows}")
        counts = np.asarray([len(r) for r in rows], dtype=np.int32)
        major = np.repeat(np.arange(num_rows, dtype=np.int32), counts)
        minor = np.asarray([b for row in rows for b in row], dtype=np.int32).reshape(-1)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int32)
        return BlockEnumeration(num_rows=int(num_rows), major=major, minor=minor,
                                row_start=starts, row_count=counts)

    @staticmethod
    def from_occupancy(occ) -> "BlockEnumeration":
        """From a block-occupancy map: its JSON dict (``active_k_blocks``,
        ``num_q_blocks``) or an object with ``active`` and
        ``num_q_blocks``."""
        if isinstance(occ, dict):
            return BlockEnumeration.from_active_lists(occ["active_k_blocks"],
                                                      int(occ["num_q_blocks"]))
        return BlockEnumeration.from_active_lists(occ.active, int(occ.num_q_blocks))

    @staticmethod
    def from_block_table(block_table, num_splits: int, *,
                         num_pages: int | None = None) -> "BlockEnumeration":
        """The split-KV decode walk: rows are (sequence, split) pairs, minors
        the page ids of the paged block table ``[b, MPP]`` (numpy or a
        tensor), ``MPP // num_splits`` pages per split, so every row is full
        and the clamped lookup is plain flat indexing. With ``num_pages``,
        every page id is checked against ``[0, num_pages)`` and one outside
        raises naming its row, entry and id (a table wider than its pool
        would read another sequence's KV)."""
        b, mpp = block_table.shape
        if mpp % num_splits:
            raise ValueError(f"block enumeration: table width {mpp} is not divisible "
                             f"by num_splits {num_splits}")
        tensor = isinstance(block_table, torch.Tensor)
        if num_pages is not None:
            host = block_table.cpu().numpy() if tensor else np.asarray(block_table)
            bad = (host < 0) | (host >= int(num_pages))
            if bad.any():
                r, c = (int(x) for x in np.argwhere(bad)[0])
                raise ValueError(
                    f"block enumeration: slot row {r} entry {c} references page "
                    f"{int(host[r, c])}, outside the {int(num_pages)}-page pool — the block "
                    "table is wider than the pool it indexes")
        pps = mpp // num_splits
        num_rows = b * num_splits
        if tensor:
            rows = torch.arange(num_rows, dtype=torch.int32, device=block_table.device)
            return BlockEnumeration(
                num_rows=num_rows, major=rows.repeat_interleave(pps),
                minor=block_table.reshape(-1).to(torch.int32), row_start=rows * pps,
                row_count=torch.full((num_rows,), pps, dtype=torch.int32,
                                     device=block_table.device))
        rows = np.arange(num_rows, dtype=np.int32)
        return BlockEnumeration(
            num_rows=num_rows, major=np.repeat(rows, pps),
            minor=np.asarray(block_table).reshape(-1).astype(np.int32), row_start=rows * pps,
            row_count=np.full((num_rows,), pps, np.int32))


# -- the unified serving tick's enumeration -----------------------------------------


def _pow2_bucket(n: int, lo: int = 1) -> int:
    """Next power of two >= max(n, lo): the tick geometry's capacity bucket,
    so a tick's table shape follows the token budget's bucket, never the
    request mix."""
    n = max(int(n), int(lo))
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class TickSegment:
    """One request's row span inside a :class:`TickEnumeration`.

    - ``kind``: ``"decode"`` (one q row) or ``"prefill"`` (one row per chunk
      token);
    - ``key``: the caller's demux handle (the engine uses the item index);
    - ``row_lo .. row_hi``: the request's main rows, in q-row order;
    - ``prefix_row``: a cascade member's shared-prefix partial row (merged
      into the single main row through ``ops/correction``), or -1.
    """

    kind: str
    key: object
    row_lo: int
    row_hi: int
    prefix_row: int = -1

    @property
    def num_rows(self) -> int:
        return self.row_hi - self.row_lo


class TickEnumeration:
    """One serving tick's attention work as a single page table for the
    split-KV decode kernel. Every row is one query token against a page-table
    prefix:

    - a **decode** step is one row: the slot's pages, valid = the
      post-append sequence length;
    - token ``i`` of a **prefill chunk** starting at ``start`` is one row
      over the history's pages with valid = ``start + i + 1``: causal
      masking is prefix-length masking;
    - a **cascade** member adds a row over the shared prefix pages before
      its main row over the suffix pages (table-relative valid); the two
      partials merge through ``correct_attn_out_lse`` after the launch.

    :meth:`finalize` pads rows and entries to power-of-two buckets: padding
    rows have valid 0 (exact ``(0, -inf)`` partials), padding entries page
    0 (masked by the valid length, never read). The same host tables as the
    JAX package's ``TickEnumeration``, byte for byte."""

    def __init__(self, page_size: int, *, min_rows: int = 8):
        self.page_size = int(page_size)
        self.min_rows = int(min_rows)
        self._pages: list[tuple[int, ...]] = []  # per-row page prefix
        self._valid: list[int] = []  # per-row covered tokens
        self._segments: list[TickSegment] = []
        self._capacity: tuple[int, int] | None = None

    def _add_row(self, pages, valid: int, what: str, key) -> int:
        pages = tuple(int(p) for p in pages)
        valid = int(valid)
        if valid < 0 or valid > len(pages) * self.page_size:
            raise ValueError(
                f"tick enumeration: {what} row for {key!r} covers {valid} tokens but its "
                f"{len(pages)} pages hold at most {len(pages) * self.page_size} — the page "
                "prefix does not cover the row's history")
        self._capacity = None
        self._pages.append(pages)
        self._valid.append(valid)
        return len(self._pages) - 1

    def add_decode(self, key, pages, valid_len: int, *, prefix_pages=(),
                   prefix_len: int = 0) -> TickSegment:
        """One decode row over ``pages`` covering ``valid_len`` tokens. With
        ``prefix_pages`` the row is a cascade member: ``pages`` holds only
        the suffix pages, ``valid_len`` is table-relative (length minus
        ``prefix_len``), and a row over the shared ``prefix_pages`` is added
        before it."""
        prefix_row = -1
        if prefix_pages:
            prefix_row = self._add_row(prefix_pages, prefix_len, "cascade-prefix", key)
        lo = self._add_row(pages, valid_len, "decode", key)
        seg = TickSegment(kind="decode", key=key, row_lo=lo, row_hi=lo + 1, prefix_row=prefix_row)
        self._segments.append(seg)
        return seg

    def add_prefill(self, key, pages, start: int, tokens: int) -> TickSegment:
        """One prefill chunk: ``tokens`` rows over one page prefix (which
        must cover ``start + tokens``); row ``i`` attends ``start + i + 1``
        tokens, as token ``start + i`` of a one-shot causal prefill."""
        start, tokens = int(start), int(tokens)
        if tokens <= 0:
            raise ValueError(
                f"tick enumeration: prefill chunk for {key!r} has {tokens} tokens; zero-token "
                "chunks never enumerate (the engine's fully-cached early return handles them)")
        pages = tuple(int(p) for p in pages)
        # the rows share one page tuple; the first row whose valid length the
        # pages cannot hold (if any) raises as _add_row does, after the rows
        # before it, as a row-by-row loop would
        cap = len(pages) * self.page_size
        bad = 0 if start + 1 < 0 else max(cap - start, 0)
        ok = min(bad, tokens)
        lo = len(self._pages)
        self._capacity = None
        self._pages.extend([pages] * ok)
        self._valid.extend(range(start + 1, start + ok + 1))
        if ok < tokens:
            self._add_row(pages, start + ok + 1, "prefill", key)
        seg = TickSegment(kind="prefill", key=key, row_lo=lo, row_hi=lo + tokens)
        self._segments.append(seg)
        return seg

    @property
    def num_rows(self) -> int:
        return len(self._pages)

    @property
    def segments(self) -> tuple[TickSegment, ...]:
        return tuple(self._segments)

    def finalize(self) -> tuple[int, int]:
        """Freeze the capacity buckets: ``(row_capacity, entry_capacity)``.
        A tick with cascade pairs always keeps a padding (dead) row, where
        :meth:`merge_pairs` pads."""
        if self._capacity is None:
            rows = _pow2_bucket(len(self._pages), self.min_rows)
            entries = _pow2_bucket(max((len(p) for p in self._pages), default=1), 1)
            n_pairs = sum(1 for s in self._segments if s.prefix_row >= 0)
            if n_pairs and rows == len(self._pages):
                rows *= 2
            self._capacity = (rows, entries)
        return self._capacity

    @property
    def row_capacity(self) -> int:
        return self.finalize()[0]

    @property
    def entry_capacity(self) -> int:
        return self.finalize()[1]

    def block_tables(self) -> np.ndarray:
        """Padded ``[row_capacity, entry_capacity]`` int32 page table (dead
        entries page 0)."""
        rows, entries = self.finalize()
        bt = np.zeros((rows, entries), dtype=np.int32)
        n, r = len(self._pages), 0
        while r < n:  # a prefill chunk's rows share one page tuple: one copy a run
            pages, e = self._pages[r], r + 1
            while e < n and self._pages[e] is pages:
                e += 1
            if pages:
                bt[r:e, : len(pages)] = pages
            r = e
        return bt

    def valid_lens(self) -> np.ndarray:
        """Padded ``[row_capacity]`` int32 covered-token counts (0 for
        padding rows)."""
        rows, _ = self.finalize()
        sl = np.zeros((rows,), dtype=np.int32)
        sl[: len(self._valid)] = self._valid
        return sl

    @property
    def num_pairs(self) -> int:
        """Cascade (main, prefix) pairs of this tick: the leading rows of
        :meth:`merge_pairs`, the rest being padding."""
        return sum(1 for s in self._segments if s.prefix_row >= 0)

    def merge_pairs(self) -> np.ndarray:
        """``[pair_capacity, 2]`` (main_row, prefix_row) cascade merge pairs,
        padded to a power of two with dead-row self pairs; ``[0, 2]`` when no
        member has a prefix row."""
        rows, _ = self.finalize()
        pairs = [(s.row_lo, s.prefix_row) for s in self._segments if s.prefix_row >= 0]
        if not pairs:
            return np.zeros((0, 2), dtype=np.int32)
        cap = _pow2_bucket(len(pairs), 1)
        out = np.full((cap, 2), rows - 1, dtype=np.int32)  # finalize() keeps row -1 dead
        out[: len(pairs)] = pairs
        return out

    def enumeration(self, num_splits: int = 1) -> BlockEnumeration:
        """The one :class:`BlockEnumeration` the kernel walks: the padded
        table's (row, split) x page-entry walk."""
        return BlockEnumeration.from_block_table(self.block_tables(), num_splits)


def build_block_meta_from_occupancy(occ, q_ranges, k_ranges, attn_type_map, total_q: int,
                                    total_k: int) -> FlexAttnBlockMeta:
    """Kernel plan from a block-occupancy map: one entry per occupied
    (q-block, k-block) pair x intersecting slice, windows from the slice
    geometry. With an exact map, the tables equal ``build_block_meta``'s on
    the same slices."""
    enum = BlockEnumeration.from_occupancy(occ)
    q_arr = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    k_arr = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    t_arr = np.asarray(attn_type_map, dtype=np.int64).reshape(-1)
    slices = np.concatenate([q_arr, k_arr, t_arr[:, None]], axis=1)
    if isinstance(occ, dict):
        bq, bk = int(occ["block_q"]), int(occ["block_k"])
    else:
        bq, bk = int(occ.block_q), int(occ.block_k)
    entries: list[tuple] = []
    area = 0
    minor = np.asarray(enum.minor).tolist()
    row_start = np.asarray(enum.row_start).tolist()
    row_count = np.asarray(enum.row_count).tolist()
    for sid in range(slices.shape[0]):
        qs, qe, ks, ke, mt = (int(x) for x in slices[sid])
        if qs >= qe or ks >= ke:
            continue
        area += _sub_area(qs, qe, ks, ke, qs, qe, ks, ke, mt)
        # only the q blocks the slice intersects: O(slice rows + touched entries)
        for i in range(qs // bq, min(-(-qe // bq), enum.num_rows)):
            gq_lo, gq_hi = max(qs, i * bq), min(qe, (i + 1) * bq)
            if gq_lo >= gq_hi:
                continue
            k_lo, k_hi = _slice_k_span(gq_lo, gq_hi, ks, ke, qs, qe, mt)
            if k_hi <= k_lo:
                continue
            rs, rc = row_start[i], row_count[i]
            for j in minor[rs:rs + rc]:
                gk_lo, gk_hi = max(k_lo, j * bk), min(k_hi, (j + 1) * bk)
                if gk_lo >= gk_hi:
                    continue
                entries.append((i, j, sid, gq_lo, gq_hi, gk_lo, gk_hi, 0, 0))
    ent = np.asarray(entries, dtype=np.int64) if entries else np.empty((0, 9), dtype=np.int64)
    return assemble_block_meta(ent, slices, total_q, total_k, bq, bk, int(area))


def _causal_window_area(q0, q1, k0, k1, off: int) -> int:
    """Pairs with ``k <= q + off`` in windows rows [q0, q1) x cols [k0, k1)
    (int64 arrays of one length, windows at most a few hundred rows):
    the global CAUSAL slice's ``_sub_area`` over each window, summed."""
    if q0.size == 0:
        return 0
    rows = q0[:, None] + np.arange(int((q1 - q0).max()), dtype=np.int64)[None]
    cnt = np.minimum(rows + off + 1, k1[:, None]) - k0[:, None]
    return int(np.where(rows < q1[:, None], np.maximum(cnt, 0), 0).sum())


def build_block_meta_from_block_mask(
    block_mask: np.ndarray,  # [nq, nk] bool: which caller tiles attend
    total_q: int,
    total_k: int,
    *,
    block_q: int = 128,
    block_k: int = 128,
    causal: bool = False,
    tile_q: int | None = None,
    tile_k: int | None = None,
) -> FlexAttnBlockMeta:
    """The plan of a block mask at the caller's blocking (``block_q`` x
    ``block_k``), built at the kernel tile (``tile_q`` x ``tile_k``, the
    blocking itself by default: then byte-identical to the JAX package's).

    Each True caller tile gives one entry per kernel tile it overlaps, its
    window the intersection. With ``causal``, windows wholly above the
    token diagonal are dropped and the ones it crosses reference the global
    CAUSAL slice (bottom-right: keep (q, k) iff k <= q + total_k - total_q,
    block-causal semantics for a square mask); the rest reference FULL. The
    area is the exact count of the attended pairs."""
    bm = np.asarray(block_mask, dtype=bool)
    nq, nk = -(-total_q // block_q), -(-total_k // block_k)
    if bm.ndim != 2 or bm.shape != (nq, nk):
        raise ValueError(
            f"block_sparse: block_mask shape {bm.shape} does not match the ({nq}, {nk}) = "
            f"(ceil({total_q}/{block_q}), ceil({total_k}/{block_k})) tile grid of a "
            f"({total_q}, {total_k})-token problem at blocking ({block_q}, {block_k}) — check "
            "the mask's blocking and that it is laid out [num_q_blocks, num_k_blocks]")
    tile_q = block_q if tile_q is None else int(tile_q)
    tile_k = block_k if tile_k is None else int(tile_k)
    off = total_k - total_q
    # at most two slices, both spanning the whole problem
    slices = np.asarray([(0, total_q, 0, total_k, 0),  # sid 0: FULL
                         (0, total_q, 0, total_k, 1)],  # sid 1: CAUSAL on the diagonal
                        dtype=np.int64)
    iq, jk = (a.astype(np.int64) for a in np.nonzero(bm))
    q0, k0 = iq * block_q, jk * block_k
    q1, k1 = np.minimum(q0 + block_q, total_q), np.minimum(k0 + block_k, total_k)
    # every kernel tile each caller tile overlaps, row-major within the tile
    a0, b0 = q0 // tile_q, k0 // tile_k
    na, nb = (q1 - 1) // tile_q - a0 + 1, (k1 - 1) // tile_k - b0 + 1
    rep = na * nb
    src = np.repeat(np.arange(iq.shape[0]), rep)
    within = np.arange(int(rep.sum()), dtype=np.int64) - np.repeat(np.cumsum(rep) - rep, rep)
    ti, tj = a0[src] + within // nb[src], b0[src] + within % nb[src]
    wq0, wq1 = np.maximum(q0[src], ti * tile_q), np.minimum(q1[src], (ti + 1) * tile_q)
    wk0, wk1 = np.maximum(k0[src], tj * tile_k), np.minimum(k1[src], (tj + 1) * tile_k)
    if causal:
        keep = wk0 <= wq1 - 1 + off  # drop windows wholly above the diagonal
        ti, tj, wq0, wq1, wk0, wk1 = (a[keep] for a in (ti, tj, wq0, wq1, wk0, wk1))
        sid = ((wk1 - 1) > (wq0 + off)).astype(np.int64)  # the diagonal crosses the window
    else:
        sid = np.zeros(ti.shape[0], dtype=np.int64)
    zero = np.zeros_like(ti)
    entries = np.stack([ti, tj, sid, wq0, wq1, wk0, wk1, zero, zero], axis=1).astype(np.int64)
    # the exact kept area: interior windows rows x cols, crossing ones per row
    full = sid == 0
    area = int(((wq1 - wq0) * (wk1 - wk0))[full].sum())
    if causal:
        cross = ~full
        area += _causal_window_area(wq0[cross], wq1[cross], wk0[cross], wk1[cross], off)
    return assemble_block_meta(entries, slices, total_q, total_k, tile_q, tile_k, area)


@functools.lru_cache(maxsize=128)
def _cached_bm_meta(mask_bytes: bytes, nq: int, nk: int, total_q: int, total_k: int, bq: int,
                    bk: int, causal: bool, tile_q: int, tile_k: int) -> FlexAttnBlockMeta:
    return build_block_meta_from_block_mask(
        np.frombuffer(mask_bytes, dtype=bool).reshape(nq, nk), total_q, total_k, block_q=bq,
        block_k=bk, causal=causal, tile_q=tile_q, tile_k=tile_k)


def block_mask_meta(block_mask, total_q: int, total_k: int, head_dim: int, *,
                    block_q: int = 128, block_k: int = 128,
                    causal: bool = False) -> FlexAttnBlockMeta:
    """The kernel-tile plan :func:`block_sparse_attn_func` runs for a block
    mask (``flex_attn.resolve_tile`` of ``head_dim``: the Hopper tile, or
    ``MAGI_ATTENTION_BLOCK_Q/_K``), cached per unique mask."""
    from .flex_attn import resolve_tile

    bm = np.ascontiguousarray(np.asarray(block_mask, dtype=bool))
    if bm.ndim != 2:
        raise ValueError(f"block_sparse: block_mask must be 2-D [num_q_blocks, num_k_blocks], "
                         f"got shape {bm.shape}")
    tile_q, tile_k = resolve_tile(head_dim, None, None)
    return _cached_bm_meta(bm.tobytes(), bm.shape[0], bm.shape[1], int(total_q), int(total_k),
                           int(block_q), int(block_k), bool(causal), tile_q, tile_k)


def block_sparse_attn_func(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,
    block_mask: np.ndarray,  # [nq, nk] host bool: which caller tiles attend
    *,
    causal: bool = False,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    block_q: int = 128,
    block_k: int = 128,
    head_block: int = 1,
):
    """Single-device block-sparse attention, differentiable in q, k, v and
    sink. ``block_mask`` is host-side, at the caller's blocking
    (``block_q`` x ``block_k``); the plan is built at the kernel tile
    (:func:`block_mask_meta`) and cached per unique mask, and runs on the
    row-major grid at ``head_block`` 1 by default, as the JAX package's:
    ``flex_fwd`` then ``flex_dq`` + ``flex_dkv`` on CUDA tensors, the plain
    versions on CPU ones. Returns (out [tq, hq, d], lse [tq, hq])."""
    from .flex_attn import flex_attn_with_meta

    meta = block_mask_meta(block_mask, int(q.shape[0]), int(k.shape[0]), int(q.shape[2]),
                           block_q=block_q, block_k=block_k, causal=causal)
    return flex_attn_with_meta(q, k, v, meta, scale=scale, softcap=softcap, sink=sink,
                               out_dtype=out_dtype, head_block=head_block)
