"""Paged KV cache: a fixed page pool + per-sequence block tables.

Layout, as in the JAX package's ``serving/kv_cache.py``:

- page pool ``k_pages`` / ``v_pages``: ``[num_pages, page_size, kv_heads,
  head_dim]`` — a page is the unit of allocation and of the decode kernel's
  walk;
- block tables ``[max_seqs, max_pages_per_seq]`` int32: slot -> ordered page
  ids (unreserved entries are 0, which may be a live page of another
  sequence, so nothing reads past ``seq_lens``);
- ``seq_lens`` ``[max_seqs]`` int32: tokens stored per slot.

Where the JAX functions return a new cache pytree, these update the cache's
tensors **in place** and return nothing: PyTorch tensors are mutable, and
the pool is the largest allocation of a server.

Page bookkeeping (free list, slot ownership, refcounts) is host Python in
:class:`PageAllocator`: admission decisions happen between device steps.

:func:`shard_kv_cache` splits a pool on its KV-head axis over a list of
devices (:class:`ShardedPagedKVCache`, the JAX package's
``kv_head_sharding`` layout): each device holds every page for its head
slice and its own copy of the block tables and lengths, while the host
allocator stays one. The cache ops a decode engine calls (``append_kv``,
``assign_block_table``, ``reset_slot``, ``copy_page``,
``swap_block_table_page``) take it and apply themselves shard by shard.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


class PageAllocatorError(RuntimeError):
    """Typed base of every :class:`PageAllocator` failure: a caller that
    treats resource pressure as backpressure catches THIS, and bookkeeping
    bugs get their own subclasses so they are never mistaken for pressure."""


class InvalidFreeError(PageAllocatorError, KeyError):
    """``free()`` (or a ref release) on a slot/page the allocator does not
    own — a double free or a never-allocated id. Raised before any
    free-list mutation."""


class PageShareError(PageAllocatorError):
    """Refcount misuse on the sharing surface (``retain``/``release_pages``/
    ``cow_page``): the page is not resident, or a copy-on-write split was
    requested on an unshared page."""


@dataclasses.dataclass
class PagedKVCache:
    """Device state of the paged cache: four tensors on one device."""

    k_pages: torch.Tensor  # [num_pages, page_size, kv_heads, head_dim]
    v_pages: torch.Tensor  # same shape
    block_tables: torch.Tensor  # [max_seqs, max_pages_per_seq] int32 page ids
    seq_lens: torch.Tensor  # [max_seqs] int32 tokens stored per slot

    @property
    def device(self) -> torch.device:
        return self.k_pages.device

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[0]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]

    @property
    def num_kv_heads(self) -> int:
        return self.k_pages.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k_pages.shape[3]

    @property
    def max_seqs(self) -> int:
        return self.block_tables.shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return self.block_tables.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size


def make_paged_kv_cache(
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    max_seqs: int,
    max_pages_per_seq: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> PagedKVCache:
    """Zero-initialized cache on ``device``. ``max_pages_per_seq`` bounds a
    sequence's KV history (block-table width); defaults to the whole pool."""
    if page_size < 1:
        raise ValueError(f"page_size {page_size} must be positive")
    if max_pages_per_seq is None:
        max_pages_per_seq = num_pages
    shape = (num_pages, page_size, num_kv_heads, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.zeros(
            (max_seqs, max_pages_per_seq), dtype=torch.int32, device=device
        ),
        seq_lens=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class ShardedPagedKVCache:
    """A pool split on the KV-head axis: ``shards[i]`` is a
    :class:`PagedKVCache` on its own device holding kv heads
    ``[i * hk / tp, (i + 1) * hk / tp)`` of every page, with its own copy of
    the block tables and lengths (the same values on every shard). A device
    may appear twice: the shards are separate tensors all the same."""

    shards: tuple[PagedKVCache, ...]

    @property
    def tp(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(c.device for c in self.shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def num_kv_heads(self) -> int:
        return sum(c.num_kv_heads for c in self.shards)

    @property
    def block_tables(self) -> torch.Tensor:
        return self.shards[0].block_tables

    @property
    def seq_lens(self) -> torch.Tensor:
        return self.shards[0].seq_lens

    # the geometry every shard shares
    num_pages = property(lambda self: self.shards[0].num_pages)
    page_size = property(lambda self: self.shards[0].page_size)
    head_dim = property(lambda self: self.shards[0].head_dim)
    max_seqs = property(lambda self: self.shards[0].max_seqs)
    max_pages_per_seq = property(lambda self: self.shards[0].max_pages_per_seq)
    max_seq_len = property(lambda self: self.shards[0].max_seq_len)


def shard_kv_cache(cache: PagedKVCache, devices) -> PagedKVCache | ShardedPagedKVCache:
    """A copy of ``cache`` split on its KV-head axis over ``devices``, one
    head slice per device, the block tables and lengths copied whole to
    each (the JAX package's ``shard_kv_cache`` over a ``tp`` mesh axis).
    One device gives a plain :class:`PagedKVCache` copy there, as a
    one-device mesh gives plain placement in JAX. Raises ``ValueError``
    when the device count does not divide the kv heads."""
    devices = [torch.device(d) for d in devices]
    tp = len(devices)
    hk = cache.num_kv_heads
    if tp < 1 or hk % tp:
        raise ValueError(
            f"shard_kv_cache: kv_heads {hk} not divisible by tp={tp} devices — the "
            "KV-head-sharded layout needs equal head slices per device")

    def copy(x, dev):  # a fresh contiguous tensor, even on the same device
        return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)

    def shard(i, dev):
        h = slice(i * (hk // tp), (i + 1) * (hk // tp))
        return PagedKVCache(copy(cache.k_pages[:, :, h], dev), copy(cache.v_pages[:, :, h], dev),
                            copy(cache.block_tables, dev), copy(cache.seq_lens, dev))

    from ..utils.instrument import named_scope

    with named_scope("magi_kvcache_shard"):
        if tp == 1:
            return shard(0, devices[0])
        return ShardedPagedKVCache(tuple(shard(i, d) for i, d in enumerate(devices)))


def shards_of(cache) -> tuple[PagedKVCache, ...]:
    """The caches an op applies to: each shard of a sharded pool (shard
    ``i`` holding kv heads ``[i * n, (i + 1) * n)`` of the whole, ``n`` its
    own count), else the cache itself."""
    return cache.shards if isinstance(cache, ShardedPagedKVCache) else (cache,)


def append_kv(
    cache: PagedKVCache | ShardedPagedKVCache,
    slots: torch.Tensor,  # [b] int sequence slots (distinct)
    k_new: torch.Tensor,  # [b, kv_heads, head_dim] this step's K per sequence
    v_new: torch.Tensor,
) -> None:
    """Append ONE token of KV per sequence, in place (the decode-step write).

    Positions come from ``seq_lens``; the caller must have installed enough
    pages for them (unreserved block-table entries read 0, another
    sequence's page). A full slot (``seq_lens == max_seq_len``) is left
    unchanged, and the update needs no host synchronisation: the full
    slot's row rewrites its own last page's current value. On a sharded
    pool each shard appends its head slice of ``k_new`` / ``v_new``."""
    if isinstance(cache, ShardedPagedKVCache):
        for i, c in enumerate(cache.shards):
            h = slice(i * c.num_kv_heads, (i + 1) * c.num_kv_heads)
            append_kv(c, slots, k_new[:, h].to(c.device), v_new[:, h].to(c.device))
        return
    ps = cache.page_size
    slots = slots.to(device=cache.device, dtype=torch.long)
    pos = cache.seq_lens[slots].long()
    valid = pos < cache.max_seq_len
    page_slot = (pos // ps).clamp_max(cache.max_pages_per_seq - 1)
    page = cache.block_tables[slots, page_slot].long()
    off = pos % ps
    keep = ~valid[:, None, None]
    for pool, new in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        pool[page, off] = torch.where(keep, pool[page, off], new.to(pool.dtype))
    cache.seq_lens.index_add_(0, slots, valid.to(torch.int32))


def write_prefill_kv(
    cache: PagedKVCache,
    slot: int,
    k: torch.Tensor,  # [t, kv_heads, head_dim]
    v: torch.Tensor,
    length: int | None = None,  # valid token count (None = all t rows)
) -> None:
    """Write a prefill's KV into the slot's pages at its current
    ``seq_lens`` position, in place; rows at or past ``length`` and past the
    slot's capacity are dropped."""
    t = k.shape[0]
    ps = cache.page_size
    length = t if length is None else int(length)
    start = int(cache.seq_lens[slot])
    n = max(min(length, t, cache.max_seq_len - start), 0)
    if n == 0:
        return
    pos = torch.arange(start, start + n, device=cache.device)
    page = cache.block_tables[slot, pos // ps].long()
    off = pos % ps
    cache.k_pages[page, off] = k[:n].to(cache.k_pages.dtype)
    cache.v_pages[page, off] = v[:n].to(cache.v_pages.dtype)
    cache.seq_lens[slot] += n


def gather_kv(
    cache: PagedKVCache, slot: int, max_len: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous ``[max_len, kv_heads, head_dim]`` K/V of one sequence (rows
    past ``seq_lens[slot]`` are zero)."""
    if max_len is None:
        max_len = cache.max_seq_len
    ps = cache.page_size
    pos = torch.arange(max_len, device=cache.device)
    page_slot = (pos // ps).clamp_max(cache.max_pages_per_seq - 1)
    page = cache.block_tables[slot, page_slot].long()
    off = pos % ps
    valid = (pos < cache.seq_lens[slot])[:, None, None]
    k = torch.where(valid, cache.k_pages[page, off], 0)
    v = torch.where(valid, cache.v_pages[page, off], 0)
    return k, v


def assign_block_table(
    cache: PagedKVCache | ShardedPagedKVCache,
    slot: int,
    pages: Sequence[int],
    *,
    keep_len: bool | int = False,
) -> None:
    """Install a slot's page list, in place.

    ``keep_len``: ``False`` resets the slot's length to 0 (a fresh
    admission); ``True`` keeps it (a growth re-assignment); an int N sets it
    to N, which must fit in the installed pages."""
    if len(pages) > cache.max_pages_per_seq:
        raise ValueError(
            f"block table for slot {slot} would overflow: {len(pages)} "
            f"pages > max_pages_per_seq {cache.max_pages_per_seq}"
        )
    row = torch.zeros((cache.max_pages_per_seq,), dtype=torch.int32)
    row[: len(pages)] = torch.as_tensor(list(pages), dtype=torch.int32)
    if keep_len is not True:
        n = 0 if keep_len is False else int(keep_len)
        if not 0 <= n <= len(pages) * cache.page_size:
            raise ValueError(
                f"keep_len={n} out of range for slot {slot}: the "
                f"{len(pages)}-page list holds at most "
                f"{len(pages) * cache.page_size} tokens"
            )
    for c in shards_of(cache):
        if keep_len is not True:
            c.seq_lens[slot] = n
        c.block_tables[slot] = row.to(c.device)


def copy_page(cache: PagedKVCache | ShardedPagedKVCache, src_page: int, dst_page: int) -> None:
    """The data half of a copy-on-write split, in place: ``dst_page``'s K/V
    become a bit copy of ``src_page``'s. Pair it with
    :func:`swap_block_table_page` to point the writing slot at its copy."""
    for c in shards_of(cache):
        c.k_pages[dst_page] = c.k_pages[src_page]
        c.v_pages[dst_page] = c.v_pages[src_page]


def swap_block_table_page(cache: PagedKVCache | ShardedPagedKVCache, slot: int, page_idx: int,
                          new_page: int) -> None:
    """The table half of a copy-on-write split, in place: entry ``page_idx``
    of ``slot``'s block table now names ``new_page`` (lengths untouched)."""
    for c in shards_of(cache):
        c.block_tables[slot, page_idx] = int(new_page)


def reset_slot(cache: PagedKVCache | ShardedPagedKVCache, slot: int) -> None:
    """Logical free of a slot's stored tokens, in place (page recycling is
    the allocator's job; stale page contents are never read at length 0)."""
    for c in shards_of(cache):
        c.seq_lens[slot] = 0


class PageAllocator:
    """Host-side page bookkeeping: free list, slot ownership, occupancy.

    Per-page refcounts: a resident page may be referenced by several
    sequences (a shared prefix) yet occupies the pool once; ``fork`` admits
    a sequence onto resident pages, ``cow_page`` splits one page when a
    writer needs it private, ``free``/``release_pages`` drop references and
    recycle a page when its last one goes. Every failure raises before any
    mutation.
    """

    def __init__(
        self, num_pages: int, page_size: int, max_seqs: int, max_pages_per_seq: int
    ):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_seqs = int(max_seqs)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self._free_pages: list[int] = list(range(num_pages - 1, -1, -1))
        self._free_slots: list[int] = list(range(max_seqs - 1, -1, -1))
        self._slot_pages: dict[int, list[int]] = {}
        self._page_refs: dict[int, int] = {}  # resident page -> references
        self._peak_pages_in_use = 0

    def pages_needed(self, num_tokens: int) -> int:
        return -(-max(int(num_tokens), 0) // self.page_size)

    def can_admit(self, num_tokens: int) -> bool:
        from ..resilience import chaos

        if chaos.pool_exhausted():
            return False
        need = max(self.pages_needed(num_tokens), 1)
        return (
            bool(self._free_slots)
            and need <= len(self._free_pages)
            and need <= self.max_pages_per_seq
        )

    def allocate(self, num_tokens: int) -> tuple[int, list[int]]:
        """Admit a sequence needing ``num_tokens`` of KV (whole pages, at
        least one). Returns (slot, page list). Every failure, the chaos
        injectors' (``alloc_fail``, ``pool_exhaust``) included, raises before
        any free-list mutation."""
        from ..resilience import chaos

        chaos.maybe_fail("alloc_fail")
        need = max(self.pages_needed(num_tokens), 1)
        if chaos.pool_exhausted() or need > len(self._free_pages):
            raise PageAllocatorError(
                f"PageAllocator: {need} pages requested, "
                f"{0 if chaos.pool_exhausted() else len(self._free_pages)} free"
            )
        if not self._free_slots:
            raise PageAllocatorError("PageAllocator: no free sequence slot")
        if need > self.max_pages_per_seq:
            raise PageAllocatorError(
                f"PageAllocator: {num_tokens} tokens need {need} pages > "
                f"max_pages_per_seq {self.max_pages_per_seq}"
            )
        slot = self._free_slots.pop()
        pages = [self._pop_free_page() for _ in range(need)]
        self._slot_pages[slot] = pages
        return slot, list(pages)

    def _pop_free_page(self) -> int:
        page = self._free_pages.pop()
        self._page_refs[page] = 1
        self._peak_pages_in_use = max(self._peak_pages_in_use, self.pages_in_use)
        return page

    def _decref(self, page: int) -> bool:
        """Drop one reference; True when the page went back to the free list."""
        refs = self._page_refs.get(page)
        if refs is None:
            raise InvalidFreeError(
                f"PageAllocator: page {page} is not resident (double release "
                "or never-allocated id)"
            )
        if refs > 1:
            self._page_refs[page] = refs - 1
            return False
        del self._page_refs[page]
        self._free_pages.append(page)
        return True

    def page_ref(self, page: int) -> int:
        return self._page_refs.get(page, 0)

    def retain(self, pages: Sequence[int]) -> None:
        """One more reference on each resident page (all or nothing)."""
        for p in pages:
            if p not in self._page_refs:
                raise PageShareError(f"PageAllocator: cannot retain non-resident page {p}")
        for p in pages:
            self._page_refs[p] += 1

    def release_pages(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; returns how many were recycled."""
        return sum(1 for p in pages if self._decref(p))

    def can_fork(self, shared_pages: Sequence[int], num_tokens: int) -> bool:
        from ..resilience import chaos

        if chaos.pool_exhausted():
            return False
        need = max(self.pages_needed(num_tokens), len(shared_pages), 1)
        return (
            bool(self._free_slots)
            and need <= self.max_pages_per_seq
            and need - len(shared_pages) <= len(self._free_pages)
            and all(p in self._page_refs for p in shared_pages)
        )

    def fork(self, shared_pages: Sequence[int], num_tokens: int) -> tuple[int, list[int]]:
        """Admit a sequence whose first pages are an already-resident shared
        prefix (one more reference each, no copy); only the remaining pages
        are newly popped. Returns (slot, full page list). Atomic like
        :meth:`allocate`."""
        from ..resilience import chaos

        chaos.maybe_fail("alloc_fail")
        shared = list(shared_pages)
        need = max(self.pages_needed(num_tokens), len(shared), 1)
        if need > self.max_pages_per_seq:
            raise PageAllocatorError(
                f"PageAllocator: {num_tokens} tokens need {need} pages > "
                f"max_pages_per_seq {self.max_pages_per_seq}"
            )
        grow = need - len(shared)
        if chaos.pool_exhausted() or grow > len(self._free_pages):
            raise PageAllocatorError(
                f"PageAllocator: fork needs {grow} fresh pages, "
                f"{0 if chaos.pool_exhausted() else len(self._free_pages)} free"
            )
        if not self._free_slots:
            raise PageAllocatorError("PageAllocator: no free sequence slot")
        for p in shared:
            if p not in self._page_refs:
                raise PageShareError(f"PageAllocator: shared prefix page {p} is not resident")
        slot = self._free_slots.pop()
        for p in shared:
            self._page_refs[p] += 1
        pages = shared + [self._pop_free_page() for _ in range(grow)]
        self._slot_pages[slot] = pages
        return slot, list(pages)

    def cow_page(self, slot: int, page_idx: int) -> tuple[int, int]:
        """Copy-on-write split of the shared page at ``page_idx`` of the
        slot's list. Returns ``(old_page, new_page)``; the caller copies the
        payload and swaps the block-table entry."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise InvalidFreeError(f"PageAllocator: slot {slot} not allocated")
        old = pages[page_idx]
        if self._page_refs.get(old, 0) < 2:
            raise PageShareError(
                f"PageAllocator: page {old} is not shared (ref "
                f"{self._page_refs.get(old, 0)}) — nothing to split"
            )
        if not self._free_pages:
            raise PageAllocatorError("PageAllocator: page pool exhausted (CoW split)")
        new = self._pop_free_page()
        self._page_refs[old] -= 1
        pages[page_idx] = new
        return old, new

    def extend(self, slot: int, total_tokens: int) -> list[int]:
        """Grow a slot's reservation to cover ``total_tokens``; returns the
        FULL page list. A refused extension (``pool_exhaust`` chaos included)
        changes nothing."""
        from ..resilience import chaos

        pages = self._slot_pages.get(slot)
        if pages is None:
            raise InvalidFreeError(f"PageAllocator: slot {slot} not allocated")
        need = max(self.pages_needed(total_tokens), 1)
        if need > self.max_pages_per_seq:
            raise PageAllocatorError(
                f"PageAllocator: {total_tokens} tokens exceed "
                f"max_pages_per_seq {self.max_pages_per_seq}"
            )
        grow = need - len(pages)
        if grow > 0 and (chaos.pool_exhausted() or grow > len(self._free_pages)):
            raise PageAllocatorError("PageAllocator: page pool exhausted")
        for _ in range(max(grow, 0)):
            pages.append(self._pop_free_page())
        return list(pages)

    def free(self, slot: int) -> None:
        """Retire a slot: one reference dropped per page; a double free
        raises :class:`InvalidFreeError` before anything changes."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise InvalidFreeError(
                f"PageAllocator: slot {slot} not allocated (double free?)"
            )
        del self._slot_pages[slot]
        for p in reversed(pages):
            self._decref(p)
        self._free_slots.append(slot)

    def reserved_pages(self, slot: int) -> int:
        return len(self._slot_pages.get(slot, ()))

    def slot_pages(self, slot: int) -> list[int]:
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise InvalidFreeError(f"PageAllocator: slot {slot} not allocated")
        return list(pages)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free_pages)

    @property
    def peak_pages_in_use(self) -> int:
        return self._peak_pages_in_use

    @property
    def shared_pages(self) -> int:
        return sum(1 for r in self._page_refs.values() if r > 1)

    @property
    def active_seqs(self) -> int:
        return len(self._slot_pages)

    def page_states(self) -> dict[str, tuple[int, ...]]:
        """The ownership class of every page, for the memory ledger and the
        fragmentation map:

        - ``free``: on the free list;
        - ``live``: owned by exactly one sequence slot (one reference);
        - ``shared``: slot-owned with more than one reference (a CoW-shared
          prefix page, and/or also pinned by the prefix trie);
        - ``trie``: resident but owned by no slot (the prefix cache's
          reference alone keeps it).

        The four classes partition ``range(num_pages)``: a page appears once
        however many references it holds (residency, not references, is what
        costs pool capacity)."""
        slot_owned: set[int] = set()
        for pages in self._slot_pages.values():
            slot_owned.update(pages)
        live = tuple(sorted(p for p in slot_owned if self._page_refs.get(p, 0) == 1))
        shared = tuple(sorted(p for p in slot_owned if self._page_refs.get(p, 0) > 1))
        trie = tuple(sorted(set(self._page_refs) - slot_owned))
        return {"free": tuple(sorted(self._free_pages)), "live": live, "shared": shared,
                "trie": trie}

    def occupancy(self) -> dict:
        return {
            "pages_total": self.num_pages,
            "pages_in_use": self.pages_in_use,
            "free_pages": self.num_pages - self.pages_in_use,
            "peak_pages_in_use": self._peak_pages_in_use,
            "occupancy_ratio": self.pages_in_use / max(self.num_pages, 1),
            "active_seqs": self.active_seqs,
            "shared_pages": self.shared_pages,
            "page_size": self.page_size,
        }
