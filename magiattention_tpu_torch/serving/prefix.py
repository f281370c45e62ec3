"""Shared-prefix serving: copy-on-write page sharing and cascade decode.

The counterpart of the JAX package's ``serving/prefix.py`` (after
FlashInfer's cascade attention, arxiv 2501.01005): requests that share a
long prompt prefix (one system prompt in front of every chat) hold ONE
resident copy of its KV pages, and decode reads those pages once per group
of requests instead of once per request.

- :class:`PrefixCache` — a host trie over page-granular token hashes. A
  registered prompt contributes a chain of full-page nodes (key = sha256 of
  the parent key and the page's token ids, so equal chains collide exactly
  and by position) plus at most one partial-page tail per node. A new
  prompt's longest resident prefix is installed in its block table by
  ``PageAllocator.fork`` (one more reference per page, no copy). The trie
  holds one reference per registered page, so the resident copy outlives
  the sequences that forked it; under pool pressure :meth:`PrefixCache.evict`
  releases least-recently-used pages no sequence holds, leaf first.
- :func:`cascade_decode_attn` — two-level decode: per group the shared
  full-page prefix partial runs ONCE over the group's rows of the shared
  page table, each member's suffix partial over its own pages, and the two
  merge with ``ops/correction.correct_attn_out_lse``. Both levels run the
  ``paged_decode`` kernel on CUDA tensors: the prefix in its shared mode
  (``decode_attn._decode_shared_prefix``: each shared page read once for
  up to 32 q rows of the group), the suffixes through
  ``decode_partials_for_tables``.

Sharing is read sharing: the one shared page that can be written is a
partial tail page (a fork's first write, or the registrant's own next
decode append, lands mid-page). The engine splits it first
(``PageAllocator.cow_page`` + ``kv_cache.copy_page``): one page copied,
once, per diverging sequence. Everything here is host bookkeeping except
:func:`cascade_decode_attn`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence

import numpy as np
import torch

from ..ops.correction import correct_attn_out_lse
from ..utils.instrument import named_scope
from .decode_attn import (
    _decode_shared_prefix, decode_partials_for_tables, resolve_num_splits,
)
from .kv_cache import PagedKVCache, PageAllocator

_ROOT = b"root"


def _chain_hash(parent: bytes, page_tokens: Sequence[int]) -> bytes:
    """Position-dependent content key of one full page of token ids: equal
    keys <=> equal (prefix chain, page tokens)."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(page_tokens, np.int64).tobytes())
    return h.digest()


@dataclasses.dataclass
class _Tail:
    """A registered partial last page: ``tokens`` is its (sub-page) token
    content, ``page`` holds their KV."""

    page: int
    tokens: tuple[int, ...]


@dataclasses.dataclass
class _Node:
    """One full-page trie node (the root has ``page = -1``)."""

    page: int
    parent: bytes | None
    children: set[bytes] = dataclasses.field(default_factory=set)
    tail: _Tail | None = None
    last_used: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of :meth:`PrefixCache.match`.

    - ``pages``: resident page ids covering the matched prefix, in sequence
      order (possibly ending with a shared partial tail page).
    - ``length``: matched tokens (full pages times the page size, plus the
      tail's tokens when the tail matched).
    - ``full_pages``: how many of ``pages`` are FULL prefix pages — the
      cascade group's boundary (a tail page belongs to the suffix level: it
      is split on its first write).
    """

    pages: tuple[int, ...]
    length: int
    full_pages: int

    @property
    def hit(self) -> bool:
        return self.length > 0


class PrefixCache:
    """Host-side shared-prefix trie over one :class:`PageAllocator`. It
    holds ONE allocator reference per registered page and forks add their
    own, so ``pages_in_use`` counts a shared page once."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._nodes: dict[bytes, _Node] = {_ROOT: _Node(page=-1, parent=None)}
        self._clock = 0  # logical LRU clock, one tick per match or register

    @property
    def resident_pages(self) -> int:
        """Pages the trie pins (full nodes and tails)."""
        n = sum(1 for key in self._nodes if key != _ROOT)
        return n + sum(1 for node in self._nodes.values() if node.tail is not None)

    @property
    def num_nodes(self) -> int:
        return len(self._nodes) - 1

    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest resident prefix of ``tokens``: the full-page chain walk,
        then at most one partial tail whose tokens begin the remainder.
        Touches the walked nodes' LRU clock."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        self._clock += 1
        key, node = _ROOT, self._nodes[_ROOT]
        pages: list[int] = []
        length = 0
        for i in range(len(toks) // ps):
            nxt = _chain_hash(key, toks[i * ps : (i + 1) * ps])
            child = self._nodes.get(nxt)
            if child is None:
                break
            key, node = nxt, child
            node.last_used = self._clock
            pages.append(node.page)
            length += ps
        full = len(pages)
        tail = node.tail
        rem = toks[length:]
        if (
            tail is not None
            and 0 < len(tail.tokens) <= len(rem)
            and tuple(rem[: len(tail.tokens)]) == tail.tokens
        ):
            pages.append(tail.page)
            length += len(tail.tokens)
        return PrefixMatch(tuple(pages), length, full)

    def register(self, tokens: Sequence[int], slot_pages: Sequence[int],
                 allocator: PageAllocator) -> int:
        """Record a prefilled prompt's pages as shareable: a node for every
        full page not yet in the trie, and a tail for the partial last page
        (the first registrant keeps an occupied tail slot). Each newly
        recorded page gains one allocator reference. Returns how many pages
        were newly pinned."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        self._clock += 1
        key, node = _ROOT, self._nodes[_ROOT]
        newly = 0
        for i in range(len(toks) // ps):
            nxt = _chain_hash(key, toks[i * ps : (i + 1) * ps])
            child = self._nodes.get(nxt)
            if child is None:
                page = int(slot_pages[i])
                allocator.retain([page])
                child = _Node(page=page, parent=key)
                self._nodes[nxt] = child
                node.children.add(nxt)
                newly += 1
            child.last_used = self._clock
            key, node = nxt, child
        rem = toks[(len(toks) // ps) * ps :]
        if rem and node.tail is None:
            page = int(slot_pages[len(toks) // ps])
            allocator.retain([page])
            node.tail = _Tail(page=page, tokens=tuple(rem))
            newly += 1
        return newly

    def evict(self, allocator: PageAllocator, want_pages: int = 1) -> int:
        """Release least-recently-used trie pages that no sequence holds
        (``page_ref == 1``: the trie's own reference) until ``want_pages``
        went back to the free list or nothing is left to evict. Tails and
        childless nodes go first, so the trie stays prefix-closed. Returns
        the pages freed."""
        freed = 0
        while freed < want_pages:
            victim_key: bytes | None = None
            victim_tail: _Node | None = None
            victim_used = None
            for node in self._nodes.values():  # tails first: leaves by construction
                t = node.tail
                if t is not None and allocator.page_ref(t.page) == 1:
                    if victim_used is None or node.last_used < victim_used:
                        victim_used, victim_tail, victim_key = node.last_used, node, None
            for key, node in self._nodes.items():
                if (key != _ROOT and not node.children and node.tail is None
                        and allocator.page_ref(node.page) == 1):
                    if victim_used is None or node.last_used < victim_used:
                        victim_used, victim_tail, victim_key = node.last_used, None, key
            if victim_tail is not None:
                freed += allocator.release_pages([victim_tail.tail.page])
                victim_tail.tail = None
            elif victim_key is not None:
                node = self._nodes.pop(victim_key)
                self._nodes[node.parent].children.discard(victim_key)
                freed += allocator.release_pages([node.page])
            else:
                break
        return freed

    def drop_all(self, allocator: PageAllocator) -> int:
        """Release EVERY trie reference. Pages a sequence still holds stay
        resident; pages only the trie held go back to the pool. Returns the
        pages freed."""
        freed = 0
        for key, node in list(self._nodes.items()):
            if node.tail is not None:
                freed += allocator.release_pages([node.tail.page])
                node.tail = None
            if key != _ROOT:
                freed += allocator.release_pages([node.page])
        self._nodes = {_ROOT: _Node(page=-1, parent=None)}
        return freed


# -- cascade decode -----------------------------------------------------------


def _device_index(values: Sequence[int], dtype: torch.dtype,
                  dev: torch.device) -> torch.Tensor:
    """Host integers as a tensor on ``dev``. To a card through pinned memory
    and a non-blocking copy: a copy from pageable memory would wait for
    every kernel queued before it, stalling the host once per index."""
    t = torch.tensor(list(values), dtype=dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


@dataclasses.dataclass(frozen=True)
class CascadeGroup:
    """One shared-prefix decode group: ``shared_pages`` are the group's
    FULL prefix pages (every member's block-table row starts with them),
    ``prefix_len`` the tokens they hold, ``members`` positions in the
    decode batch (not slot ids)."""

    shared_pages: tuple[int, ...]
    prefix_len: int
    members: tuple[int, ...]


def cascade_decode_attn(
    q: torch.Tensor,  # [b, hq, head_dim] one query token per sequence
    cache: PagedKVCache,
    slots: Sequence[int],
    groups: Sequence[CascadeGroup],
    *,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level decode over shared prefixes. For each group the shared
    prefix's partial runs ONCE over the group on the shared page row, each
    member's suffix partial on its own remaining pages, and the two merge
    through ``correct_attn_out_lse``; batch rows in no group take the flat
    split-KV path. ``num_splits`` pins every phase's split count; ``None``
    resolves each phase on its own table width. Returns ``(out [b, hq, d]
    in out_dtype, lse [b, hq] f32)``."""
    b, hq, d = q.shape
    slots = [int(s) for s in slots]
    if len(slots) != b:
        raise ValueError(f"{len(slots)} slots for a batch of {b} queries")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out_dtype = out_dtype if out_dtype is not None else q.dtype
    dev = cache.device
    slots_dev = _device_index(slots, torch.long, dev)
    bt_all = cache.block_tables[slots_dev]  # [b, MPP]
    sl_all = cache.seq_lens[slots_dev]  # [b]
    mpp = cache.max_pages_per_seq

    grouped = [i for g in groups for i in g.members]
    if len(grouped) != len(set(grouped)):
        dupes = sorted({i for i in grouped if grouped.count(i) > 1})
        owners = {i: [gi for gi, g in enumerate(groups) if i in g.members] for i in dupes}
        raise ValueError(
            f"overlapping cascade groups: batch position(s) {dupes} appear in more "
            f"than one group (position -> group indices: {owners}); each batch row "
            "may belong to at most one CascadeGroup"
        )
    rest = [i for i in range(b) if i not in set(grouped)]
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hq), dtype=torch.float32, device=dev)
    kw = dict(scale=scale, softcap=softcap)

    with named_scope("magi_cascade_decode"):
        for g in groups:
            idx = list(g.members)
            n_shared = len(g.shared_pages)
            if n_shared == 0 or g.prefix_len != n_shared * cache.page_size:
                raise ValueError(
                    f"misaligned cascade group (members {idx}): prefix_len {g.prefix_len} "
                    f"must equal len(shared_pages) ({n_shared}) * page_size "
                    f"({cache.page_size}) = {n_shared * cache.page_size} and cover at "
                    "least one page — the level-1 partial reads whole shared pages only"
                )
            idx_dev = _device_index(idx, torch.long, dev)
            qg = q[idx_dev]
            # level 1: the shared prefix, once per group, fully covered; the
            # kernel reads each shared page once for the group's q rows
            shared = _device_index(g.shared_pages, torch.int32, dev)
            s_prefix = resolve_num_splits(num_splits, cache, len(idx), hq, mpp=n_shared,
                                          prefix_groups=max(len(groups), 1))
            with named_scope("magi_cascade_prefix"):
                o_g, l_g = _decode_shared_prefix(qg, cache, shared, g.prefix_len,
                                                 num_splits=s_prefix, **kw)
            # level 2: each member's own pages past the prefix (table-relative lengths)
            suffix_w = mpp - n_shared
            if suffix_w > 0:
                bt_suffix = bt_all[idx_dev][:, n_shared:]
                sl_suffix = (sl_all[idx_dev] - g.prefix_len).clamp_min(0)
                s_suffix = resolve_num_splits(num_splits, cache, len(idx), hq, mpp=suffix_w)
                with named_scope("magi_cascade_suffix"):
                    o_s, l_s = decode_partials_for_tables(qg, cache, bt_suffix, sl_suffix,
                                                          num_splits=s_suffix, **kw)
                o_g, l_g = correct_attn_out_lse(o_g, l_g, o_s, l_s)
            out[idx_dev], lse[idx_dev] = o_g, l_g

        if rest:
            idx_dev = _device_index(rest, torch.long, dev)
            s_flat = resolve_num_splits(num_splits, cache, len(rest), hq)
            out[idx_dev], lse[idx_dev] = decode_partials_for_tables(
                q[idx_dev], cache, bt_all[idx_dev], sl_all[idx_dev], num_splits=s_flat, **kw)
    return out.to(out_dtype), lse


def plan_cascade_groups(
    slot_prefixes: dict[int, tuple[tuple[int, ...], int]],
    batch_slots: Sequence[int],
    *,
    min_group: int = 2,
) -> list[CascadeGroup]:
    """Group a decode batch by shared full-page prefix. ``slot_prefixes``
    maps slot -> (shared full pages, their token count), the engine's fork
    and registration bookkeeping; batch members with the same page tuple
    form one group, and groups smaller than ``min_group`` are dropped
    (``min_group=1`` cascades singletons too, the parity-test mode)."""
    by_key: dict[tuple[tuple[int, ...], int], list[int]] = {}
    for pos, slot in enumerate(batch_slots):
        entry = slot_prefixes.get(int(slot))
        if entry is None or not entry[0]:
            continue
        by_key.setdefault((entry[0], entry[1]), []).append(pos)
    return [
        CascadeGroup(shared_pages=pages, prefix_len=plen, members=tuple(m))
        for (pages, plen), m in sorted(by_key.items())
        if len(m) >= min_group
    ]
