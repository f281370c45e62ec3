"""Serving front end: continuous batching over one paged cache.

Prefill runs through the flex-attention forward and writes its KV into
pages; decode steps run the split-KV kernel over the same pool — a
sequence's lifetime (admit -> prefill -> N decode steps -> free)
round-trips through ONE cache with no re-layout. The counterpart of the JAX
package's ``serving/engine.py`` for admissions with or without token ids,
shared prefixes (fork onto resident pages, copy-on-write split of a shared
tail page, automatic registration of a finished prompt), one-shot, chunked
and continued prefill, and flat or cascade split-KV decode.

- :class:`DecodeBatch` — per-sequence cache slots of one decode step; the
  lengths live in the cache's ``seq_lens``.
- :func:`magi_attn_decode` — the public decode attention entry.
- :func:`prefill_into_cache` / :func:`continue_prefill_into_cache` — causal
  prefill (one shot, or one chunk against the written history) + the paged
  KV write.
- :class:`ServingEngine` — host-side admission (with the prefix trie of
  ``prefix.py``), reservation growth, copy-on-write, prefill, decode steps
  and slot recycling.

Cache updates are in place (see ``kv_cache.py``), so these functions return
attention outputs only, where the JAX ones also return a new cache.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..common.enum import AttnMaskType
from ..ops.flex_attn import flex_flash_attn_func
from .decode_attn import decode_attn_paged, resolve_num_splits
from .kv_cache import (
    PageAllocator,
    PageAllocatorError,
    PagedKVCache,
    append_kv,
    assign_block_table,
    copy_page,
    gather_kv,
    make_paged_kv_cache,
    reset_slot,
    swap_block_table_page,
    write_prefill_kv,
)
from .prefix import PrefixCache, cascade_decode_attn, plan_cascade_groups


@dataclasses.dataclass(frozen=True)
class AdmissionResult:
    """Typed outcome of :meth:`ServingEngine.admit`: admission never raises
    on resource pressure.

    - ``admitted``: True with a usable ``slot``; False = backpressure.
    - ``reason``: ``"ok"`` | ``"pool_exhausted"`` | ``"no_free_slot"`` |
      ``"too_long"`` | ``"alloc_error"``.
    - ``evicted``: slots freed by the bounded evict-lowest-priority-then-
      retry policy on the way to this verdict.
    - ``prefix_len``: tokens of the prompt already resident as a shared
      prefix (0 without prefix sharing or on a miss). The caller prefills
      only rows ``prefix_len:``; the slot's ``seq_lens`` already stands
      there.
    """

    admitted: bool
    slot: int | None
    reason: str = "ok"
    evicted: tuple[int, ...] = ()
    prefix_len: int = 0

    def __bool__(self) -> bool:
        return self.admitted


@dataclasses.dataclass(frozen=True)
class DecodeBatch:
    """One decode step's batch: ``slots`` [b] int32, each sequence's cache
    slot."""

    slots: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.slots.shape[0]

    @staticmethod
    def of(slots, device: str | torch.device) -> "DecodeBatch":
        return DecodeBatch(torch.as_tensor(slots, dtype=torch.int32).to(device))


def magi_attn_decode(
    q: torch.Tensor,  # [b, hq, head_dim] the step's query token per sequence
    cache: PagedKVCache,
    batch: DecodeBatch,
    *,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Public decode attention over a paged cache (split-KV + LSE merge).
    Attends each query to its sequence's ``seq_lens[slot]`` cached tokens;
    :func:`append_kv` the step's own K/V first for causal decode. Returns
    ``(out [b, hq, d], lse [b, hq])``."""
    return decode_attn_paged(
        q,
        cache,
        batch.slots,
        num_splits=num_splits,
        scale=scale,
        softcap=softcap,
        out_dtype=out_dtype,
    )


def prefill_into_cache(
    q: torch.Tensor,  # [t, hq, head_dim] the prompt's queries
    k: torch.Tensor,  # [t, hk, head_dim]
    v: torch.Tensor,
    cache: PagedKVCache,
    slot: int,
    *,
    length: int | None = None,  # valid prompt rows (None = all t)
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal prefill through flex attention, with the prompt's KV written
    into the slot's pages in place. Returns ``(out [t, hq, d], lse [t,
    hq])``; with ``length`` < t the attention still runs over all t rows
    (rows at or past ``length`` are garbage the caller discards) and only
    the cache write is cut to ``length``."""
    t = q.shape[0]
    out, lse = flex_flash_attn_func(
        q,
        k,
        v,
        [(0, t)],
        [(0, t)],
        [int(AttnMaskType.CAUSAL)],
        scale=scale,
        softcap=softcap,
        out_dtype=out_dtype,
    )
    write_prefill_kv(cache, slot, k, v, length=length)
    return out, lse


def continue_prefill_into_cache(
    q: torch.Tensor,  # [t, hq, head_dim] this CHUNK's queries
    k: torch.Tensor,  # [t, hk, head_dim]
    v: torch.Tensor,
    cache: PagedKVCache,
    slot: int,
    *,
    start: int,  # tokens already written for this slot
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunked-prefill step: write the chunk's KV at the slot's current
    position, then attend the chunk's queries to the WHOLE written history
    gathered from the cache. Bottom-right-aligned CAUSAL over q ``(0, t)``
    x k ``(0, start + t)`` allows key ``j`` for chunk row ``i`` iff
    ``j <= start + i`` — what token ``start + i`` of a one-shot prefill
    sees. ``start`` must equal ``seq_lens[slot]``."""
    t = q.shape[0]
    start = int(start)
    write_prefill_kv(cache, slot, k, v)
    kc, vc = gather_kv(cache, slot, max_len=start + t)
    return flex_flash_attn_func(
        q,
        kc,
        vc,
        [(0, t)],
        [(0, start + t)],
        [int(AttnMaskType.CAUSAL)],
        scale=scale,
        softcap=softcap,
        out_dtype=out_dtype,
    )


class ServingEngine:
    """Continuous-batching host loop over one paged cache on ``device``.

    Owns the allocator, the cache and (``prefix_sharing``, the default)
    the shared-prefix trie; exposes admit / prefill / commit_prefix /
    decode_step / free. ``device`` defaults to ``"cuda"``, where prefill
    and decode run the Hopper kernels; ``device="cpu"`` runs their plain
    versions. ``cascade_override`` (``"auto"``/``"on"``/``"off"``, or None
    for ``MAGI_ATTENTION_CASCADE``) picks the decode path when a
    ``decode_step`` caller does not.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        num_kv_heads: int,
        head_dim: int,
        page_size: int | None = None,
        max_seqs: int = 64,
        max_pages_per_seq: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        max_admission_evictions: int = 4,
        prefix_sharing: bool = True,
        device: str | torch.device = "cuda",
    ):
        from .. import env

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the plain versions"
            )
        if page_size is None:
            page_size = env.page_size()
        if max_pages_per_seq is None:
            max_pages_per_seq = max(num_pages // max(max_seqs, 1), 1)
        self.cache = make_paged_kv_cache(
            num_pages,
            page_size,
            num_kv_heads,
            head_dim,
            max_seqs=max_seqs,
            max_pages_per_seq=max_pages_per_seq,
            dtype=dtype,
            device=self.device,
        )
        self.allocator = PageAllocator(num_pages, page_size, max_seqs, max_pages_per_seq)
        # inert until an admission carries token ids
        self.prefix: PrefixCache | None = PrefixCache(page_size) if prefix_sharing else None
        self._lengths: dict[int, int] = {}
        self._priorities: dict[int, int] = {}
        self._tokens: dict[int, tuple[int, ...]] = {}
        # slot -> (shared FULL prefix pages, their tokens): the cascade
        # group key, set on a fork or when a registrant commits its prompt
        self._slot_prefix: dict[int, tuple[tuple[int, ...], int]] = {}
        self.max_admission_evictions = int(max_admission_evictions)
        self.cascade_override: str | None = None

    # -- admission / retirement (host) --

    def admit(self, num_tokens: int, *, priority: int = 0,
              tokens: Sequence[int] | None = None) -> AdmissionResult:
        """Reserve a slot + pages for a sequence of ``num_tokens`` prompt
        tokens (decode growth comes later through :meth:`reserve_growth`).

        ``tokens``: the prompt's token ids. With prefix sharing, the longest
        resident prefix is installed by reference (``PageAllocator.fork``,
        no copy; ``seq_lens`` preset to the match) and only the rest needs
        pages and prefill; ``AdmissionResult.prefix_len`` says how much
        matched. Tokenless admissions never touch the trie.

        Never raises on resource pressure. Under pressure, prefix pages no
        sequence holds go first (least recently used, when pages are what
        is short), then live sequences whose ``priority`` is strictly below
        the incoming one (lowest first, at most
        ``max_admission_evictions``); if it still does not fit the verdict
        is backpressure."""
        need = max(self.allocator.pages_needed(num_tokens), 1)
        if need > self.allocator.max_pages_per_seq:
            return AdmissionResult(False, None, "too_long")
        tokens = tuple(int(t) for t in tokens) if tokens is not None else None
        evicted: list[int] = []
        while True:
            # re-match every round: an eviction below may have released
            # pages an earlier match pointed at
            match = (
                self.prefix.match(tokens)
                if self.prefix is not None and tokens is not None
                else None
            )
            if match is not None and match.hit:
                if self.allocator.can_fork(match.pages, num_tokens):
                    try:
                        slot, pages = self.allocator.fork(match.pages, num_tokens)
                    except PageAllocatorError:
                        return AdmissionResult(False, None, "alloc_error", tuple(evicted))
                    self._install(slot, pages, keep_len=match.length)
                    shared_full = (match.pages[: match.full_pages],
                                   match.full_pages * self.allocator.page_size)
                    return self._finish_admit(slot, priority, tokens, evicted,
                                              prefix_len=match.length, shared_full=shared_full)
            elif self.allocator.can_admit(num_tokens):
                try:
                    slot, pages = self.allocator.allocate(num_tokens)
                except PageAllocatorError:
                    return AdmissionResult(False, None, "alloc_error", tuple(evicted))
                self._install(slot, pages)
                return self._finish_admit(slot, priority, tokens, evicted)
            # cached prefix pages go first, but only when pages are what is
            # short: dropping them cannot cure a slot shortage
            shared = len(match.pages) if match is not None else 0
            deficit = need - shared - (self.allocator.num_pages - self.allocator.pages_in_use)
            if (deficit > 0 and self.prefix is not None
                    and self.allocator.active_seqs < self.allocator.max_seqs):
                if self.prefix.evict(self.allocator, deficit) > 0:
                    continue
            if len(evicted) >= self.max_admission_evictions:
                break
            victim = self._eviction_candidate(int(priority))
            if victim is None:
                break
            self.free(victim)
            evicted.append(victim)
        reason = (
            "no_free_slot"
            if self.allocator.active_seqs >= self.allocator.max_seqs
            else "pool_exhausted"
        )
        return AdmissionResult(False, None, reason, tuple(evicted))

    def _install(self, slot: int, pages, *, keep_len: bool | int = False) -> None:
        """The device-side block-table install of a fresh admission; if it
        fails, the allocator takes the pages back before the error goes on."""
        try:
            assign_block_table(self.cache, slot, pages, keep_len=keep_len)
        except Exception:
            self.allocator.free(slot)
            raise

    def _finish_admit(self, slot: int, priority: int, tokens, evicted: list[int], *,
                      prefix_len: int = 0, shared_full=None) -> AdmissionResult:
        """The bookkeeping both admission paths share."""
        self._priorities[slot] = int(priority)
        if tokens is not None:
            self._tokens[slot] = tokens
        if prefix_len:
            self._lengths[slot] = prefix_len
        if shared_full is not None and shared_full[0]:
            self._slot_prefix[slot] = (tuple(shared_full[0]), shared_full[1])
        return AdmissionResult(True, slot, "ok", tuple(evicted), prefix_len=prefix_len)

    def _eviction_candidate(self, incoming_priority: int) -> int | None:
        """Lowest-priority live slot strictly below the incoming priority
        (ties -> lowest slot id); None when nothing is evictable."""
        candidates = [(p, s) for s, p in self._priorities.items() if p < incoming_priority]
        return min(candidates)[1] if candidates else None

    def reserve_growth(self, slot: int, total_tokens: int) -> None:
        """Extend a slot's page reservation to ``total_tokens``."""
        pages = self.allocator.extend(slot, total_tokens)
        assign_block_table(self.cache, slot, pages, keep_len=True)

    def free(self, slot: int) -> None:
        """Retire a sequence: one reference dropped per page (a prefix page
        the trie or a sibling fork still holds stays resident), slot
        reusable. A double free raises the allocator's ``InvalidFreeError``
        before anything changes."""
        self.allocator.free(slot)
        reset_slot(self.cache, slot)
        for book in (self._lengths, self._priorities, self._tokens, self._slot_prefix):
            book.pop(slot, None)

    def _ensure_reserved(self, slot: int, total_tokens: int) -> None:
        """Grow the reservation to cover ``total_tokens`` before any write
        could land past the installed pages (unreserved block-table entries
        are 0, another sequence's page)."""
        if self.allocator.pages_needed(total_tokens) > self.allocator.reserved_pages(slot):
            self.reserve_growth(slot, total_tokens)

    def _ensure_writable(self, slot: int, start: int) -> None:
        """Copy-on-write split before a write at position ``start``: when
        the write lands mid-page and that page is shared (a fork's partial
        tail, or the registrant's own tail once the trie pinned it), the
        slot gets a private copy first. A write that starts on a page
        boundary lands on a page of the slot's own, so full prefix pages
        are never copied. ``cow_page`` refuses (pool exhausted) before any
        bookkeeping moves."""
        ps = self.allocator.page_size
        if start <= 0 or start % ps == 0 or start >= self.cache.max_seq_len:
            return
        idx = start // ps
        pages = self.allocator.slot_pages(slot)
        if idx >= len(pages) or self.allocator.page_ref(pages[idx]) <= 1:
            return  # not reserved yet (growth installs a fresh page), or private
        old, new = self.allocator.cow_page(slot, idx)
        copy_page(self.cache, old, new)
        swap_block_table_page(self.cache, slot, idx, new)

    # -- device steps --

    def prefill(self, q, k, v, slot: int, *, length: int | None = None, **kw):
        """Prefill prompt rows into ``slot``; returns the prefill (out, lse).

        A slot with committed tokens (a shared-prefix fork, or a prior
        chunk) takes the continuation path: the rows attend the whole
        written history; prompts longer than ``MAGI_ATTENTION_PREFILL_CHUNK``
        are split into chunk-sized steps (unset = one shot). ``t == 0`` is
        a prompt the prefix covered whole. When the admission's token ids
        are all written, the prompt is registered as a shareable prefix
        (:meth:`commit_prefix`). ``length`` (a padded prompt) is supported
        on the one-shot path only. A failure mid prefill releases the slot
        before re-raising, so its pages are not leaked; a refused
        reservation growth or copy-on-write split changes nothing."""
        from .. import env

        t = q.shape[0]
        start = self._lengths.get(slot, 0)
        if t == 0 and length is None:
            toks = self._tokens.get(slot)
            if toks is not None and start >= len(toks):
                self.commit_prefix(slot)
            return q.new_zeros((0, q.shape[1], q.shape[2])), q.new_zeros(
                (0, q.shape[1]), dtype=torch.float32)
        wrote = t if length is None else int(length)
        chunk = env.prefill_chunk()
        self._ensure_reserved(slot, start + wrote)
        self._ensure_writable(slot, start)
        try:
            if start == 0 and (chunk is None or t <= chunk):
                out, lse = prefill_into_cache(q, k, v, self.cache, slot, length=length, **kw)
            else:
                if length is not None:
                    raise ValueError(
                        "chunked/continuation prefill needs unpadded prompts "
                        "(length=None); pre-slice the valid rows"
                    )
                out, lse = self._chunked_prefill(q, k, v, slot, start, chunk, **kw)
        except Exception:
            self.free(slot)
            raise
        self._lengths[slot] = start + wrote
        toks = self._tokens.get(slot)
        if toks is not None and self._lengths[slot] >= len(toks):
            self.commit_prefix(slot)
        return out, lse

    def _chunked_prefill(self, q, k, v, slot, start, chunk, **kw):
        """Drive :func:`continue_prefill_into_cache` chunk by chunk; each
        chunk's cache write commits before the next chunk attends."""
        t = q.shape[0]
        step = int(chunk) if chunk else t
        outs, lses = [], []
        for pos in range(0, t, step):
            n = min(step, t - pos)
            o, l = continue_prefill_into_cache(
                q[pos : pos + n],
                k[pos : pos + n],
                v[pos : pos + n],
                self.cache,
                slot,
                start=start + pos,
                **kw,
            )
            outs.append(o)
            lses.append(l)
        return torch.cat(outs, dim=0), torch.cat(lses, dim=0)

    def commit_prefix(self, slot: int) -> int:
        """Register the slot's prefilled pages as a shareable prefix (trie
        nodes + one allocator reference per newly recorded page). Called by
        :meth:`prefill` when the admission's token ids are all written.
        Returns the pages newly pinned."""
        if self.prefix is None:
            return 0
        toks = self._tokens.get(slot)
        n = min(self._lengths.get(slot, 0), len(toks) if toks else 0)
        if not toks or n == 0:
            return 0
        pages = self.allocator.slot_pages(slot)
        newly = self.prefix.register(toks[:n], pages, self.allocator)
        full = n // self.allocator.page_size
        if full and slot not in self._slot_prefix:
            # a fresh registrant: its own leading full pages ARE the trie's
            # resident copy (a fork keeps the key it shares with its siblings)
            self._slot_prefix[slot] = (tuple(pages[:full]), full * self.allocator.page_size)
        return newly

    def decode_step(self, q, k_new, v_new, slots, *, num_splits: int | None = None,
                    cascade: bool | str | None = None, **kw):
        """One continuous-batching decode step: append each sequence's new
        KV, then attend over the whole history (the new token included).
        Reservations grow automatically when a sequence crosses into an
        unreserved page, and a sequence appending into a still-shared tail
        page gets its copy-on-write split first.

        ``cascade``: None follows ``cascade_override``, else
        ``MAGI_ATTENTION_CASCADE`` (``auto`` = cascade decode whenever two
        or more batch members share a resident full-page prefix); True or
        ``"on"`` cascades every prefix-carrying sequence (singleton groups
        too); False or ``"off"`` takes the flat split-KV path. Returns
        ``(out [b, hq, d], lse [b, hq])``."""
        from .. import env

        slot_list = [int(s) for s in slots]
        for s in slot_list:
            self._ensure_reserved(s, self._lengths.get(s, 0) + 1)
            self._ensure_writable(s, self._lengths.get(s, 0))
        if cascade is None:
            mode = self.cascade_override if self.cascade_override is not None else env.cascade_mode()
        elif isinstance(cascade, str):
            mode = cascade
        else:
            mode = "on" if cascade else "off"
        if mode not in env.CASCADE_MODES:
            raise ValueError(f"cascade={mode!r} must be one of {env.CASCADE_MODES}")
        groups = []
        if mode != "off" and self._slot_prefix:
            groups = plan_cascade_groups(self._slot_prefix, slot_list,
                                         min_group=1 if mode == "on" else 2)
        batch = DecodeBatch.of(slot_list, self.device)
        append_kv(self.cache, batch.slots, k_new, v_new)
        for s in slot_list:
            self._lengths[s] = self._lengths.get(s, 0) + 1
        if groups:
            return cascade_decode_attn(q, self.cache, slot_list, groups,
                                       num_splits=num_splits, **kw)
        num_splits = resolve_num_splits(num_splits, self.cache, batch.batch_size)
        return magi_attn_decode(q, self.cache, batch, num_splits=num_splits, **kw)

    def length(self, slot: int) -> int:
        """Tokens committed for ``slot`` (host state)."""
        return self._lengths.get(slot, 0)
