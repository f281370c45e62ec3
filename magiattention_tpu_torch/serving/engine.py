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
  ``prefix.py``), reservation growth, copy-on-write, prefill, decode steps,
  the one-launch tick (:meth:`ServingEngine.unified_tick`, over
  ``unified_tick.py``) and slot recycling.

Cache updates are in place (see ``kv_cache.py``), so these functions return
attention outputs only, where the JAX ones also return a new cache.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .. import telemetry
from ..common.enum import AttnMaskType
from ..ops.block_sparse import TickEnumeration
from ..ops.flex_attn import flex_flash_attn_func
from ..resilience import chaos
from ..resilience.chaos import ChaosInjectedError
from ..telemetry import exposition, numerics, trace
from ..utils.instrument import named_scope
from .decode_attn import decode_attn_paged, decode_reference, resolve_num_splits
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
    shards_of,
    swap_block_table_page,
    write_prefill_kv,
)
from .prefix import PrefixCache, cascade_decode_attn, plan_cascade_groups
from .unified_tick import demux_tick, resolve_tick_splits, unified_tick_attn


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
    with named_scope("magi_prefill_attn"):
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
    with named_scope("magi_kvcache_prefill_write"):
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
    with named_scope("magi_kvcache_prefill_write"):
        write_prefill_kv(cache, slot, k, v)
    kc, vc = gather_kv(cache, slot, max_len=start + t)
    with named_scope("magi_prefill_attn"):
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
    ``decode_step`` caller does not, ``decode_splits_override`` the split
    count. ``decode_attn_fn`` substitutes the decode attention of
    :meth:`decode_step`, called as ``fn(q, cache, slots, num_splits=, **kw)``
    (the tiered engine's tensor-parallel decode over a sharded pool): it
    skips the cascade, and :meth:`unified_tick` refuses it.

    Telemetry, as the JAX engine records it: the pool's occupancy after
    every admission, growth and free, admissions and prefix-cache events,
    each prefill and decode step under its program label (``telemetry.
    program``), the shadow check of every Nth decode batch
    (``MAGI_ATTENTION_SHADOW_SAMPLE_RATE``) against the plain f32 decode,
    and the flight recorder's ``engine_fault``, ``pool_exhausted`` and
    ``numeric_drift`` dumps, each embedding :meth:`memory_snapshot`
    (``register_flight_memory=False`` opts a tiered member engine out: the
    tiered engine registers one source for the fleet). The first engine
    starts the metrics server when ``MAGI_ATTENTION_METRICS_PORT`` is set.
    No hook reads a device tensor; the shadow check reads the outputs it
    scores.
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
        decode_attn_fn=None,
        register_flight_memory: bool = True,
        device: str | torch.device = "cuda",
    ):
        from .. import env

        env.refuse_unhonoured_flags("ServingEngine")
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
        self._decode_attn_fn = decode_attn_fn
        self.cascade_override: str | None = None
        # pins the decode split count when a decode_step caller passes none
        # (the scheduler's decode_splits knob)
        self.decode_splits_override: int | None = None
        # what the last decode_step / unified_tick resolved (label, splits,
        # cascade grouping): the scheduler's launch census and its request
        # spans read them
        self.last_decode_info: dict = {}
        self.last_tick_info: dict = {}
        self._flight = trace.get_flight_recorder()
        if register_flight_memory:
            self._flight.register_memory_source("engine", self)
        # dumps carry the numerics census even after a flight-recorder reset
        numerics.ensure_flight_registration()
        self._shadow_counter = 0
        self._pool_exhausted_armed = False
        exposition.ensure_metrics_server()
        self._record_pool()

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
        is backpressure. An allocator failure after the probe (an injected
        ``alloc_fail`` included) answers ``alloc_error``."""
        need = max(self.allocator.pages_needed(num_tokens), 1)
        if need > self.allocator.max_pages_per_seq:
            return self._note_admission(AdmissionResult(False, None, "too_long"))
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
                    except (ChaosInjectedError, PageAllocatorError):
                        return self._refuse(AdmissionResult(False, None, "alloc_error",
                                                            tuple(evicted)))
                    self._install(slot, pages, keep_len=match.length)
                    shared_full = (match.pages[: match.full_pages],
                                   match.full_pages * self.allocator.page_size)
                    return self._finish_admit(slot, priority, tokens, evicted,
                                              prefix_len=match.length, shared_full=shared_full)
            elif self.allocator.can_admit(num_tokens):
                try:
                    slot, pages = self.allocator.allocate(num_tokens)
                except (ChaosInjectedError, PageAllocatorError):
                    return self._refuse(AdmissionResult(False, None, "alloc_error",
                                                        tuple(evicted)))
                self._install(slot, pages)
                return self._finish_admit(slot, priority, tokens, evicted)
            # cached prefix pages go first, but only when pages are what is
            # short: dropping them cannot cure a slot shortage
            shared = len(match.pages) if match is not None else 0
            deficit = need - shared - (self.allocator.num_pages - self.allocator.pages_in_use)
            if (deficit > 0 and self.prefix is not None
                    and self.allocator.active_seqs < self.allocator.max_seqs):
                freed = self.prefix.evict(self.allocator, deficit)
                if freed > 0:
                    telemetry.record_prefix_eviction(freed, self.prefix.resident_pages)
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
        return self._refuse(AdmissionResult(False, None, reason, tuple(evicted)))

    def _refuse(self, res: AdmissionResult) -> AdmissionResult:
        """A refused admission's telemetry: the verdict and the pool."""
        self._note_admission(res)
        self._record_pool()
        return res

    def _note_admission(self, res: AdmissionResult) -> AdmissionResult:
        """The admission telemetry every verdict shares: the registry
        counters (gated on the telemetry flag) and the always-on flight
        recorder's rejection-storm detector. The first ``pool_exhausted``
        verdict of a pressure episode arms a deferred dump tagged with the
        admitting request's trace id (the scheduler's tick-end flush writes
        it); an admission that succeeds re-arms it."""
        telemetry.record_admission(res)
        self._flight.note_admission(res.admitted, res.reason)
        if res.admitted:
            self._pool_exhausted_armed = False
        elif res.reason == "pool_exhausted" and not self._pool_exhausted_armed:
            self._pool_exhausted_armed = True
            cur = trace.current_trace()
            self._flight.trigger(
                "pool_exhausted",
                immediate=False,
                trace_id=cur[0] if cur is not None else None,
                pages_in_use=self.allocator.pages_in_use,
                pages_total=self.allocator.num_pages,
                active_seqs=self.allocator.active_seqs,
            )
        return res

    def _install(self, slot: int, pages, *, keep_len: bool | int = False) -> None:
        """The device-side block-table install of a fresh admission; if it
        fails, the allocator takes the pages back before the error goes on."""
        try:
            assign_block_table(self.cache, slot, pages, keep_len=keep_len)
        except Exception:
            self.allocator.free(slot)
            self._record_pool()
            raise

    def _finish_admit(self, slot: int, priority: int, tokens, evicted: list[int], *,
                      prefix_len: int = 0, shared_full=None) -> AdmissionResult:
        """The bookkeeping and telemetry both admission paths share."""
        self._priorities[slot] = int(priority)
        if tokens is not None:
            self._tokens[slot] = tokens
            if self.prefix is not None:
                # only admissions that consulted the trie count as lookups
                telemetry.record_prefix_lookup(hit=prefix_len > 0, matched_tokens=prefix_len)
        if prefix_len:
            self._lengths[slot] = prefix_len
        if shared_full is not None and shared_full[0]:
            self._slot_prefix[slot] = (tuple(shared_full[0]), shared_full[1])
        res = AdmissionResult(True, slot, "ok", tuple(evicted), prefix_len=prefix_len)
        self._note_admission(res)
        self._record_pool()
        return res

    def _eviction_candidate(self, incoming_priority: int) -> int | None:
        """Lowest-priority live slot strictly below the incoming priority
        (ties -> lowest slot id); None when nothing is evictable."""
        candidates = [(p, s) for s, p in self._priorities.items() if p < incoming_priority]
        return min(candidates)[1] if candidates else None

    def reserve_growth(self, slot: int, total_tokens: int) -> None:
        """Extend a slot's page reservation to ``total_tokens``."""
        pages = self.allocator.extend(slot, total_tokens)
        assign_block_table(self.cache, slot, pages, keep_len=True)
        self._record_pool()

    def free(self, slot: int) -> None:
        """Retire a sequence: one reference dropped per page (a prefix page
        the trie or a sibling fork still holds stays resident), slot
        reusable. A double free raises the allocator's ``InvalidFreeError``
        before anything changes."""
        self.allocator.free(slot)
        reset_slot(self.cache, slot)
        for book in (self._lengths, self._priorities, self._tokens, self._slot_prefix):
            book.pop(slot, None)
        self._record_pool()

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
        with named_scope("magi_kvcache_cow"):
            copy_page(self.cache, old, new)
            swap_block_table_page(self.cache, slot, idx, new)
        telemetry.record_prefix_cow()

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
        on the one-shot path only. A failure mid prefill (an injected
        ``prefill_error`` included) releases the slot before re-raising, so
        its pages are not leaked; a refused reservation growth or
        copy-on-write split changes nothing."""
        from .. import env

        t = q.shape[0]
        start = self._lengths.get(slot, 0)
        if t == 0 and length is None:
            self._commit_if_written(slot)
            return self._empty_result(q)
        wrote = t if length is None else int(length)
        chunk = env.prefill_chunk()
        self._ensure_reserved(slot, start + wrote)
        self._ensure_writable(slot, start)
        label = telemetry.prefill_program_label(start, wrote)
        try:
            chaos.maybe_fail("prefill_error")
            with telemetry.program(label):
                if start == 0 and (chunk is None or t <= chunk):
                    out, lse = prefill_into_cache(q, k, v, self.cache, slot, length=length,
                                                  **kw)
                else:
                    if length is not None:
                        raise ValueError(
                            "chunked/continuation prefill needs unpadded prompts "
                            "(length=None); pre-slice the valid rows"
                        )
                    out, lse = self._chunked_prefill(q, k, v, slot, start, chunk, **kw)
        except Exception:
            self._release_after_fault(slot)
            raise
        self._lengths[slot] = start + wrote
        telemetry.record_prefill(wrote)
        self._commit_if_written(slot)
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

    def _release_after_fault(self, slot: int) -> None:
        """Tear a faulted slot down, best effort: its pages back to the pool
        and its bookkeeping dropped. It never raises over the fault being
        handled: a release that fails itself (the slot already freed) is
        logged and the bookkeeping still goes. Arms a deferred
        ``engine_fault`` flight dump: the scheduler records the aborted tick
        and flushes, so the dump holds the tick the fault killed."""
        self._flight.trigger("engine_fault", immediate=False, slot=slot)
        try:
            self.free(slot)
        except Exception:
            telemetry.get_logger("resilience").warning(
                "fault cleanup could not release slot %s", slot, exc_info=True)
        for book in (self._lengths, self._priorities, self._tokens, self._slot_prefix):
            book.pop(slot, None)
        self._record_pool()

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
        telemetry.record_prefix_registered(newly, self.prefix.resident_pages)
        self._record_pool()
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
        slot_list = [int(s) for s in slots]
        for s in slot_list:
            self._ensure_reserved(s, self._lengths.get(s, 0) + 1)
            self._ensure_writable(s, self._lengths.get(s, 0))
        mode = self._cascade_mode(cascade)
        groups = []
        if mode != "off" and self._slot_prefix and self._decode_attn_fn is None:
            groups = plan_cascade_groups(self._slot_prefix, slot_list,
                                         min_group=1 if mode == "on" else 2)
        batch = DecodeBatch.of(slot_list, self.device)
        label = telemetry.decode_program_label(batch.batch_size)
        with telemetry.program(label):
            with named_scope("magi_kvcache_append"):
                append_kv(self.cache, batch.slots, k_new, v_new)
            for s in slot_list:
                self._lengths[s] = self._lengths.get(s, 0) + 1
            if groups:
                # each phase resolves its own splits: 0 = "per phase"
                resolved = 0
                out, lse = cascade_decode_attn(q, self.cache, slot_list, groups,
                                               num_splits=num_splits, **kw)
            elif self._decode_attn_fn is not None:
                # the substitute resolves its own splits: 0 = "resolved outside"
                resolved = 0
                out, lse = self._decode_attn_fn(q, self.cache, batch.slots,
                                                num_splits=num_splits, **kw)
            else:
                if num_splits is None:
                    num_splits = self.decode_splits_override
                resolved = resolve_num_splits(num_splits, self.cache, batch.batch_size,
                                              int(q.shape[1]))
                out, lse = magi_attn_decode(q, self.cache, batch, num_splits=resolved, **kw)
        self.last_decode_info = {
            "batch": batch.batch_size,
            "program": label,
            "num_splits": resolved,
            "cascade_groups": len(groups),
            "cascade_group_of": {slot_list[pos]: gi for gi, g in enumerate(groups)
                                 for pos in g.members},
        }
        telemetry.record_decode_step(
            batch_size=batch.batch_size,
            num_splits=resolved,
            max_seq_len=max((self._lengths.get(s, 0) for s in slot_list), default=0),
            cascade_groups=len(groups),
        )
        self._maybe_shadow_check(q, slot_list, out, lse, kw)
        return out, lse

    def _maybe_shadow_check(self, q, slot_list, out, lse, kw) -> None:
        """The shadow check: every Nth decode batch
        (``MAGI_ATTENTION_SHADOW_SAMPLE_RATE``; 0 = off) is recomputed by
        :func:`~.decode_attn.decode_reference` — the plain f32 single-split
        decode, outside every resilience hook — and scored against the
        production output with the error-budget oracle. Every check lands
        in the ``magi_numerics_shadow_*`` series and the census ring; a
        breach arms a deferred ``numeric_drift`` flight dump tagged with
        the live trace id. It reads the outputs on the host (the one
        synchronisation of a sampled step), and changes no plan, key or
        output.

        One departure from the JAX package: the relative and ulp rows of the
        budget judge only the outputs whose reference is at least the
        budget's ``max_abs``; ``max_abs`` and the lse rows judge every
        output. The kernel rounds P to the cache dtype before the PV
        product and the f32 reference does not, so an output near zero may
        land on the other side of it: on the card a clean bf16 batch then
        scores tens of thousands of ulps (a sign flip crosses every small
        binade) within 3e-4 of its reference."""
        from .. import env

        rate = env.shadow_sample_rate()
        if rate <= 0:
            return
        self._shadow_counter += 1
        if self._shadow_counter % rate:
            return
        ref_out, ref_lse = self._shadow_reference(q, slot_list, kw.get("scale"),
                                                  kw.get("softcap", 0.0))
        report = numerics.divergence_report(ref_out, out, ref_lse=ref_lse, test_lse=lse)
        try:
            budget = numerics.budget_for_dtype(report.dtype)
        except ValueError:
            # an out dtype without a calibrated row: the f32 budget
            budget = numerics.budget_for_dtype("float32")
        scaled = ("out.max_rel", "out.max_ulp")
        significant = ref_out.abs() >= budget.max_abs
        max_ulp = 0.0
        violations = [v for v in budget.violations(report) if v not in scaled]
        if bool(significant.any()):
            sig = numerics.divergence_report(ref_out[significant], out[significant])
            max_ulp = sig.out_max_ulp
            violations += [v for v in budget.violations(sig) if v in scaled]
        breached = bool(violations)
        telemetry.record_shadow_check(max_ulp, breached=breached)
        ctx = trace.current_trace()
        numerics.get_numerics_census().note_shadow({
            "batch": len(slot_list),
            "trace_id": ctx[0] if ctx else None,
            "rid": ctx[1] if ctx else None,
            "breached": breached,
            "violations": list(violations),
            "scored_max_ulp": max_ulp,
            "report": report.to_json(),
        }, breached=breached)
        if breached:
            self._flight.trigger(
                "numeric_drift",
                immediate=False,
                trace_id=ctx[0] if ctx else None,
                rid=ctx[1] if ctx else None,
                violations=list(violations),
                max_ulp=max_ulp,
                dominant=report.dominant,
            )

    def _shadow_reference(self, q, slot_list, scale, softcap):
        """The plain f32 decode of ``slot_list`` over the pool as it stands
        (the step's token appended); a pool sharded on its kv heads is
        recomputed shard by shard on each shard's q-head slice, as the
        per-head softmax allows."""
        shards = shards_of(self.cache)
        hq = q.shape[1]
        outs, lses = [], []
        for i, c in enumerate(shards):
            idx = torch.as_tensor(slot_list, dtype=torch.long, device=c.device)
            h = slice(i * hq // len(shards), (i + 1) * hq // len(shards))
            o, l = decode_reference(q[:, h].to(c.device), c, c.block_tables[idx],
                                    c.seq_lens[idx], scale=scale, softcap=softcap)
            outs.append(o.to(q.device))
            lses.append(l.to(q.device))
        return torch.cat(outs, dim=1), torch.cat(lses, dim=1)

    def _cascade_mode(self, cascade) -> str:
        """The decode path a caller's ``cascade`` asks for: None follows
        ``cascade_override``, else ``MAGI_ATTENTION_CASCADE``; a bool is
        on / off."""
        from .. import env

        if cascade is None:
            mode = self.cascade_override if self.cascade_override is not None else env.cascade_mode()
        elif isinstance(cascade, str):
            mode = cascade
        else:
            mode = "on" if cascade else "off"
        if mode not in env.CASCADE_MODES:
            raise ValueError(f"cascade={mode!r} must be one of {env.CASCADE_MODES}")
        return mode

    def unified_tick(self, decode_items, prefill_items, *, cascade=None,
                     num_splits: int | None = None, scale: float | None = None,
                     softcap: float = 0.0):
        """One serving tick in one ``paged_decode`` launch: every decode step
        and every prefill chunk of the tick as rows of one
        :func:`~.unified_tick.unified_tick_attn` call over the pool, then
        demuxed per request.

        - ``decode_items``: ``[(slot, q [hq, d], k [hk, d], v [hk, d])]``, one
          new token per decoding sequence, appended then attended over the
          whole history (as :meth:`decode_step`);
        - ``prefill_items``: ``[(slot, q [t, hq, d], k, v)]``, one chunk per
          prefilling sequence at the slot's committed position; a ``t = 0``
          item runs only the completion hooks (as :meth:`prefill`'s early
          return).

        Returns ``(decode_results, prefill_results)`` aligned with the
        inputs: ``(out [hq, d], lse [hq])`` and ``(out [t, hq, d], lse [t,
        hq])``, out in q's dtype. Rows in order: the decode items (a cascade
        member's prefix row before its main row), then the prefill chunks.
        Cascade follows ``cascade`` as :meth:`decode_step` does, decode
        members only. The host phase (reservation growth, copy-on-write
        splits, the enumeration) runs before any device work, so a refused
        growth changes nothing; a device-phase failure releases every
        prefill item's slot and re-raises; decode slots are kept. An engine
        with a substituted decode (``decode_attn_fn``) raises: the tick's
        kernel is the attention."""
        if self._decode_attn_fn is not None:
            raise ValueError(
                "unified_tick does not compose with a substituted decode realization "
                "(decode_attn_fn): the tick kernel IS the attention — TP decode tiers keep the "
                "per-request path")
        ps = self.allocator.page_size
        decode_slots = [int(it[0]) for it in decode_items]
        prefill_slots = [int(it[0]) for it in prefill_items]
        overlap = set(decode_slots) & set(prefill_slots)
        if overlap:
            raise ValueError(
                f"unified_tick: slots {sorted(overlap)} appear as both decode and prefill items "
                "— a sequence is in exactly one phase per tick")
        # host phase: growth and copy-on-write before the enumeration reads
        # the page lists (a split changes a page id)
        for slot in decode_slots:
            self._ensure_reserved(slot, self._lengths.get(slot, 0) + 1)
            self._ensure_writable(slot, self._lengths.get(slot, 0))
        prefill_meta = []  # (slot, start, t) aligned with prefill_items
        for slot, q, _k, _v in prefill_items:
            t = int(q.shape[0])
            start = self._lengths.get(slot, 0)
            prefill_meta.append((int(slot), start, t))
            if t:
                self._ensure_reserved(slot, start + t)
                self._ensure_writable(slot, start)
        mode = self._cascade_mode(cascade)
        groups = []
        if mode != "off" and self._slot_prefix and decode_slots:
            groups = plan_cascade_groups(self._slot_prefix, decode_slots,
                                         min_group=1 if mode == "on" else 2)
        group_of_pos = {pos: g for g in groups for pos in g.members}
        tick = TickEnumeration(ps)
        q_parts = []  # row-ordered [n, hq, d] pieces
        for j, (slot, q1, _k, _v) in enumerate(decode_items):
            new_len = self._lengths.get(int(slot), 0) + 1
            pages = self.allocator.slot_pages(int(slot))
            need = -(-new_len // ps)
            g = group_of_pos.get(j)
            if g is not None:
                ns = len(g.shared_pages)
                tick.add_decode(("d", j), pages[ns:need], new_len - g.prefix_len,
                                prefix_pages=g.shared_pages, prefix_len=g.prefix_len)
                q_parts += [q1[None], q1[None]]  # the prefix row, then the main row
            else:
                tick.add_decode(("d", j), pages[:need], new_len)
                q_parts.append(q1[None])
        prefill_rows = 0
        for j, (slot, q, _k, _v) in enumerate(prefill_items):
            _s, start, t = prefill_meta[j]
            if t == 0:
                continue
            pages = self.allocator.slot_pages(int(slot))
            tick.add_prefill(("p", j), pages[: -(-(start + t) // ps)], start, t)
            q_parts.append(q)
            prefill_rows += t
        if tick.num_rows == 0:
            # nothing to launch: the completion hooks of fully-cached prompts
            prefill_results = []
            for slot, q, _k, _v in prefill_items:
                self._commit_if_written(int(slot))
                prefill_results.append(self._empty_result(q))
            self.last_tick_info = {"program": None, "rows": 0, "entries": 0, "num_splits": 0,
                                   "decode_batch": 0, "prefill_rows": 0, "cascade_groups": 0,
                                   "cascade_group_of": {}}
            return [], prefill_results
        rows, entries = tick.finalize()
        hq, head_dim = int(q_parts[0].shape[1]), int(q_parts[0].shape[2])
        resolved = resolve_tick_splits(num_splits, self.cache, rows, entries, hq,
                                       prefill_rows=prefill_rows)
        label = telemetry.tick_program_label(rows, entries, resolved)
        try:
            if prefill_rows:
                chaos.maybe_fail("prefill_error")
            with telemetry.program(label):
                if decode_items:
                    batch = DecodeBatch.of(decode_slots, self.device)
                    k_new = torch.stack([it[2] for it in decode_items])
                    v_new = torch.stack([it[3] for it in decode_items])
                    with named_scope("magi_kvcache_append"):
                        append_kv(self.cache, batch.slots, k_new, v_new)
                    for s in decode_slots:
                        self._lengths[s] = self._lengths.get(s, 0) + 1
                for j, (slot, _q, k, v) in enumerate(prefill_items):
                    if prefill_meta[j][2]:
                        with named_scope("magi_kvcache_prefill_write"):
                            write_prefill_kv(self.cache, int(slot), k, v)
                pad = rows - sum(int(p.shape[0]) for p in q_parts)
                if pad:
                    q_parts.append(q_parts[0].new_zeros((pad, hq, head_dim)))
                out, lse = unified_tick_attn(torch.cat(q_parts, dim=0), self.cache, tick,
                                             num_splits=resolved, scale=scale, softcap=softcap)
                parts = demux_tick(tick, out, lse)
        except Exception:
            for slot, _start, t in prefill_meta:
                if t:
                    self._release_after_fault(slot)
            raise
        decode_results = []
        for j, (_slot, q1, _k, _v) in enumerate(decode_items):
            o, l = parts[("d", j)]
            decode_results.append((o[0].to(q1.dtype), l[0]))
        prefill_results = []
        for j, (slot, q, _k, _v) in enumerate(prefill_items):
            _s, start, t = prefill_meta[j]
            if t:
                o, l = parts[("p", j)]
                prefill_results.append((o.to(q.dtype), l))
                self._lengths[int(slot)] = start + t
                telemetry.record_prefill(t)
            else:
                prefill_results.append(self._empty_result(q))
            self._commit_if_written(int(slot))
        if decode_items:
            telemetry.record_decode_step(
                batch_size=len(decode_items),
                num_splits=resolved,
                max_seq_len=max((self._lengths.get(s, 0) for s in decode_slots), default=0),
                cascade_groups=len(groups),
            )
        self.last_tick_info = {
            "program": label,
            "rows": rows,
            "entries": entries,
            "num_splits": resolved,
            "decode_batch": len(decode_items),
            "prefill_rows": prefill_rows,
            "cascade_groups": len(groups),
            "cascade_group_of": {decode_slots[pos]: gi for gi, g in enumerate(groups)
                                 for pos in g.members},
        }
        return decode_results, prefill_results

    def _commit_if_written(self, slot: int) -> None:
        """Register the prompt once the admission's token ids are all written."""
        toks = self._tokens.get(slot)
        if toks is not None and self._lengths.get(slot, 0) >= len(toks):
            self.commit_prefix(slot)

    @staticmethod
    def _empty_result(q):
        """The (out, lse) of a prefill with no rows."""
        return (q.new_zeros((0, q.shape[1], q.shape[2])),
                q.new_zeros((0, q.shape[1]), dtype=torch.float32))

    def length(self, slot: int) -> int:
        """Tokens committed for ``slot`` (host state)."""
        return self._lengths.get(slot, 0)

    # -- introspection --

    def occupancy(self) -> dict:
        return self.allocator.occupancy()

    def memory_snapshot(self) -> dict:
        """JSON-safe memory forensics of this engine: the priced serving
        ledger (pool split live/trie/free, CoW pages once) and the page
        fragmentation map — what the flight recorder embeds in every dump.
        Host arithmetic over the allocator and the pool's shapes."""
        return telemetry.engine_memory_snapshot(self)

    def _record_pool(self) -> None:
        if telemetry.enabled():  # off: no occupancy scan either
            telemetry.record_kvcache_state(self.allocator.occupancy())
