"""Serving-state interleaving checker.

The JAX package's ``analysis/lifecycle.py``, over the port's serving host
objects. Interleaving bugs — a refcount dropped twice on one path and
never on another, an eviction victim left dangling in the scheduler's
active table, a page at once on the free list and in a live block table —
show only in a particular order of admissions, prefills, evictions and
faults. This checker drives the REAL host objects
(:class:`~..serving.kv_cache.PageAllocator`,
:class:`~..serving.prefix.PrefixCache`,
:class:`~..serving.engine.ServingEngine`,
:class:`~..serving.scheduler.Scheduler`,
:class:`~..serving.distributed.TieredEngine` and ``TieredScheduler``) over
a **stubbed device layer**, through every bounded event interleaving,
asserting global invariants at every reached state.

- **Stubbed device layer** (:func:`stubbed_device_layer`). All host
  bookkeeping is real; only the device work (the cache ops, prefill and
  decode attention, the tiers' page stream) is replaced by stubs whose
  *length semantics* are the real ops' (``seq_lens`` saturation,
  ``keep_len`` validation). The port's cache ops update the cache in place
  and return nothing, so the stubs do too, on a :class:`_StubCache` whose
  block tables and lengths are small real CPU tensors (a flight dump's
  memory ledger reads them) and whose page pools are empty. Where the
  engine builds small host tensors itself (a decode batch's slots, the
  scheduler's stacked decode rows) it builds real CPU tensors. Events cost
  microseconds, and a host-logic bug cannot hide behind a mocked-away
  assertion.

- **Exhaustive bounded exploration** (:func:`explore`). Breadth-first over
  event sequences up to ``max_depth``, deduplicating on a **canonical state
  hash** — page ids renamed to first-use order, so states equal up to the
  allocator's id choice collapse — each node rebuilt by replaying its event
  path against a fresh system. Breadth-first order makes the first
  counterexample a MINIMAL event trace.

- **Invariant catalog** (checked at every state): refcount conservation
  (every resident page's refcount equals its sequence owners plus its trie
  residency, exactly); no page at once free and referenced; a duplicate-free
  free list and page-count conservation; every sequence id in exactly one
  lifecycle state (no dangling bookkeeping, scheduler actives own live
  slots, tier records match the tier allocators); host/device length-mirror
  agreement; stream-queue conservation (a parked stream <=> the
  ``stream_queued`` stage, the queue under its bound); per-tier budget
  >= 0; quiescence => all pages free.

- **Mutation self-tests.** Two historical bugs replant as context managers
  — :func:`planted_double_free` (a retire path that skips the refcount
  decrement) and :func:`planted_dangling_eviction` (a scheduler that drops
  a FAILED admission's eviction victims) — and the checker must find each
  with a counterexample of at most 8 events (:func:`run_mutation_self_test`).

Run through ``python -m magiattention_tpu_torch.analysis --only lifecycle``.
Telemetry: ``magi_analysis_states_explored`` /
``magi_analysis_counterexamples`` (``REQUIRED_ANALYSIS_METRICS``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import tempfile
from typing import Sequence

import torch

from .trace_audit import _pinned_env

# ---------------------------------------------------------------------------
# the stubbed device layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _StubCache:
    """Host stand-in of :class:`~..serving.kv_cache.PagedKVCache`: empty
    page pools of the real shape's geometry, and REAL ``block_tables`` /
    ``seq_lens`` (int32 CPU tensors) updated in place with the real ops'
    length semantics, so the checker can assert the host/device length
    mirror."""

    k_pages: object  # [num_pages, page_size, kv_heads, 0]: geometry, no payload
    v_pages: object
    block_tables: object  # [max_seqs, max_pages_per_seq] int32
    seq_lens: object  # [max_seqs] int32
    head_dim: int

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
    def max_seqs(self) -> int:
        return self.block_tables.shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return self.block_tables.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    @property
    def device(self):
        return self.k_pages.device


def _stub_make_cache(num_pages, page_size, num_kv_heads, head_dim, *, max_seqs,
                     max_pages_per_seq=None, dtype=None, device=None):
    import torch

    if page_size % 8:  # the real op's tiling contract
        raise ValueError(f"page_size={page_size} must be a multiple of 8")
    mpp = max_pages_per_seq if max_pages_per_seq is not None else num_pages
    empty = torch.empty((num_pages, page_size, num_kv_heads, 0),
                        dtype=dtype if dtype is not None else torch.bfloat16)
    return _StubCache(
        k_pages=empty,
        v_pages=empty,
        block_tables=torch.zeros((max_seqs, mpp), dtype=torch.int32),
        seq_lens=torch.zeros((max_seqs,), dtype=torch.int32),
        head_dim=int(head_dim),
    )


def _stub_assign_block_table(cache, slot, pages, *, keep_len=False):
    # the real op's validation exactly — a fork claiming tokens past its
    # installed pages must be REJECTED here too, with the same messages
    if len(pages) > cache.max_pages_per_seq:
        raise ValueError(
            f"block table for slot {slot} would overflow: {len(pages)} "
            f"pages > max_pages_per_seq {cache.max_pages_per_seq}"
        )
    if keep_len is not True:
        n = 0 if keep_len is False else int(keep_len)
        if not 0 <= n <= len(pages) * cache.page_size:
            raise ValueError(
                f"keep_len={n} out of range for slot {slot}: the "
                f"{len(pages)}-page list holds at most "
                f"{len(pages) * cache.page_size} tokens"
            )
        cache.seq_lens[int(slot)] = n
    row = cache.block_tables[int(slot)]
    row.zero_()
    if len(pages):
        row[: len(pages)] = row.new_tensor([int(p) for p in pages])


def _stub_reset_slot(cache, slot):
    cache.seq_lens[int(slot)] = 0


def _stub_copy_page(cache, _src, _dst):
    return None


def _stub_swap_block_table_page(cache, slot, page_idx, new_page):
    cache.block_tables[int(slot), int(page_idx)] = int(new_page)


def _stub_append_kv(cache, slots, _k, _v):
    for s in slots.tolist():
        if int(cache.seq_lens[s]) < cache.max_seq_len:  # the real op's saturation
            cache.seq_lens[s] += 1


def _stub_write(cache, slot, t, length):
    start = int(cache.seq_lens[int(slot)])
    wrote = max(min(t if length is None else int(length), cache.max_seq_len - start), 0)
    cache.seq_lens[int(slot)] = start + wrote


def _stub_write_prefill_kv(cache, slot, k, _v, length=None):
    _stub_write(cache, slot, k.shape[0], length)


def _stub_outputs(q):
    return q.new_zeros(q.shape), q.new_zeros(q.shape[:2])


def _stub_prefill_into_cache(q, k, v, cache, slot, *, length=None, **_kw):
    _stub_write(cache, slot, q.shape[0], length)
    return _stub_outputs(q)


def _stub_continue_prefill_into_cache(q, k, v, cache, slot, *, start, **_kw):
    _stub_write(cache, slot, q.shape[0], None)
    return _stub_outputs(q)


def _stub_gather_kv(cache, slot, max_len=None):
    import torch

    n = max_len or cache.max_seq_len
    z = torch.zeros((n, cache.num_kv_heads, cache.head_dim))
    return z, z


def _stub_decode_attn_paged(q, _cache, _slots, **_kw):
    return _stub_outputs(q)


def _stub_cascade_decode_attn(q, _cache, _slots, _groups, **_kw):
    return _stub_outputs(q)


def _stub_unified_tick_attn(q, _cache, _tick, **_kw):
    return _stub_outputs(q)


def _stub_resolve_splits(*_a, **_k):
    return 1


def _stub_stream_pages(self, src_pages, _rep, _dst_pages):
    import torch

    empty = torch.empty((len(src_pages), 0))
    return empty, empty


@contextlib.contextmanager
def stubbed_device_layer():
    """Patch the serving modules' device surface with host-only stubs
    (and quiet the resilience/serving loggers, pin the flight-recorder
    dump dir to a tempdir). Every host object constructed inside runs its
    REAL bookkeeping over the stub cache. Every patch is restored on exit,
    also on an exception."""
    import logging

    from ..serving import distributed as dist_mod
    from ..serving import engine as eng_mod
    from ..telemetry import trace as trace_mod
    from ..telemetry.logger import get_logger

    patches = [
        (eng_mod, "make_paged_kv_cache", _stub_make_cache),
        (eng_mod, "prefill_into_cache", _stub_prefill_into_cache),
        (eng_mod, "continue_prefill_into_cache", _stub_continue_prefill_into_cache),
        (eng_mod, "append_kv", _stub_append_kv),
        (eng_mod, "assign_block_table", _stub_assign_block_table),
        (eng_mod, "copy_page", _stub_copy_page),
        (eng_mod, "swap_block_table_page", _stub_swap_block_table_page),
        (eng_mod, "reset_slot", _stub_reset_slot),
        (eng_mod, "gather_kv", _stub_gather_kv),
        (eng_mod, "write_prefill_kv", _stub_write_prefill_kv),
        (eng_mod, "decode_attn_paged", _stub_decode_attn_paged),
        (eng_mod, "cascade_decode_attn", _stub_cascade_decode_attn),
        (eng_mod, "unified_tick_attn", _stub_unified_tick_attn),
        (eng_mod, "resolve_num_splits", _stub_resolve_splits),
        (eng_mod, "resolve_tick_splits", _stub_resolve_splits),
        (dist_mod, "assign_block_table", _stub_assign_block_table),
        (dist_mod, "shard_kv_cache", lambda cache, devices: cache),
        (dist_mod.TieredEngine, "_stream_pages", _stub_stream_pages),
    ]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    loggers = [get_logger(n) for n in ("serving", "resilience", "telemetry")]
    levels = [lg.level for lg in loggers]
    with tempfile.TemporaryDirectory() as tmp, _pinned_env("MAGI_ATTENTION_TRACE_DIR", tmp):
        trace_mod.reset_flight_recorder()
        try:
            for m, n, v in patches:
                setattr(m, n, v)
            for lg in loggers:
                lg.setLevel(logging.ERROR)
            yield
        finally:
            for m, n, v in saved:
                setattr(m, n, v)
            for lg, lv in zip(loggers, levels):
                lg.setLevel(lv)
            trace_mod.reset_flight_recorder()


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def _trie_page_counts(prefix) -> dict[int, int]:
    """Pages the trie currently pins, with multiplicity (one reference
    per full node + one per tail)."""
    counts: dict[int, int] = {}
    if prefix is None:
        return counts
    for node in prefix._nodes.values():
        if node.page >= 0:
            counts[node.page] = counts.get(node.page, 0) + 1
        if node.tail is not None:
            counts[node.tail.page] = counts.get(node.tail.page, 0) + 1
    return counts


def allocator_invariants(alloc, prefix=None, label="") -> list[str]:
    """The page-accounting core: conservation, free/referenced
    disjointness, exact refcount bookkeeping."""
    errs: list[str] = []
    tag = f"[{label}] " if label else ""
    free = list(alloc._free_pages)
    refs = dict(alloc._page_refs)
    if len(set(free)) != len(free):
        errs.append(f"{tag}free list holds a page twice: {sorted(free)}")
    both = set(free) & set(refs)
    if both:
        errs.append(
            f"{tag}page(s) {sorted(both)} simultaneously free and "
            "referenced"
        )
    if len(set(free)) + len(refs) != alloc.num_pages:
        errs.append(
            f"{tag}page conservation broken: {len(set(free))} free + "
            f"{len(refs)} resident != {alloc.num_pages} total"
        )
    oob = [p for p in list(free) + list(refs) if not 0 <= p < alloc.num_pages]
    if oob:
        errs.append(f"{tag}out-of-range page id(s) {sorted(set(oob))}")
    # refcount conservation: sum of owners == tracked refs, per page
    owners: dict[int, int] = {}
    for slot, pages in alloc._slot_pages.items():
        for p in pages:
            owners[p] = owners.get(p, 0) + 1
    for p, n in _trie_page_counts(prefix).items():
        owners[p] = owners.get(p, 0) + n
    for p in set(owners) | set(refs):
        if refs.get(p, 0) != owners.get(p, 0):
            errs.append(
                f"{tag}refcount conservation broken on page {p}: "
                f"tracked refs {refs.get(p, 0)} != "
                f"{owners.get(p, 0)} owners (slots + trie residents)"
            )
    # slot accounting
    free_slots = list(alloc._free_slots)
    live_slots = set(alloc._slot_pages)
    if len(set(free_slots)) != len(free_slots):
        errs.append(f"{tag}free slot list holds a slot twice")
    if set(free_slots) & live_slots:
        errs.append(
            f"{tag}slot(s) {sorted(set(free_slots) & live_slots)} "
            "simultaneously free and allocated"
        )
    if len(set(free_slots)) + len(live_slots) != alloc.max_seqs:
        errs.append(
            f"{tag}slot conservation broken: {len(set(free_slots))} free "
            f"+ {len(live_slots)} live != {alloc.max_seqs}"
        )
    return errs


def engine_invariants(engine, label="") -> list[str]:
    """ServingEngine bookkeeping: no dangling per-slot dicts, the
    host/device length mirror agrees, lengths within reservations."""
    errs = allocator_invariants(
        engine.allocator, getattr(engine, "prefix", None), label
    )
    tag = f"[{label}] " if label else ""
    live = set(engine.allocator._slot_pages)
    for name in ("_lengths", "_priorities", "_tokens", "_slot_prefix"):
        stale = set(getattr(engine, name)) - live
        if stale:
            errs.append(
                f"{tag}{name} holds entries for retired slot(s) "
                f"{sorted(stale)} — a freed sequence left bookkeeping "
                "behind"
            )
    cache = engine.cache
    if isinstance(cache, _StubCache):
        ps = engine.allocator.page_size
        seq_lens = cache.seq_lens.tolist()
        for slot in live:
            dev = seq_lens[slot]
            host = engine._lengths.get(slot, 0)
            if dev != host:
                errs.append(
                    f"{tag}slot {slot}: host length mirror {host} != "
                    f"device seq_lens {dev}"
                )
            cap = len(engine.allocator._slot_pages[slot]) * ps
            if dev > cap:
                errs.append(
                    f"{tag}slot {slot}: {dev} tokens stored beyond the "
                    f"{cap}-token reservation — writes landed on pages "
                    "owned by other sequences"
                )
        for slot in range(cache.max_seqs):
            if slot not in live and seq_lens[slot] != 0:
                errs.append(
                    f"{tag}retired slot {slot} still stores "
                    f"{seq_lens[slot]} tokens"
                )
    return errs


# ---------------------------------------------------------------------------
# canonical-state hashing
# ---------------------------------------------------------------------------


class _Renamer:
    """First-use canonical renaming of opaque ids (pages, sids)."""

    def __init__(self):
        self.map: dict = {}

    def __call__(self, x):
        return self.map.setdefault(x, len(self.map))


def _node_depths(prefix) -> dict:
    """Full pages from the root of each trie node, this one included (the
    port's nodes keep only their parent; the chain key fixes the depth)."""
    depths: dict = {}

    def depth(key):
        if key not in depths:
            node = prefix._nodes[key]
            depths[key] = 0 if node.parent is None else depth(node.parent) + 1
        return depths[key]

    for key in prefix._nodes:
        depth(key)
    return depths


def canon_allocator(alloc, prefix, ren: _Renamer):
    slots = tuple(
        (slot, tuple(ren(p) for p in pages))
        for slot, pages in sorted(alloc._slot_pages.items())
    )
    trie = ()
    if prefix is not None:
        clocks = sorted(
            {n.last_used for n in prefix._nodes.values()}
        )
        rank = {c: i for i, c in enumerate(clocks)}
        depths = _node_depths(prefix)
        trie = tuple(
            sorted(
                (
                    key.hex() if isinstance(key, bytes) else str(key),
                    ren(node.page) if node.page >= 0 else -1,
                    depths[key],
                    rank[node.last_used],
                    (
                        (node.tail.tokens, ren(node.tail.page))
                        if node.tail is not None
                        else None
                    ),
                )
                for key, node in prefix._nodes.items()
            )
        )
    free = tuple(ren(p) for p in reversed(alloc._free_pages))  # pop order
    refs = tuple(sorted((ren(p), r) for p, r in alloc._page_refs.items()))
    free_slots = tuple(reversed(alloc._free_slots))
    return (slots, trie, free, refs, free_slots)


def canon_engine(engine, ren: _Renamer):
    live = set(engine.allocator._slot_pages)
    cache = engine.cache
    stub = isinstance(cache, _StubCache)
    rows = cache.block_tables.tolist() if stub else []
    tables = tuple(
        (s, tuple(ren(p) for p in rows[s][: len(engine.allocator._slot_pages[s])]))
        for s in sorted(live)
    ) if stub else ()
    return (
        canon_allocator(engine.allocator, getattr(engine, "prefix", None),
                        ren),
        tuple(sorted(engine._lengths.items())),
        tuple(sorted(engine._priorities.items())),
        tuple(sorted(engine._tokens.items())),
        tuple(
            sorted(
                (s, tuple(ren(p) for p in pages), n)
                for s, (pages, n) in engine._slot_prefix.items()
            )
        ),
        tuple(cache.seq_lens.tolist()) if stub else (),
        tables,
    )


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Counterexample:
    model: str
    trace: tuple[str, ...]
    violations: tuple[str, ...]

    def render(self) -> str:
        steps = "\n".join(
            f"    {i + 1}. {ev}" for i, ev in enumerate(self.trace)
        ) or "    (initial state)"
        viol = "\n".join(f"    !! {v}" for v in self.violations)
        return (
            f"counterexample [{self.model}] — minimal trace "
            f"({len(self.trace)} event(s)):\n{steps}\n{viol}"
        )


@dataclasses.dataclass
class ExploreResult:
    model: str
    states: int
    transitions: int
    max_depth: int
    counterexamples: list[Counterexample]
    truncated: bool = False

    @property
    def ok(self) -> bool:
        return not self.counterexamples


def explore(
    model,
    *,
    max_depth: int = 6,
    max_states: int = 200_000,
    stop_on_violation: bool = True,
) -> ExploreResult:
    """Breadth-first exhaustive exploration of ``model`` up to
    ``max_depth`` events, deduplicated on the model's canonical state.

    ``model`` provides ``name``, ``initial() -> sys``,
    ``events(sys) -> [label]``, ``apply(sys, label)``,
    ``canon(sys) -> hashable`` and ``check(sys) -> [violation]``.
    States are rebuilt by REPLAYING event paths against a fresh
    ``initial()`` — transitions always execute the real code, and
    breadth-first order makes the first counterexample minimal."""
    from .. import telemetry

    def build(path):
        sys = model.initial()
        for label in path:
            model.apply(sys, label)
        return sys

    result = ExploreResult(
        model=model.name, states=0, transitions=0, max_depth=max_depth,
        counterexamples=[],
    )

    init = build(())
    seen = {model.canon(init)}
    result.states = 1
    v0 = model.check(init)
    if v0:
        result.counterexamples.append(
            Counterexample(model.name, (), tuple(v0))
        )
        if stop_on_violation:
            telemetry.record_analysis_run(result.states, 1)
            return result
    # each frontier entry carries its enabled events, computed when the
    # state was first built — expanding a node then needs no parent
    # replay, halving the replay work of the whole exploration
    frontier: list[tuple[tuple[str, ...], list[str]]] = [
        ((), model.events(init))
    ]
    depth = 0
    while frontier and depth < max_depth and not result.truncated:
        depth += 1
        nxt: list[tuple[tuple[str, ...], list[str]]] = []
        for path, labels in frontier:
            for label in labels:
                child_path = path + (label,)
                child = build(child_path)
                result.transitions += 1
                c = model.canon(child)
                if c in seen:
                    continue
                seen.add(c)
                result.states += 1
                violations = model.check(child)
                if violations:
                    result.counterexamples.append(
                        Counterexample(
                            model.name, child_path, tuple(violations)
                        )
                    )
                    if stop_on_violation:
                        telemetry.record_analysis_run(
                            result.states, len(result.counterexamples)
                        )
                        return result
                nxt.append((child_path, model.events(child)))
                if result.states >= max_states:
                    result.truncated = True
                    break
            if result.truncated:
                break
        frontier = nxt
    telemetry.record_analysis_run(
        result.states, len(result.counterexamples)
    )
    return result


# ---------------------------------------------------------------------------
# model 1: the single-chip engine (allocator + prefix trie + engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Profile:
    """One request shape the models drive (tokens enable the prefix
    trie; None = tokenless admission)."""

    name: str
    tokens: tuple[int, ...] | None
    prompt_len: int
    gen: int
    priority: int = 0


def _default_profiles(page_size: int) -> tuple[_Profile, ...]:
    ps = page_size
    base = tuple(range(100, 100 + ps + 3))  # 1 full page + a partial tail
    return (
        _Profile("A", base, len(base), gen=1),
        # B shares A's full page AND its partial tail prefix, then
        # diverges -> fork + CoW-split surface
        _Profile("B", base + (7, 8), len(base) + 2, gen=1),
        # C: tokenless, higher priority -> the eviction surface
        _Profile("C", None, 2 * ps, gen=1, priority=2),
    )


class EngineModel:
    """ServingEngine + PageAllocator + PrefixCache under the event
    alphabet admit / admit-fault / prefill-chunk / decode / free /
    evict-prefix / drop-prefix."""

    name = "engine"

    def __init__(
        self,
        *,
        num_pages: int = 5,
        page_size: int = 8,
        max_seqs: int = 2,
        max_pages_per_seq: int = 4,
        chunk: int | None = None,
        profiles: Sequence[_Profile] | None = None,
        max_admission_evictions: int = 1,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages_per_seq = max_pages_per_seq
        self.chunk = chunk if chunk is not None else page_size
        self.profiles = tuple(
            profiles if profiles is not None
            else _default_profiles(page_size)
        )
        self.max_admission_evictions = max_admission_evictions

    # -- system construction / events ------------------------------------

    def initial(self):
        from ..serving.engine import ServingEngine

        engine = ServingEngine(
            num_pages=self.num_pages,
            num_kv_heads=2,
            head_dim=4,
            page_size=self.page_size,
            max_seqs=self.max_seqs,
            max_pages_per_seq=self.max_pages_per_seq,
            max_admission_evictions=self.max_admission_evictions,
            dtype=torch.float32,
            device="cpu",
        )
        # model-side request ledger: name -> dict(status, slot, pos, done)
        reqs = {
            p.name: {"status": "idle", "slot": None, "pos": 0, "done": 0}
            for p in self.profiles
        }
        return {"engine": engine, "reqs": reqs}

    def _profile(self, name: str) -> _Profile:
        return next(p for p in self.profiles if p.name == name)

    def events(self, sys) -> list[str]:
        engine, reqs = sys["engine"], sys["reqs"]
        out: list[str] = []
        for p in self.profiles:
            r = reqs[p.name]
            if r["status"] == "idle":
                out.append(f"admit:{p.name}")
                out.append(f"admit_fault:{p.name}")
            elif r["status"] == "active":
                if r["pos"] < p.prompt_len:
                    out.append(f"prefill:{p.name}")
                out.append(f"free:{p.name}")
        decoding = [
            p.name
            for p in self.profiles
            if reqs[p.name]["status"] == "active"
            and reqs[p.name]["pos"] >= p.prompt_len
        ]
        for nm in decoding:  # single-sequence steps
            out.append(f"decode:{nm}")
        if len(decoding) > 1:  # and the batched step (cascade surface)
            out.append("decode:" + "+".join(decoding))
        if engine.prefix is not None and engine.prefix.num_nodes:
            out.append("evict_prefix")
            out.append("drop_prefix")
        return out

    def apply(self, sys, label: str) -> None:
        from ..serving.kv_cache import PageAllocatorError

        engine, reqs = sys["engine"], sys["reqs"]
        kind, _, arg = label.partition(":")
        if kind in ("admit", "admit_fault"):
            p = self._profile(arg)
            ctx = (
                _pinned_chaos("alloc_fail:times=1")
                if kind == "admit_fault"
                else contextlib.nullcontext()
            )
            with ctx:
                res = engine.admit(
                    p.prompt_len, priority=p.priority, tokens=p.tokens
                )
            for victim in res.evicted:
                for q in self.profiles:
                    r = reqs[q.name]
                    if r["status"] == "active" and r["slot"] == victim:
                        r.update(status="idle", slot=None, pos=0, done=0)
            if res.admitted:
                reqs[arg].update(
                    status="active", slot=res.slot, pos=res.prefix_len,
                    done=0,
                )
        elif kind == "prefill":
            p = self._profile(arg)
            r = reqs[arg]
            n = min(self.chunk, p.prompt_len - r["pos"])
            q = torch.zeros((n, 2, 4))
            try:
                engine.prefill(q, q, q, r["slot"])
            except PageAllocatorError:
                return  # transient pressure: state must be untouched
            r["pos"] += n
        elif kind == "decode":
            names = arg.split("+")
            slots = [reqs[nm]["slot"] for nm in names]
            b = len(slots)
            q = torch.zeros((b, 2, 4))
            try:
                engine.decode_step(q, q, q, slots)
            except PageAllocatorError:
                return
            for nm in names:
                reqs[nm]["done"] += 1
        elif kind == "free":
            r = reqs[arg]
            engine.free(r["slot"])
            r.update(status="idle", slot=None, pos=0, done=0)
        elif kind == "evict_prefix":
            engine.prefix.evict(engine.allocator, 1)
        elif kind == "drop_prefix":
            engine.prefix.drop_all(engine.allocator)
        else:  # pragma: no cover - unknown label is a harness bug
            raise AssertionError(f"unknown event {label!r}")

    # -- canon / invariants ----------------------------------------------

    def canon(self, sys):
        ren = _Renamer()
        reqs = tuple(
            (nm, r["status"], r["slot"], r["pos"], r["done"])
            for nm, r in sorted(sys["reqs"].items())
        )
        return (canon_engine(sys["engine"], ren), reqs)

    def check(self, sys) -> list[str]:
        engine, reqs = sys["engine"], sys["reqs"]
        errs = engine_invariants(engine, self.name)
        # every sequence in exactly one lifecycle state: the model's
        # active set and the allocator's live slots must be a bijection
        active_slots = [
            r["slot"] for r in reqs.values() if r["status"] == "active"
        ]
        live = set(engine.allocator._slot_pages)
        if len(set(active_slots)) != len(active_slots):
            errs.append(
                f"[{self.name}] two live requests share slot(s) "
                f"{sorted(s for s in active_slots if active_slots.count(s) > 1)}"
            )
        dangling = [s for s in active_slots if s not in live]
        if dangling:
            errs.append(
                f"[{self.name}] active request(s) hold retired slot(s) "
                f"{sorted(dangling)} — evicted without requeue"
            )
        orphaned = live - set(active_slots)
        if orphaned:
            errs.append(
                f"[{self.name}] allocated slot(s) {sorted(orphaned)} "
                "belong to no live request — leaked reservations"
            )
        # quiescence: nothing live and nothing cached => empty pool
        if not live and (
            engine.prefix is None or engine.prefix.resident_pages == 0
        ):
            if engine.allocator.pages_in_use:
                errs.append(
                    f"[{self.name}] quiescent state leaks "
                    f"{engine.allocator.pages_in_use} page(s)"
                )
        return errs


@contextlib.contextmanager
def _pinned_chaos(spec: str):
    from ..resilience import chaos

    with _pinned_env("MAGI_ATTENTION_CHAOS", spec):
        chaos.reset_chaos()
        try:
            yield
        finally:
            chaos.reset_chaos()


# ---------------------------------------------------------------------------
# model 2: scheduler over one engine (the dangling-victim surface)
# ---------------------------------------------------------------------------


class SchedulerModel:
    """Scheduler + ServingEngine: events submit / tick. The tick runs
    the real admission (priority eviction included), decode-first step
    and prefill-chunk loop; invariants cross-check the scheduler's
    request table against the engine's allocator."""

    name = "scheduler"

    def __init__(
        self,
        *,
        num_pages: int = 4,
        page_size: int = 8,
        max_seqs: int = 3,
        max_pages_per_seq: int = 4,
        token_budget: int = 24,
        chunk: int = 8,
        profiles: Sequence[_Profile] | None = None,
        max_admission_evictions: int = 1,
    ):
        ps = page_size
        self.cfg = dict(
            num_pages=num_pages, page_size=page_size, max_seqs=max_seqs,
            max_pages_per_seq=max_pages_per_seq,
            max_admission_evictions=max_admission_evictions,
        )
        self.token_budget = token_budget
        self.chunk = chunk
        self.profiles = tuple(
            profiles
            if profiles is not None
            else (
                _Profile("A", None, ps, gen=1, priority=0),
                _Profile("B", None, ps, gen=1, priority=0),
                # C needs the whole pool (gen=0 keeps it inside one
                # sequence's capacity); with the eviction budget at 1
                # its admission attempt can evict a victim yet still fail
                _Profile("C", None, 4 * ps, gen=0, priority=2),
            )
        )

    def initial(self):
        from ..serving.engine import ServingEngine
        from ..serving.scheduler import Scheduler

        engine = ServingEngine(num_kv_heads=2, head_dim=4, dtype=torch.float32, device="cpu",
                               **self.cfg)
        clock = _CountingClock()
        sched = Scheduler(
            engine, token_budget=self.token_budget, chunk=self.chunk,
            clock=clock,
        )
        return {"sched": sched, "engine": engine, "submitted": set()}

    def events(self, sys) -> list[str]:
        out = []
        for i, p in enumerate(self.profiles):
            if p.name not in sys["submitted"]:
                out.append(f"submit:{p.name}")
        if not sys["sched"].done:
            out.append("tick")
        return out

    def apply(self, sys, label: str) -> None:
        from ..serving.scheduler import Request

        kind, _, arg = label.partition(":")
        if kind == "submit":
            p = next(q for q in self.profiles if q.name == arg)
            rid = list(self.profiles).index(p)
            h, d = 2, 4
            prompt, gen = torch.zeros((p.prompt_len, h, d)), torch.zeros((p.gen, h, d))
            req = Request(
                rid=rid,
                prompt_q=prompt,
                prompt_k=prompt,
                prompt_v=prompt,
                decode_q=gen,
                decode_k=gen,
                decode_v=gen,
                tokens=p.tokens,
                max_new_tokens=p.gen,
                priority=p.priority,
                trace_id=f"lc-{p.name}",
            )
            sys["sched"].submit(req)
            sys["submitted"].add(p.name)
        elif kind == "tick":
            sys["sched"].step()
        else:  # pragma: no cover
            raise AssertionError(f"unknown event {label!r}")

    def canon(self, sys):
        sched = sys["sched"]
        ren = _Renamer()
        queue = tuple(st.rid for st in sched._queue)
        active = tuple(
            sorted(
                (st.rid, st.status, st.slot, st.prefill_pos,
                 st.tokens_done, st.evictions)
                for st in sched._active.values()
            )
        )
        finished = tuple(sorted(
            (rid, st.status) for rid, st in sched._finished.items()
        ))
        return (
            canon_engine(sys["engine"], ren),
            queue,
            active,
            finished,
            tuple(sorted(sys["submitted"])),
        )

    def check(self, sys) -> list[str]:
        sched, engine = sys["sched"], sys["engine"]
        errs = engine_invariants(engine, self.name)
        live = set(engine.allocator._slot_pages)
        seen_rids: set[int] = set()
        for st in sched._active.values():
            seen_rids.add(st.rid)
            if st.slot not in live:
                errs.append(
                    f"[{self.name}] active request {st.rid} holds "
                    f"retired slot {st.slot} — an eviction victim was "
                    "never requeued (it will never be stepped again)"
                )
        for st in sched._queue:
            if st.rid in seen_rids:
                errs.append(
                    f"[{self.name}] request {st.rid} is queued AND "
                    "active"
                )
            if st.slot is not None:
                errs.append(
                    f"[{self.name}] queued request {st.rid} still holds "
                    f"slot {st.slot}"
                )
        for rid in sched._finished:
            if rid in seen_rids:
                errs.append(
                    f"[{self.name}] request {rid} is finished AND active"
                )
        active_slots = [st.slot for st in sched._active.values()]
        orphaned = live - set(active_slots)
        if orphaned:
            errs.append(
                f"[{self.name}] allocated slot(s) {sorted(orphaned)} "
                "belong to no scheduled request"
            )
        if sched.done:
            if engine.allocator.active_seqs:
                errs.append(
                    f"[{self.name}] scheduler drained but "
                    f"{engine.allocator.active_seqs} sequence(s) remain "
                    "allocated"
                )
            if engine.prefix is not None and (
                engine.prefix.resident_pages == 0
                and engine.allocator.pages_in_use
            ):
                errs.append(
                    f"[{self.name}] quiescent pool leaks "
                    f"{engine.allocator.pages_in_use} page(s)"
                )
        return errs


class _CountingClock:
    """Deterministic monotonic clock for replayed scheduler runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# model 3: the tiered (disaggregated) engine + scheduler
# ---------------------------------------------------------------------------


class TieredModel(SchedulerModel):
    """TieredScheduler over a TieredEngine (1 prefill chip + dp decode
    replicas): adds the page-stream and decode-fault events to the
    scheduler alphabet, and checks the sid<->tier-slot bijection plus
    stream-queue conservation on top of the per-tier allocator
    invariants."""

    name = "tiered"

    def __init__(
        self,
        *,
        num_pages: int = 4,
        page_size: int = 8,
        max_seqs: int = 2,
        max_pages_per_seq: int = 4,
        dp: int = 2,
        prefill_budget: int = 16,
        decode_budget: int = 8,
        chunk: int = 8,
        profiles: Sequence[_Profile] | None = None,
        stream_queue_max: int = 2,
    ):
        ps = page_size
        self.cfg = dict(
            num_pages=num_pages, page_size=page_size, max_seqs=max_seqs,
            max_pages_per_seq=max_pages_per_seq,
        )
        self.dp = dp
        self.prefill_budget = prefill_budget
        self.decode_budget = decode_budget
        self.chunk = chunk
        self.stream_queue_max = stream_queue_max
        self.profiles = tuple(
            profiles
            if profiles is not None
            else (
                _Profile("A", None, ps, gen=2, priority=0),
                _Profile("B", None, 2 * ps, gen=1, priority=1),
            )
        )

    def initial(self):
        from ..serving.distributed import TieredEngine, TieredScheduler

        engine = TieredEngine(
            num_kv_heads=2,
            head_dim=4,
            mesh_spec={
                "prefill": 1, "decode_dp": self.dp, "decode_tp": 1,
            },
            devices=["cpu"] * (1 + self.dp),
            dtype=torch.float32,
            stream_queue_max=self.stream_queue_max,
            **self.cfg,
        )
        sched = TieredScheduler(
            engine,
            prefill_budget=self.prefill_budget,
            decode_budget=self.decode_budget,
            chunk=self.chunk,
            clock=_CountingClock(),
        )
        return {"sched": sched, "engine": engine, "submitted": set()}

    def events(self, sys) -> list[str]:
        out = super().events(sys)
        sched = sys["sched"]
        decoding = [
            st for st in sched._active.values()
            if st.status == "decoding" and sys["engine"].placed(st.slot)
        ]
        if decoding:
            out.append("tick_fault")  # a decode chip dies mid-step
        return out

    def apply(self, sys, label: str) -> None:
        if label == "tick_fault":
            with _pinned_chaos("decode_fault:times=1"):
                sys["sched"].step()
            return
        super().apply(sys, label)

    def canon(self, sys):
        sched, engine = sys["sched"], sys["engine"]
        ren = _Renamer()
        seq = tuple(
            sorted(
                (sid, rec["stage"], rec["pslot"], rec["replica"],
                 rec["dslot"], rec["expected"], rec["priority"])
                for sid, rec in engine._seq.items()
            )
        )
        tiers = (canon_engine(engine._prefill, ren),) + tuple(
            canon_engine(r.engine, _Renamer()) for r in engine.replicas
        )
        pending = tuple(p.sid for p in engine._pending)
        restarts = tuple(r.restarts for r in engine.replicas)
        queue = tuple(st.rid for st in sched._queue)
        active = tuple(
            sorted(
                (st.rid, st.status, st.slot, st.prefill_pos,
                 st.tokens_done, st.evictions)
                for st in sched._active.values()
            )
        )
        finished = tuple(sorted(sched._finished))
        return (seq, tiers, pending, restarts, queue, active, finished,
                tuple(sorted(sys["submitted"])))

    def check(self, sys) -> list[str]:
        sched, engine = sys["sched"], sys["engine"]
        errs: list[str] = []
        errs += engine_invariants(engine._prefill, "tiered/prefill")
        for r in engine.replicas:
            errs += engine_invariants(
                r.engine, f"tiered/decode{r.index}"
            )
        # sid <-> tier slot bijection
        prefill_live = set(engine._prefill.allocator._slot_pages)
        used_p: set[int] = set()
        used_d: set[tuple[int, int]] = set()
        for sid, rec in engine._seq.items():
            if rec["stage"] in ("prefill", "stream_queued"):
                if rec["pslot"] not in prefill_live:
                    errs.append(
                        f"[tiered] sid {sid} ({rec['stage']}) maps to "
                        f"retired prefill slot {rec['pslot']}"
                    )
                if rec["pslot"] in used_p:
                    errs.append(
                        f"[tiered] prefill slot {rec['pslot']} owned by "
                        "two sids"
                    )
                used_p.add(rec["pslot"])
            elif rec["stage"] == "decode":
                rep = engine.replicas[rec["replica"]]
                if rec["dslot"] not in rep.engine.allocator._slot_pages:
                    errs.append(
                        f"[tiered] sid {sid} maps to retired decode "
                        f"slot {rec['dslot']} on replica {rec['replica']}"
                    )
                key = (rec["replica"], rec["dslot"])
                if key in used_d:
                    errs.append(
                        f"[tiered] decode slot {key} owned by two sids"
                    )
                used_d.add(key)
            else:
                errs.append(
                    f"[tiered] sid {sid} in unknown stage "
                    f"{rec['stage']!r}"
                )
        orphaned_p = prefill_live - used_p
        if orphaned_p:
            errs.append(
                f"[tiered] prefill slot(s) {sorted(orphaned_p)} belong "
                "to no sid"
            )
        for r in engine.replicas:
            orphaned_d = set(r.engine.allocator._slot_pages) - {
                d for (ri, d) in used_d if ri == r.index
            }
            if orphaned_d:
                errs.append(
                    f"[tiered] decode replica {r.index} slot(s) "
                    f"{sorted(orphaned_d)} belong to no sid"
                )
        # stream-queue conservation
        pend = [p.sid for p in engine._pending]
        if len(set(pend)) != len(pend):
            errs.append("[tiered] a stream is parked twice")
        if len(pend) > engine.stream_queue_max:
            errs.append(
                f"[tiered] stream queue over its bound: {len(pend)} > "
                f"{engine.stream_queue_max}"
            )
        for sid in pend:
            rec = engine._seq.get(sid)
            if rec is None or rec["stage"] != "stream_queued":
                errs.append(
                    f"[tiered] parked stream for sid {sid} whose stage "
                    f"is {rec['stage'] if rec else 'gone'}"
                )
        for sid, rec in engine._seq.items():
            if rec["stage"] == "stream_queued" and sid not in pend:
                errs.append(
                    f"[tiered] sid {sid} is stream_queued but no stream "
                    "is parked"
                )
        # scheduler cross-check: active slots are known LIVE sids
        for st in sched._active.values():
            if st.slot not in engine._seq:
                errs.append(
                    f"[tiered] active request {st.rid} holds unknown "
                    f"sid {st.slot} — a fault/eviction victim was never "
                    "requeued"
                )
        # per-tier budget >= 0 by construction of the config; assert
        # the configured budgets were not driven negative
        if sched.prefill_budget < 0 or sched.decode_budget < 0:
            errs.append("[tiered] negative tier budget")
        if sched.done and not engine._pending:
            for r in engine.replicas:
                if r.engine.allocator.pages_in_use:
                    errs.append(
                        f"[tiered] drained scheduler leaks "
                        f"{r.engine.allocator.pages_in_use} page(s) on "
                        f"decode replica {r.index}"
                    )
            pre = engine._prefill
            if (
                pre.prefix is None or pre.prefix.resident_pages == 0
            ) and pre.allocator.pages_in_use:
                errs.append(
                    f"[tiered] drained scheduler leaks "
                    f"{pre.allocator.pages_in_use} page(s) on the "
                    "prefill tier"
                )
        return errs


# ---------------------------------------------------------------------------
# replanted historical bugs (mutation self-tests)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def planted_double_free():
    """The pre-refcount allocator retire path: pages go straight back to
    the free list with no refcount decrement — a page still pinned by
    the prefix trie (or a sibling fork) is handed out again. The
    checker must find this with a short admit -> prefill(commit) ->
    free trace."""
    from ..serving.kv_cache import InvalidFreeError, PageAllocator

    orig = PageAllocator.free

    def bad_free(self, slot):
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise InvalidFreeError(f"slot {slot} not allocated")
        del self._slot_pages[slot]
        for p in reversed(pages):
            self._page_refs.pop(p, None)  # the skipped decrement
            self._free_pages.append(p)  # freed even while shared
        self._free_slots.append(slot)

    PageAllocator.free = bad_free
    try:
        yield
    finally:
        PageAllocator.free = orig


@contextlib.contextmanager
def planted_dangling_eviction():
    """A ``Scheduler._admit_queued`` that requeues eviction victims only
    when the admission ultimately SUCCEEDS: a bounded evict-then-give-up
    pass leaves its victims dangling in ``_active`` with slots the engine
    already released."""
    from ..serving import scheduler as sched_mod
    from ..telemetry import trace as reqtrace

    orig = sched_mod.Scheduler._admit_queued

    def bad_admit_queued(self):
        admitted, rejected = [], []
        for st in self._admission_order():
            req = st.request
            with reqtrace.request_context(st.trace_id, st.rid):
                res = self.engine.admit(
                    req.prompt_len,
                    priority=req.priority,
                    tokens=req.tokens,
                )
            if not res.admitted:
                # the pre-fix bug: res.evicted is dropped on this path
                if res.reason == "too_long":
                    st.status = sched_mod.REJECTED
                    self._queue.remove(st)
                    self._finished[st.rid] = st
                    rejected.append(st.rid)
                    continue
                break
            for victim_slot in res.evicted:
                self._handle_eviction(victim_slot)
            st.slot = res.slot
            st.prefix_len = res.prefix_len
            st.prefill_pos = res.prefix_len
            st.admitted_at = self._clock()
            st.status = sched_mod.PREFILLING
            self._queue.remove(st)
            self._active[st.rid] = st
            admitted.append(st.rid)
        return admitted, rejected

    sched_mod.Scheduler._admit_queued = bad_admit_queued
    try:
        yield
    finally:
        sched_mod.Scheduler._admit_queued = orig


# ---------------------------------------------------------------------------
# CLI entry points
# ---------------------------------------------------------------------------


def _rich_profiles(ps: int) -> tuple[_Profile, ...]:
    """Four request shapes spanning the whole event surface: a trie
    registrant, a fork that diverges past the shared tail (CoW), a
    high-priority evictor, and a tokenless multi-step decoder."""
    base = tuple(range(100, 100 + ps + 3))
    return (
        _Profile("A", base, len(base), gen=1),
        _Profile("B", base + (7, 8), len(base) + 2, gen=1),
        _Profile("C", None, 2 * ps, gen=1, priority=2),
        _Profile("D", None, ps, gen=2, priority=1),
    )


def default_models(*, smoke: bool = False):
    """The checked model suite; ``smoke`` keeps the default test tier
    fast (the full-depth matrix runs in the CLI's lifecycle pass)."""
    if smoke:
        return [
            (EngineModel(), dict(max_depth=4)),
            (SchedulerModel(), dict(max_depth=4)),
            (TieredModel(), dict(max_depth=4)),
        ]
    ps = 8
    return [
        # the wide config: 4 request shapes x 3 slots x 6 pages at
        # sub-page chunking — the bulk of the canonical state count
        (
            EngineModel(
                num_pages=6, max_seqs=3, profiles=_rich_profiles(ps),
                chunk=4,
            ),
            dict(max_depth=10),
        ),
        # the deep config: 2 slots force constant eviction/recycle
        (EngineModel(), dict(max_depth=12)),
        (SchedulerModel(), dict(max_depth=8)),
        (
            SchedulerModel(
                max_seqs=3, num_pages=5, token_budget=12, chunk=4
            ),
            dict(max_depth=10),
        ),
        (TieredModel(chunk=4, prefill_budget=8), dict(max_depth=10)),
    ]


def run_lifecycle_check(
    *, smoke: bool = False, max_states: int = 200_000
) -> tuple[list[str], dict]:
    """Explore the clean tree; any counterexample is a gate failure.
    Returns (errors, report with per-model state counts)."""
    errors: list[str] = []
    report: dict = {}
    with stubbed_device_layer():
        for i, (model, opts) in enumerate(default_models(smoke=smoke)):
            res = explore(model, max_states=max_states, **opts)
            report[f"{i}:{model.name}"] = {
                "states": res.states,
                "transitions": res.transitions,
                "max_depth": res.max_depth,
                "truncated": res.truncated,
            }
            for cex in res.counterexamples:
                errors.append(cex.render())
    return errors, report


def run_mutation_self_test(*, max_len: int = 8) -> list[str]:
    """Both replanted historical bugs must be found, each with a
    counterexample no longer than ``max_len`` events."""
    errors: list[str] = []
    with stubbed_device_layer():
        with planted_double_free():
            res = explore(EngineModel(), max_depth=6)
        if res.ok:
            errors.append(
                "self-test: planted double-free (the pre-refcount "
                "allocator) was NOT caught"
            )
        elif len(res.counterexamples[0].trace) > max_len:
            errors.append(
                "self-test: double-free counterexample not minimal "
                f"({len(res.counterexamples[0].trace)} > {max_len} "
                "events)"
            )
        with planted_dangling_eviction():
            res = explore(SchedulerModel(), max_depth=8)
        if res.ok:
            errors.append(
                "self-test: planted dangling-eviction (victims dropped "
                "on a failed admission) was NOT caught"
            )
        elif len(res.counterexamples[0].trace) > max_len:
            errors.append(
                "self-test: dangling-eviction counterexample not "
                f"minimal ({len(res.counterexamples[0].trace)} > "
                f"{max_len} events)"
            )
    return errors
