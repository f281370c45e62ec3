"""Shared-prefix serving in the port against the JAX package's
``serving/prefix.py`` and ``ServingEngine``, on the CPU.

- The trie: the same token streams through both ``PrefixCache``s over
  their own ``PageAllocator``s give identical page ids, match lengths,
  eviction counts and LRU order (the allocators' free lists stay equal).
- ``plan_cascade_groups`` gives identical groups; ``cascade_decode_attn``
  raises the two named ``ValueError``s.
- The engine: the same prompts and ``tokens=`` through the port's engine
  and JAX's (jnp backend, float32): forks share pages with equal allocator
  state; a copy-on-write split on a mid-page write leaves the registrant's
  page unchanged; a hit's prefill rows equal the same rows of a one-shot
  prefill; cascade ``auto``/``on`` equal ``off`` over three decode steps;
  every output equals JAX's. All within the float32 row of
  ``DEFAULT_BUDGETS`` on positive ``v``.

Token ids map to K/V through a fixed embedding table, so equal tokens mean
equal cached KV, as in JAX ``tests/test_serving/test_prefix.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.serving import PageAllocator as JaxAllocator
from magiattention_tpu.serving import PrefixCache as JaxPrefixCache
from magiattention_tpu.serving import ServingEngine as JaxEngine
from magiattention_tpu.serving import plan_cascade_groups as jax_plan_cascade_groups
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch import env
from magiattention_tpu_torch.serving import (
    CascadeGroup,
    PageAllocator,
    PrefixCache,
    ServingEngine,
    assign_block_table,
    cascade_decode_attn,
    copy_page,
    make_paged_kv_cache,
    plan_cascade_groups,
    swap_block_table_page,
)

D, HK, HQ, PS = 16, 2, 4, 8
VOCAB = 50
BUDGET = DEFAULT_BUDGETS["float32"]

_rng0 = np.random.default_rng(7)
EMB_K = _rng0.standard_normal((VOCAB, HK, D)).astype(np.float32)
EMB_V = _rng0.uniform(0.5, 1.5, (VOCAB, HK, D)).astype(np.float32)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "jnp")
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "2")
    for name in ("MAGI_ATTENTION_CASCADE", "MAGI_ATTENTION_PREFILL_CHUNK"):
        monkeypatch.delenv(name, raising=False)


def _within(ref, got, where, ref_lse=None, got_lse=None):
    report = divergence_report(
        np.asarray(ref), np.asarray(got),
        ref_lse=None if ref_lse is None else np.asarray(ref_lse),
        test_lse=None if got_lse is None else np.asarray(got_lse),
    )
    assert_within_budget(report, BUDGET, where=where)


# -- the trie ---------------------------------------------------------------------


def _trie_script(rng):
    """A stream of trie operations over overlapping prompts: registrations
    (aligned and with tails), matches, frees, evictions."""
    base = list(rng.integers(0, VOCAB, 3 * PS + 5))
    other = list(rng.integers(0, VOCAB, 2 * PS))
    prompts = [
        base,
        base[: 2 * PS] + list(rng.integers(0, VOCAB, PS + 2)),
        other,
        base + list(rng.integers(0, VOCAB, 4)),
        other[:PS] + list(rng.integers(0, VOCAB, PS)),
    ]
    ops = []
    for i, p in enumerate(prompts):
        ops += [("match", p), ("admit_register", p)]
        if i % 2:
            ops.append(("free", i - 1))
    ops += [("match", base), ("evict", 2), ("match", other), ("evict", 3), ("free", 4),
            ("evict", 100), ("drop_all", None)]
    return ops


def _run_trie(alloc, trie, ops):
    log, slots = [], []
    for op, arg in ops:
        if op == "match":
            m = trie.match(arg)
            log.append(("match", tuple(int(p) for p in m.pages), m.length, m.full_pages))
        elif op == "admit_register":
            m = trie.match(arg)
            if m.hit:
                slot, pages = alloc.fork(m.pages, len(arg))
            else:
                slot, pages = alloc.allocate(len(arg))
            slots.append(slot)
            log.append(("register", list(pages), trie.register(arg, pages, alloc)))
        elif op == "free":
            alloc.free(slots[arg])
            log.append(("free", alloc.pages_in_use))
        elif op == "evict":
            log.append(("evict", trie.evict(alloc, arg)))
        else:
            log.append(("drop_all", trie.drop_all(alloc)))
        log.append(("state", trie.resident_pages, trie.num_nodes, alloc.pages_in_use,
                    alloc.shared_pages, list(alloc._free_pages)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trie_matches_jax(seed):
    ops = _trie_script(np.random.default_rng(seed))
    args = dict(num_pages=40, page_size=PS, max_seqs=8, max_pages_per_seq=8)
    got = _run_trie(PageAllocator(**args), PrefixCache(PS), ops)
    ref = _run_trie(JaxAllocator(**args), JaxPrefixCache(PS), ops)
    assert got == ref


def test_trie_eviction_is_lru_and_ref_safe():
    alloc = PageAllocator(num_pages=16, page_size=PS, max_seqs=4, max_pages_per_seq=8)
    trie = PrefixCache(PS)
    s_a, pg_a = alloc.allocate(2 * PS)
    trie.register(list(range(2 * PS)), pg_a, alloc)
    s_b, pg_b = alloc.allocate(2 * PS)
    trie.register(list(range(100, 100 + 2 * PS)), pg_b, alloc)
    alloc.free(s_b)  # branch B now held by the trie alone
    trie.match(list(range(2 * PS)))  # touch A: B is older and unshared
    assert trie.evict(alloc, 10) == 2  # B dropped, A kept (its slot holds it)
    assert trie.match(list(range(100, 100 + 2 * PS))).length == 0
    assert trie.match(list(range(2 * PS))).length == 2 * PS
    alloc.free(s_a)
    assert trie.evict(alloc, 10) == 2 and alloc.pages_in_use == 0


# -- cascade grouping and its errors ------------------------------------------------------


@pytest.mark.parametrize("min_group", [1, 2, 3])
def test_plan_cascade_groups_matches_jax(min_group):
    rng = np.random.default_rng(min_group)
    keys = [((4, 5), 2 * PS), ((7,), PS), ((4, 5, 9), 3 * PS), ((), 0)]
    prefixes = {s: keys[int(rng.integers(0, len(keys)))] for s in range(12)}
    batch = [int(s) for s in rng.permutation(14)[:10]]
    got = plan_cascade_groups(prefixes, batch, min_group=min_group)
    ref = jax_plan_cascade_groups(prefixes, batch, min_group=min_group)
    assert [(g.shared_pages, g.prefix_len, g.members) for g in got] == [
        (g.shared_pages, g.prefix_len, g.members) for g in ref]


def _tiny_cache(slots_pages):
    cache = make_paged_kv_cache(8, PS, HK, D, max_seqs=4, max_pages_per_seq=4,
                                dtype=torch.float32, device="cpu")
    for slot, pages in enumerate(slots_pages):
        assign_block_table(cache, slot, pages, keep_len=len(pages) * PS)
    return cache


def test_cascade_overlapping_groups_raise_named_value_error():
    cache = _tiny_cache([[1], [2], [3]])
    groups = [CascadeGroup((1,), PS, (0, 1)), CascadeGroup((2,), PS, (1, 2))]
    with pytest.raises(ValueError, match=r"overlapping cascade groups.*\[1\]"):
        cascade_decode_attn(torch.zeros((3, HQ, D)), cache, [0, 1, 2], groups)


def test_cascade_misaligned_prefix_raises_value_error():
    cache = _tiny_cache([[1, 2], [1, 2]])
    q = torch.zeros((2, HQ, D))
    for bad in (CascadeGroup((1,), PS + 3, (0, 1)), CascadeGroup((), 0, (0, 1))):
        with pytest.raises(ValueError, match="misaligned cascade group"):
            cascade_decode_attn(q, cache, [0, 1], [bad])


def test_copy_page_and_swap_are_in_place():
    cache = _tiny_cache([[1, 2]])
    cache.k_pages[1] = 3.0
    cache.v_pages[1] = 4.0
    copy_page(cache, 1, 5)
    swap_block_table_page(cache, 0, 0, 5)
    assert bool((cache.k_pages[5] == 3.0).all()) and bool((cache.v_pages[5] == 4.0).all())
    assert cache.block_tables[0].tolist() == [5, 2, 0, 0] and int(cache.seq_lens[0]) == 2 * PS


# -- the engine, port against JAX ---------------------------------------------------------


def _engines(num_pages=48, mpp=12, max_seqs=6):
    kw = dict(num_pages=num_pages, num_kv_heads=HK, head_dim=D, page_size=PS,
              max_seqs=max_seqs, max_pages_per_seq=mpp)
    return (ServingEngine(**kw, dtype=torch.float32, device="cpu"),
            JaxEngine(**kw, dtype=jnp.float32))


def _kv(tokens):
    idx = np.asarray(tokens, np.int64)
    return EMB_K[idx], EMB_V[idx]


class Pair:
    """The port's engine and JAX's, driven with the same calls; each call
    returns both results."""

    def __init__(self, **kw):
        self.port, self.jax = _engines(**kw)

    def admit(self, tokens):
        a = self.port.admit(len(tokens), tokens=tokens)
        b = self.jax.admit(len(tokens), tokens=tokens)
        assert (a.admitted, a.slot, a.reason, a.prefix_len) == (
            b.admitted, b.slot, b.reason, b.prefix_len)
        return a

    def prefill(self, slot, tokens, q):
        k, v = _kv(tokens)
        po, pl = self.port.prefill(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), slot)
        jo, jl = self.jax.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slot)
        return (po.numpy(), pl.numpy()), (np.asarray(jo), np.asarray(jl))

    def decode(self, q, tokens, slots, cascade):
        k, v = _kv(tokens)
        po, pl = self.port.decode_step(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), slots, cascade=cascade)
        jo, jl = self.jax.decode_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slots,
                                      cascade=cascade)
        return (po.numpy(), pl.numpy()), (np.asarray(jo), np.asarray(jl))

    def assert_same_state(self):
        pa, ja = self.port.allocator, self.jax.allocator
        assert pa.pages_in_use == ja.pages_in_use and pa.shared_pages == ja.shared_pages
        assert pa._slot_pages == ja._slot_pages and pa._page_refs == ja._page_refs
        assert self.port.prefix.resident_pages == self.jax.prefix.resident_pages
        assert self.port._slot_prefix == self.jax._slot_prefix
        np.testing.assert_array_equal(self.port.cache.block_tables.numpy(),
                                      np.asarray(self.jax.cache.block_tables))
        np.testing.assert_array_equal(self.port.cache.seq_lens.numpy(),
                                      np.asarray(self.jax.cache.seq_lens))


def _prompts(rng, prefix_len, suffixes):
    prefix = [int(t) for t in rng.integers(0, VOCAB, prefix_len)]
    return prefix, [prefix + [int(t) for t in rng.integers(0, VOCAB, n)] for n in suffixes]


def _serve(pair, rng, prompts, monkeypatch, chunk=None):
    """Admit and prefill each prompt (its suffix after a hit) on both
    engines, the last one in ``chunk``-token chunks; returns the admissions
    and the port's prefill rows."""
    results, rows = [], []
    for i, p in enumerate(prompts):
        res = pair.admit(p)
        assert res.admitted
        suffix = p[res.prefix_len:]
        q = rng.standard_normal((len(suffix), HQ, D)).astype(np.float32)
        if chunk is not None and i == len(prompts) - 1:
            monkeypatch.setenv("MAGI_ATTENTION_PREFILL_CHUNK", str(chunk))
        (po, pl), (jo, jl) = pair.prefill(res.slot, suffix, q)
        monkeypatch.delenv("MAGI_ATTENTION_PREFILL_CHUNK", raising=False)
        _within(jo, po, f"prefill {i}", jl, pl)
        pair.assert_same_state()
        results.append(res)
        rows.append((q, po, pl))
    return results, rows


@pytest.mark.parametrize("prefix_len", [3 * PS, 3 * PS + 3], ids=["aligned", "tail"])
def test_engine_fork_shares_pages_as_jax(prefix_len, monkeypatch):
    rng = np.random.default_rng(prefix_len)
    pair = Pair()
    prefix, prompts = _prompts(rng, prefix_len, [5, 2 * PS + 1, 11])
    results, _ = _serve(pair, rng, [prefix] + prompts, monkeypatch, chunk=PS)
    assert results[0].prefix_len == 0
    assert all(r.prefix_len == len(prefix) for r in results[1:])
    full = prefix_len // PS
    first = pair.port.allocator.slot_pages(results[0].slot)[:full]
    for r in results[1:]:
        assert pair.port.allocator.slot_pages(r.slot)[:full] == first
    # the shared full pages are resident once: a flat engine holds them per prompt
    flat = sum(math.ceil(len(p) / PS) for p in [prefix] + prompts)
    assert pair.port.allocator.pages_in_use == flat - 3 * full


def test_cow_split_leaves_the_registrants_page_unchanged(monkeypatch):
    rng = np.random.default_rng(12)
    pair = Pair()
    prefix, prompts = _prompts(rng, PS + 3, [3])
    r0 = pair.admit(prefix)
    pair.prefill(r0.slot, prefix, rng.standard_normal((len(prefix), HQ, D)).astype(np.float32))
    tail = pair.port.allocator.slot_pages(r0.slot)[1]
    assert pair.port.allocator.page_ref(tail) == 2  # the slot and the trie
    before = pair.port.cache.k_pages[tail].clone(), pair.port.cache.v_pages[tail].clone()
    r1 = pair.admit(prompts[0])
    assert r1.prefix_len == len(prefix)
    pair.prefill(r1.slot, prompts[0][len(prefix):],
                 rng.standard_normal((3, HQ, D)).astype(np.float32))
    pair.assert_same_state()
    p1 = pair.port.allocator.slot_pages(r1.slot)
    assert p1[0] == pair.port.allocator.slot_pages(r0.slot)[0] and p1[1] != tail
    assert torch.equal(pair.port.cache.k_pages[tail], before[0])
    assert torch.equal(pair.port.cache.v_pages[tail], before[1])
    # the fork's private copy holds the prefix tail, then its own tokens
    k_pref, _ = _kv(prefix[PS:] + prompts[0][len(prefix):])
    np.testing.assert_array_equal(pair.port.cache.k_pages[p1[1], : 6].numpy(), k_pref)


def test_hit_rows_equal_one_shot_prefill(monkeypatch):
    """A fork's suffix rows (continuation over the shared history) equal
    the same rows of the whole prompt prefilled in one shot."""
    rng = np.random.default_rng(21)
    pair = Pair()
    prefix, prompts = _prompts(rng, 2 * PS + 5, [13, 2 * PS])
    results, rows = _serve(pair, rng, [prefix] + prompts, monkeypatch, chunk=PS)
    solo, _ = _engines()
    for p, res, (q_suffix, po, pl) in zip(prompts, results[1:], rows[1:]):
        q_full = np.concatenate(
            [rng.standard_normal((res.prefix_len, HQ, D)).astype(np.float32), q_suffix])
        k, v = _kv(p)
        slot = solo.admit(len(p)).slot
        out, lse = solo.prefill(torch.from_numpy(q_full), torch.from_numpy(k),
                                torch.from_numpy(v), slot)
        _within(out[res.prefix_len:].numpy(), po, "hit vs one shot",
                lse[res.prefix_len:].numpy(), pl)


def test_cascade_equals_flat_and_jax(monkeypatch):
    """Three decode steps per mode on one state each: cascade ``auto`` and
    ``on`` against ``off``, and each against JAX's engine in the same mode."""
    outs = {}
    for mode in ("off", "auto", "on"):
        rng = np.random.default_rng(31)
        pair = Pair()
        prefix, prompts = _prompts(rng, 3 * PS + 2, [3, 7, 2 * PS])
        lone = [int(t) for t in rng.integers(0, VOCAB, 9)]
        results, _ = _serve(pair, rng, [prefix, *prompts, lone], monkeypatch)
        slots = [r.slot for r in results]
        steps = []
        for step in range(3):
            q = rng.standard_normal((len(slots), HQ, D)).astype(np.float32)
            toks = [int(t) for t in rng.integers(0, VOCAB, len(slots))]
            (po, pl), (jo, jl) = pair.decode(q, toks, slots, mode)
            _within(jo, po, f"{mode} step {step} vs jax", jl, pl)
            pair.assert_same_state()
            steps.append((po, pl))
        outs[mode] = steps
    for mode in ("auto", "on"):
        for step, ((po, pl), (fo, fl)) in enumerate(zip(outs[mode], outs["off"])):
            _within(fo, po, f"{mode} vs off step {step}", fl, pl)


def test_cascade_modes_pick_groups(monkeypatch):
    """``auto`` cascades only a real group, ``on`` singletons too, and the
    env and ``cascade_override`` choose when the caller does not."""
    calls = []
    import magiattention_tpu_torch.serving.engine as eng_mod

    real = eng_mod.cascade_decode_attn
    monkeypatch.setattr(eng_mod, "cascade_decode_attn",
                        lambda *a, **k: calls.append(len(a[3])) or real(*a, **k))
    rng = np.random.default_rng(41)
    port, _ = _engines()
    prefix = [int(t) for t in rng.integers(0, VOCAB, 2 * PS)]
    slots = []
    for p in (prefix, prefix + [1, 2], [3] * 5):
        res = port.admit(len(p), tokens=p)
        k, v = _kv(p[res.prefix_len:])
        port.prefill(torch.randn(len(p) - res.prefix_len, HQ, D), torch.from_numpy(k),
                     torch.from_numpy(v), res.slot)
        slots.append(res.slot)

    def step(batch, **kw):
        k, v = _kv([4] * len(batch))
        port.decode_step(torch.randn(len(batch), HQ, D), torch.from_numpy(k),
                         torch.from_numpy(v), batch, **kw)

    step([slots[2]])  # no prefix: flat
    step(slots[:2])  # auto: one group of two
    step(slots[:1], cascade="on")  # a singleton group
    step(slots[:1])  # auto: a singleton stays flat
    monkeypatch.setenv("MAGI_ATTENTION_CASCADE", "off")
    step(slots[:2])
    port.cascade_override = "on"
    step(slots[:1])
    assert calls == [1, 1, 1]
    monkeypatch.setenv("MAGI_ATTENTION_CASCADE", "sometimes")
    with pytest.raises(ValueError, match="MAGI_ATTENTION_CASCADE"):
        env.cascade_mode()


def test_fully_cached_prompt_and_free(monkeypatch):
    """A prompt the prefix covers whole prefills nothing; freeing a fork
    drops its bookkeeping and leaves the trie's copy resident."""
    rng = np.random.default_rng(51)
    port, _ = _engines()
    prompt = [int(t) for t in rng.integers(0, VOCAB, 2 * PS + 3)]
    r0 = port.admit(len(prompt), tokens=prompt)
    k, v = _kv(prompt)
    port.prefill(torch.randn(len(prompt), HQ, D), torch.from_numpy(k), torch.from_numpy(v),
                 r0.slot)
    r1 = port.admit(len(prompt), tokens=prompt)
    assert r1.prefix_len == len(prompt) and port.length(r1.slot) == len(prompt)
    out, lse = port.prefill(torch.zeros(0, HQ, D), torch.zeros(0, HK, D), torch.zeros(0, HK, D),
                            r1.slot)
    assert out.shape == (0, HQ, D) and lse.shape == (0, HQ)
    resident = port.prefix.resident_pages
    for r in (r1, r0):
        port.free(r.slot)
        assert r.slot not in port._tokens and r.slot not in port._slot_prefix
    assert port.allocator.pages_in_use == resident == 3
    assert port.prefix.evict(port.allocator, 100) == 3 and port.allocator.pages_in_use == 0


def test_admission_pressure_evicts_prefix_pages_before_sequences():
    rng = np.random.default_rng(14)
    port, _ = _engines(num_pages=6, mpp=6, max_seqs=4)
    prompt = [int(t) for t in rng.integers(0, VOCAB, 2 * PS)]
    r0 = port.admit(len(prompt), tokens=prompt)
    k, v = _kv(prompt)
    port.prefill(torch.randn(len(prompt), HQ, D), torch.from_numpy(k), torch.from_numpy(v),
                 r0.slot)
    port.free(r0.slot)  # two pages now held by the trie alone
    assert port.allocator.pages_in_use == 2
    res = port.admit(5 * PS)  # needs 5, 4 free: the trie gives pages back
    assert res.admitted and not res.evicted and port.prefix.resident_pages < 2
    # a slot shortage is not cured by dropping cached KV
    port2, _ = _engines(num_pages=32, mpp=8, max_seqs=1)
    r = port2.admit(len(prompt), tokens=prompt)
    port2.prefill(torch.randn(len(prompt), HQ, D), torch.from_numpy(k), torch.from_numpy(v),
                  r.slot)
    resident = port2.prefix.resident_pages
    res = port2.admit(PS)
    assert not res.admitted and res.reason == "no_free_slot"
    assert port2.prefix.resident_pages == resident
