"""The port's serving-state interleaving checker (``analysis/lifecycle.py``)
against the JAX package's: over the same models the two explore the same
number of canonical states and transitions, both replanted bugs are found
at the same counterexample lengths, the stubbed device layer drives the
port's real host objects, and every patch comes off again."""

import pytest
import torch

from magiattention_tpu.analysis import lifecycle as jax_lc
from magiattention_tpu_torch.analysis import lifecycle as lc

# JAX's run_lifecycle_check on this image: states / transitions per model
FULL_MATRIX = {"0:engine": (8489, 44896), "1:engine": (2348, 15063),
               "2:scheduler": (104, 149), "3:scheduler": (271, 372), "4:tiered": (203, 242)}


def _counts(report):
    return {k: (r["states"], r["transitions"]) for k, r in report.items()}


def test_smoke_matrix_equals_jax():
    errors, report = lc.run_lifecycle_check(smoke=True)
    jerrors, jreport = jax_lc.run_lifecycle_check(smoke=True)
    assert errors == [] and jerrors == []
    assert _counts(report) == _counts(jreport) == {
        "0:engine": (62, 190), "1:scheduler": (48, 62), "2:tiered": (25, 26)}


@pytest.mark.parametrize("plant,model,depth", [
    ("planted_double_free", "EngineModel", 6),
    ("planted_dangling_eviction", "SchedulerModel", 8),
])
def test_both_plants_are_caught_at_jax_lengths(plant, model, depth):
    found = {}
    for pkg in (jax_lc, lc):
        with pkg.stubbed_device_layer():
            with getattr(pkg, plant)():
                res = pkg.explore(getattr(pkg, model)(), max_depth=depth)
        assert not res.ok
        found[pkg] = res.counterexamples[0]
    cex, jcex = found[lc], found[jax_lc]
    assert len(cex.trace) <= 8
    assert cex.trace == jcex.trace
    want = "refcount" if plant == "planted_double_free" else "never requeued"
    assert any(want in v for v in cex.violations)


def test_mutation_self_test_api():
    assert lc.run_mutation_self_test() == []


def test_stubbed_engine_lifecycle_roundtrip():
    with lc.stubbed_device_layer():
        from magiattention_tpu_torch.serving.engine import ServingEngine

        eng = ServingEngine(num_pages=5, num_kv_heads=2, head_dim=4, page_size=8, max_seqs=2,
                            max_pages_per_seq=4, dtype=torch.float32, device="cpu")
        assert isinstance(eng.cache, lc._StubCache)
        toks = tuple(range(11))  # one full page + a 3-token tail
        res = eng.admit(len(toks), tokens=toks)
        assert res.admitted
        q = torch.zeros((11, 2, 4))
        eng.prefill(q, q, q, res.slot)  # registers the prefix
        assert eng.prefix.resident_pages == 2
        assert lc.engine_invariants(eng) == []
        d = torch.zeros((1, 2, 4))
        eng.decode_step(d, d, d, [res.slot])
        assert eng._lengths[res.slot] == 12 == int(eng.cache.seq_lens[res.slot])
        assert lc.engine_invariants(eng) == []
        eng.free(res.slot)
        assert lc.engine_invariants(eng) == []
        eng.prefix.drop_all(eng.allocator)
        assert eng.allocator.pages_in_use == 0
        assert lc.engine_invariants(eng) == []


def test_stubbed_fork_and_refcounts():
    with lc.stubbed_device_layer():
        from magiattention_tpu_torch.serving.engine import ServingEngine

        eng = ServingEngine(num_pages=6, num_kv_heads=2, head_dim=4, page_size=8, max_seqs=3,
                            max_pages_per_seq=4, dtype=torch.float32, device="cpu")
        toks = tuple(range(8))  # exactly one full page
        r1 = eng.admit(8, tokens=toks)
        q = torch.zeros((8, 2, 4))
        eng.prefill(q, q, q, r1.slot)
        r2 = eng.admit(10, tokens=toks + (9, 9))  # forks the shared page
        assert r2.admitted and r2.prefix_len == 8
        assert int(eng.cache.seq_lens[r2.slot]) == 8  # keep_len installed in place
        shared = eng.allocator.slot_pages(r1.slot)[0]
        assert eng.allocator.page_ref(shared) == 3  # registrant + trie + fork
        assert lc.allocator_invariants(eng.allocator, eng.prefix) == []
        eng.free(r1.slot)
        assert eng.allocator.page_ref(shared) == 2
        assert lc.allocator_invariants(eng.allocator, eng.prefix) == []


def test_stub_cache_ops_keep_the_real_length_semantics():
    cache = lc._stub_make_cache(4, 8, 2, 4, max_seqs=2, max_pages_per_seq=2)
    lc._stub_assign_block_table(cache, 0, [1, 2], keep_len=5)
    with pytest.raises(ValueError, match="keep_len=17 out of range"):
        lc._stub_assign_block_table(cache, 1, [3, 0], keep_len=17)
    with pytest.raises(ValueError, match="would overflow"):
        lc._stub_assign_block_table(cache, 1, [1, 2, 3])
    for _ in range(20):  # saturates at the slot's capacity
        lc._stub_append_kv(cache, torch.tensor([0]), None, None)
    assert int(cache.seq_lens[0]) == 16


def test_decode_fault_requeues_and_replays():
    with lc.stubbed_device_layer():
        m = lc.TieredModel()
        sys = m.initial()
        m.apply(sys, "submit:A")
        m.apply(sys, "tick")
        assert m.check(sys) == []
        m.apply(sys, "tick_fault")
        assert m.check(sys) == []
        for _ in range(12):
            if sys["sched"].done:
                break
            m.apply(sys, "tick")
            assert m.check(sys) == []
        assert sys["sched"].done
        st = sys["sched"]._finished[0]
        assert st.evictions >= 1 and st.tokens_done == 2


def test_every_patch_is_restored_after_an_exception():
    from magiattention_tpu_torch.serving import distributed, engine

    real = (engine.make_paged_kv_cache, engine.append_kv, engine.decode_attn_paged,
            distributed.assign_block_table, distributed.TieredEngine._stream_pages)
    with pytest.raises(RuntimeError, match="inside"):
        with lc.stubbed_device_layer():
            assert engine.make_paged_kv_cache is lc._stub_make_cache
            raise RuntimeError("inside the stubbed layer")
    assert (engine.make_paged_kv_cache, engine.append_kv, engine.decode_attn_paged,
            distributed.assign_block_table, distributed.TieredEngine._stream_pages) == real
    eng = engine.ServingEngine(num_pages=4, num_kv_heads=2, head_dim=16, page_size=8,
                               max_seqs=2, dtype=torch.float32, device="cpu")
    assert not isinstance(eng.cache, lc._StubCache)


def test_analysis_counters_record_each_exploration():
    from magiattention_tpu_torch import telemetry

    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        with lc.stubbed_device_layer():
            res = lc.explore(lc.EngineModel(), max_depth=2)
        c = telemetry.snapshot()["counters"]
        assert c["magi_analysis_states_explored"] == res.states
        assert c["magi_analysis_counterexamples"] == 0
    finally:
        telemetry.reset()
        telemetry.set_enabled(None)


@pytest.mark.slow
def test_full_matrix_equals_jax_counts():
    errors, report = lc.run_lifecycle_check()
    assert errors == []
    assert _counts(report) == FULL_MATRIX
    assert sum(s for s, _ in FULL_MATRIX.values()) >= 10_000
