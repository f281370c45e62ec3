"""The port's memory observability against the JAX package's on the CPU: the
serving, tiered and plan ledgers (``as_json()``) for the same geometry and
the same admissions, prefix forks and copy-on-write splits, the
fragmentation map and ``page_states``, the ``MemPressureWatcher``'s
episodes, the ``pool_exhausted`` and ``mem_pressure`` dumps through the
scheduler, and the device samplers' CPU behaviour (empty / None)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import serving as jsv
from magiattention_tpu import telemetry as jtel
from magiattention_tpu_torch import serving as psv
from magiattention_tpu_torch import telemetry as ptel
from magiattention_tpu_torch.telemetry import memory as pmem
from magiattention_tpu_torch.telemetry import trace as ptrace
from tests.torch_jax_backend import jax_backend

D, HK, HQ, PS = 16, 2, 4, 8
GEOM = dict(num_pages=32, num_kv_heads=HK, head_dim=D, page_size=PS, max_seqs=4,
            max_pages_per_seq=8)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    jax_backend(monkeypatch)
    monkeypatch.delenv("MAGI_ATTENTION_PREFILL_CHUNK", raising=False)
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path))
    ptel.set_enabled(True)
    ptel.reset()
    ptrace.reset_flight_recorder()
    yield
    ptel.set_enabled(None)
    ptel.reset()
    ptrace.reset_flight_recorder()


def _engine(pkg, **kw):
    if pkg == "jax":
        return jsv.ServingEngine(dtype=jnp.float32, **{**GEOM, **kw})
    return psv.ServingEngine(dtype=torch.float32, device="cpu", **{**GEOM, **kw})


def _rows(pkg, rng, n):
    arrs = [rng.standard_normal((n, h, D)).astype(np.float32) for h in (HQ, HK, HK)]
    return [jnp.asarray(a) if pkg == "jax" else torch.from_numpy(a) for a in arrs]


def _churn(pkg):
    """Admissions with token ids (a registrant, a fork onto its prefix whose
    first write splits the shared tail page), a tokenless one, and the
    registrant's release (its full pages stay trie-pinned)."""
    rng = np.random.default_rng(3)
    eng = _engine(pkg)
    base = [int(t) for t in rng.integers(0, 50, 20)]
    a = eng.admit(20, tokens=base)
    eng.prefill(*_rows(pkg, rng, 20), a.slot)
    b = eng.admit(24, tokens=base + [1, 2, 3, 4])
    assert b.prefix_len == 20
    eng.prefill(*_rows(pkg, rng, 4), b.slot)
    c = eng.admit(10)
    eng.prefill(*_rows(pkg, rng, 10), c.slot)
    eng.free(a.slot)
    return eng


def _page_bytes(cache):
    return 2 * PS * HK * D * 4


def test_serving_ledger_and_pool_forensics_match_jax():
    jeng, peng = _churn("jax"), _churn("torch")
    assert peng.allocator.page_states() == jeng.allocator.page_states()
    states = peng.allocator.page_states()
    assert states["shared"] and states["trie"] and states["live"]
    assert sorted(p for v in states.values() for p in v) == list(range(GEOM["num_pages"]))
    kw = dict(num_q_heads=HQ, decode_batch=2, num_splits=2, prefill_chunk=8)
    got = ptel.serving_memory_ledger(peng, **kw)
    assert got.as_json() == jtel.serving_memory_ledger(jeng, **kw).as_json()
    # the pool phase is the pool tensors' bytes
    assert got.by_phase()["pool"] == peng.cache.k_pages.nbytes + peng.cache.v_pages.nbytes
    assert pmem.MemoryLedger.from_json(got.as_json()).as_json() == got.as_json()
    fmaps = [tel.fragmentation_map(e.allocator, page_bytes=_page_bytes(e.cache))
             for tel, e in ((ptel, peng), (jtel, jeng))]
    assert fmaps[0].as_json() == fmaps[1].as_json()
    assert fmaps[0].ascii_heatmap() == fmaps[1].ascii_heatmap()
    assert peng.memory_snapshot() == jeng.memory_snapshot()
    ptel.fragmentation_map(peng.allocator, record=True)
    gauges = ptel.snapshot()["gauges"]
    assert gauges["magi_mem_pool_pages{pool=kvpool,state=trie}"] == len(states["trie"])


def test_tiered_ledgers_match_jax():
    spec = {"prefill": 1, "decode_dp": 2, "decode_tp": 1}
    want = jsv.TieredEngine(mesh_spec=spec, dtype=jnp.float32, **GEOM)
    got = psv.TieredEngine(mesh_spec=spec, devices=["cpu"] * 3, dtype=torch.float32, **GEOM)
    kw = dict(num_q_heads=HQ, decode_batch=4)
    g, w = ptel.tiered_memory_ledger(got, **kw), jtel.tiered_memory_ledger(want, **kw)
    assert {k: v.as_json() for k, v in g.items()} == {k: v.as_json() for k, v in w.items()}
    snap = got.memory_snapshot()
    assert set(snap) == {"tier_prefill", "tier_decode_r0", "tier_decode_r1", "pending_streams"}
    json.dumps(snap)


@pytest.mark.parametrize("degree", [0, 1])
def test_plan_ledger_matches_jax(degree):
    """The same plan priced by both packages: every entry equal but
    ``kernel_tables``, which prices each package's own table layout."""
    from magiattention_tpu.common.enum import AttnMaskType as JType
    from magiattention_tpu.common.ranges import AttnRanges as JRanges
    from magiattention_tpu.meta import make_dispatch_meta_from_qk_ranges as jmeta
    from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JOC
    from magiattention_tpu.parallel.dist_attn import build_dist_attn_plan as jbuild
    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel.dist_attn import build_dist_attn_plan

    total, cp = 2048, 4
    plans = []
    for ranges, mk, oc, build, mt in (
            (JRanges, jmeta, JOC, jbuild, JType),
            (AttnRanges, make_dispatch_meta_from_qk_ranges, OverlapConfig,
             build_dist_attn_plan, AttnMaskType)):
        r = ranges.from_ranges([(0, total)])
        mq, _, bucket = mk(r, r, [mt.CAUSAL], total, total, chunk_size=256, cp_size=cp)
        plans.append(build(mq, bucket, block_q=64, block_k=64,
                           overlap_config=oc(degree=degree, min_stage_rows=64)))
    kw = dict(num_heads_q=2, num_heads_kv=2, head_dim=64, bytes_per_elt=4)
    jled = jtel.plan_memory_ledger(plans[0], **kw).as_json()
    pled = ptel.plan_memory_ledger(plans[1], **kw).as_json()
    strip = lambda led: [e for e in led["entries"] if e["component"] != "kernel_tables"]  # noqa: E731
    assert strip(pled) == strip(jled)
    (tables,) = [e for e in pled["entries"] if e["component"] == "kernel_tables"]
    assert tables["nbytes"] == sum(a.nbytes for t in plans[1].table_sets()
                                   for a in t.arrays()) // cp
    assert ("host_kernel" in pled["by_phase"]) == (degree > 0)


@pytest.mark.parametrize("fractions,threshold,ticks", [
    ((0.1, 0.1, 0.15, 0.1, 0.5, 0.1, 0.1, 0.1), 0.2, 3),
    ((0.0, 0.0, 0.0), 0.0, 1),
    ((0.3, 0.1, 0.1, 0.3, 0.1), 0.25, 1),
])
def test_mem_pressure_episodes_match_jax(fractions, threshold, ticks):
    got = ptel.MemPressureWatcher(threshold, ticks=ticks)
    want = jtel.MemPressureWatcher(threshold, ticks=ticks)
    assert [got.observe(f) for f in fractions] == [want.observe(f) for f in fractions]


def _request(rng, rid, n, gen):
    mk = lambda m, h: torch.from_numpy(rng.standard_normal((m, h, D)).astype(np.float32))  # noqa: E731
    return psv.Request(rid=rid, prompt_q=mk(n, HQ), prompt_k=mk(n, HK), prompt_v=mk(n, HK),
                       decode_q=mk(gen, HQ), decode_k=mk(gen, HK), decode_v=mk(gen, HK))


def test_pool_exhausted_dump_names_the_admission():
    rng = np.random.default_rng(8)
    eng = _engine("torch", num_pages=2, max_pages_per_seq=2)
    sched = psv.Scheduler(eng, token_budget=64)
    sched.submit(_request(rng, 0, 2 * PS - 2, 2))
    big = sched.submit(_request(rng, 1, PS, 1))
    sched.step()
    rec = ptrace.get_flight_recorder()
    (path,) = rec.dump_paths
    payload = json.load(open(path))
    assert payload["trigger"]["trigger"] == "pool_exhausted"
    assert payload["trigger"]["context"]["trace_id"] == big.trace_id
    (snap,) = payload["memory"].values()
    assert snap["fragmentation"]["state_counts"]["free"] == 0
    assert snap["ledger"]["by_phase"]["pool"] == 2 * _page_bytes(eng.cache)
    assert not eng.admit(PS).admitted and eng._pool_exhausted_armed


def test_mem_pressure_dump_through_the_scheduler(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD", "0.5")
    rng = np.random.default_rng(9)
    eng = _engine("torch", num_pages=4, max_pages_per_seq=4)
    sched = psv.Scheduler(eng, token_budget=64)
    assert sched.knobs()["mem_pressure_threshold"] == 0.5
    sched._mem_watcher = ptel.MemPressureWatcher(0.5, ticks=2)
    sched.submit(_request(rng, 0, 3 * PS, 8))
    for _ in range(4):
        sched.step()
    (path,) = ptrace.get_flight_recorder().dump_paths
    payload = json.load(open(path))
    assert payload["trigger"]["trigger"] == "mem_pressure"
    assert payload["trigger"]["context"]["threshold"] == 0.5
    gauges = ptel.snapshot()["gauges"]
    free = eng.allocator.num_pages - eng.allocator.pages_in_use
    assert gauges["magi_kvcache_free_pages"] == free and "magi_sched_admission_headroom" in gauges
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        sched.apply_knobs(mem_pressure_threshold=2.0)


def test_device_samplers_are_empty_on_the_cpu():
    assert ptel.sample_memory_stats() == {}
    assert ptel.sample_memory_stats(["cpu"], key="peak_bytes_in_use") == {}
    x = torch.ones(4)
    assert ptel.measure_program_memory(lambda t: t * 2, x) is None
    led = pmem.MemoryLedger("x", (pmem.LedgerEntry("pool", "pages_live", 8),))
    assert ptel.ledger_vs_measured(led, None) is None
    cmp = ptel.ledger_vs_measured(led, {"argument_bytes": 8, "output_bytes": 0,
                                        "temp_bytes": 4})
    assert cmp.delta_ratio == 1.0 and cmp.unattributed_bytes == 4 and cmp.within(0.0)
    gauges = ptel.snapshot()["gauges"]
    assert gauges["magi_mem_delta_ratio{program=x}"] == 1.0
    assert gauges["magi_mem_predicted_bytes{ledger=x,phase=total}"] == 8
