"""The device side of the port's telemetry on its context-parallel path,
cp = 2 over gloo on the CPU (one ``RankPool`` for the module), against the
JAX package on its 2-device CPU mesh (jnp backend, 64 x 64 tiles):

- the value census (``MAGI_ATTENTION_NUMERICS=census``) of a staged keyed
  forward (causal 512, 4 / 2 heads, d 32, f32, overlap degree 1): every
  site's values equal JAX's ``make_dist_attn_fn``'s within rtol 1e-5,
  atol 1e-6 (f32 sums in two orders); census off and on give the same
  bits; a ``finite:8.0`` plant at the host stage moves that site's out
  max-abs and lse max to 8.0;
- the measured timeline (``profile_plan_timeline``) with a fake clock: the
  same stages, hops, totals and prediction as JAX's with the same clock
  and cost factors, exactly; with the real clock, one stage a plan stage;
- the plan-cache, bucket, incremental and eviction counters of a keyed
  stream under ``MAGI_ATTENTION_PLAN_REUSE=bucket`` equal JAX's for the
  same keys, and the plan layer's catalog is recorded."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import magiattention_tpu.benchmarking.bench as jax_bench
from magiattention_tpu import api as jax_api
from magiattention_tpu import telemetry as jtel
from magiattention_tpu.api import interface as jax_iface
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.parallel.dispatch import dispatch, undispatch
from magiattention_tpu.parallel.dist_attn import (
    build_dist_attn_plan,
    make_attn_params,
    make_dist_attn_fn,
)
from magiattention_tpu.resilience import reset_chaos as jax_reset_chaos
from magiattention_tpu.telemetry import numerics as jnum
from magiattention_tpu.telemetry.timeline import profile_plan_timeline as jax_timeline
from magiattention_tpu_torch import telemetry
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

RTOL, ATOL = 1e-5, 1e-6
TOTAL, CHUNK, D, HQ, HK, CP = 512, 64, 32, 4, 2, 2
CASE = dict(q_ranges=[(0, TOTAL)], k_ranges=[(0, TOTAL)], types=[1], total=TOTAL, chunk=CHUNK,
            degree=1, min_stage_rows=64,
            chaos="corrupt_partial:site=host,value=finite:8.0,seed=3")
PIN = {"MAGI_ATTENTION_BLOCK_Q": "64", "MAGI_ATTENTION_BLOCK_K": "64"}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(CP)
    yield p
    p.close()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((TOTAL, HQ, D)).astype(np.float32),
                k=rng.standard_normal((TOTAL, HK, D)).astype(np.float32),
                v=rng.uniform(0.5, 1.5, (TOTAL, HK, D)).astype(np.float32))


def _jax_plan(case, impl="a2a"):
    qr, kr = JaxRanges.from_ranges(case["q_ranges"]), JaxRanges.from_ranges(case["k_ranges"])
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(qr, kr, case["types"], case["total"],
                                                      case["total"], case["chunk"], CP)
    plan = build_dist_attn_plan(mq, bucket, block_q=64, block_k=64,
                                overlap_config=JaxOverlapConfig(
                                    degree=case["degree"], min_stage_rows=case["min_stage_rows"]))
    return mq, plan


def _jax_census(inputs, monkeypatch):
    """JAX's staged forward under census, jitted (the census lands through
    its host callback); the ``parallel`` layer's census and the global
    out."""
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_NUMERICS", "census")
    jax_reset_chaos()
    jnum.reset_numerics_census()
    try:
        mq, plan = _jax_plan(CASE)
        mesh = Mesh(np.array(jax.devices()[:CP]), ("cp",))
        fn = make_dist_attn_fn(plan, mesh, make_attn_params(plan, D, out_dtype="float32"))
        out, _ = jax.jit(fn)(*(dispatch(jnp.asarray(inputs[n]), mq) for n in ("q", "k", "v")))
        out = np.asarray(undispatch(out, mq))
        jax.effects_barrier()  # the census lands through its host callback
        return jnum.get_numerics_census().numerics_snapshot()["census"]["parallel"], out
    finally:
        monkeypatch.delenv("MAGI_ATTENTION_NUMERICS")
        jax_reset_chaos()


@pytest.fixture(scope="module")
def census_runs(pool):
    return pool.run(workers.census_cp, CASE, _inputs())


def test_census_off_and_on_are_bitwise_the_same(census_runs):
    for r in census_runs:
        assert r["off"]["num_stages"] == 1
        assert r["off"]["census"] == {} and r["off"]["gauges"] == {}
        for name in ("out", "lse"):
            np.testing.assert_array_equal(r["off"][name], r["census"][name])


def test_census_values_are_jaxs(census_runs, monkeypatch):
    want, jout = _jax_census(_inputs(), monkeypatch)
    assert set(want) == {"host", "stage0", "final"}
    for r in census_runs:  # every rank holds the group's census
        got = r["census"]["census"]["parallel"]
        assert set(got) == set(want)
        for site, stats in want.items():
            assert set(got[site]) == set(stats)
            for stat, val in stats.items():
                np.testing.assert_allclose(got[site][stat], val, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{site}/{stat}")
                # the gauges carry the same values
                key = f"magi_numerics_census{{layer=parallel,site={site},stat={stat}}}"
                assert r["census"]["gauges"][key] == got[site][stat]
        np.testing.assert_allclose(r["census"]["out"], jout, rtol=2e-4, atol=2e-5)
        assert got["final"]["mass_dev"] < 1e-5


def test_a_finite_plant_moves_its_site(census_runs):
    """``corrupt_partial:site=host,value=finite:8.0`` plants 8.0 into one
    (out, lse) position of the host stage's partial, downstream of which the
    census reads: that site's out max-abs and lse max become 8.0, the other
    sites keep the clean run's values."""
    for r in census_runs:
        clean, planted = (r[run]["census"]["parallel"] for run in ("census", "planted"))
        assert planted["host"]["out_max_abs"] == planted["host"]["lse_max"] == 8.0
        assert clean["host"]["out_max_abs"] < 8.0 and clean["host"]["lse_max"] < 8.0
        assert planted["stage0"] == clean["stage0"]


@pytest.mark.parametrize("degree,impl", [(0, "a2a"), (2, "hops")])
def test_timeline_fold_is_jaxs(degree, impl, pool, monkeypatch):
    case = dict(CASE, q_ranges=[(0, 200), (200, 380), (380, TOTAL)],
                k_ranges=[(0, 200), (200, 380), (380, TOTAL)], types=[1, 1, 1], degree=degree,
                impl=impl, heads=(HQ, HK), head_dim=D)
    clock = [float(i + 1) * 0.5 for i in range(64)]
    factors = (3e-12, 2e-9)
    got = pool.run(workers.timeline_cp, case, clock, factors)
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
    ticks = iter(clock)
    monkeypatch.setattr(jax_bench, "do_bench", lambda *a, **k: type(
        "R", (), {"median_ms": next(ticks)})())
    _, plan = _jax_plan(case)
    want = dataclasses.asdict(jax_timeline(
        plan, Mesh(np.array(jax.devices()[:CP]), ("cp",)),
        make_attn_params(plan, D, out_dtype="float32"), num_heads=(HQ, HK), head_dim=D,
        calc_cost_factor=factors[0], comm_cost_factor=factors[1], record=False))
    for r in got:
        assert r["degree"] == plan.overlap_degree
        assert r["fake"] == want
        real = r["real"]
        assert len(real["stages"]) == (1 if degree == 0 else 1 + r["num_stages"])
        assert real["measured_total_ms"] > 0 and real["serial_total_ms"] > 0
        assert real["predicted_total_ms"] is None  # no card on the CPU: no prediction
        # without device=, the operands go on the card; with none, it raises
        assert r["no_device"].startswith("profile_plan_timeline: no CUDA device")
        assert set(telemetry.REQUIRED_TIMELINE_METRICS) - {
            "magi_overlap_predicted_total_ms", "magi_overlap_prediction_error_ratio"} <= {
            k.split("{")[0] for k in r["gauges"]}
    assert got[0]["real"] == got[1]["real"]  # every rank holds the slowest rank's numbers


STREAM = [[0, 300, 800, 950, 1550], [0, 290, 760, 900, 1490], [0, 290, 760, 900, 1490],
          [0, 290, 760, 900, 1500], [0, 320, 832, 992, 1632], [0, 700, 1400, 1600],
          [0, 300, 800, 950, 1550]]
CACHE_FAMILIES = ("magi_plan_cache", "magi_runtime_cache", "magi_plan_bucket",
                  "magi_plan_incremental", "magi_plan_builds", "magi_dispatch_meta_builds",
                  "magi_group_collective_builds")


def test_plan_cache_counters_are_jaxs(pool, monkeypatch):
    flags = {"MAGI_ATTENTION_PLAN_REUSE": "bucket", "MAGI_ATTENTION_PLAN_CACHE_SIZE": "1"}
    got = pool.run(workers.plan_cache_stream, STREAM, CHUNK, 3, flags)
    jax_backend(monkeypatch)
    for name, val in {**PIN, **flags}.items():
        monkeypatch.setenv(name, val)
    mesh = Mesh(np.array(jax.devices()[:CP]), ("cp",))
    saved = jax_iface._runtime_dict.maxsize
    jax_iface._runtime_dict.maxsize = 3
    jax_api.clear_cache()
    jtel.set_enabled(True)
    jtel.reset()
    try:
        for cu in STREAM:
            jax_api.magi_attn_varlen_key(cu, cu[-1], mesh, num_heads=(HQ, HK), head_dim=D,
                                         chunk_size=CHUNK, out_dtype="float32")
        want = {k: v for k, v in jtel.snapshot()["counters"].items()
                if k.startswith(CACHE_FAMILIES)}
    finally:
        jax_iface._runtime_dict.maxsize = saved
        jtel.set_enabled(None)
        jtel.reset()
        jax_api.clear_cache()
    for r in got:
        assert {k: v for k, v in r["counters"].items() if k.startswith(CACHE_FAMILIES)} == want
    # every family of the stream ticked: hits, misses, bucket hits and
    # misses, a patch, a fallback, and both caches' evictions
    assert {"magi_plan_cache_hits", "magi_plan_bucket_hits_total",
            "magi_plan_bucket_misses_total", "magi_plan_incremental_patches_total",
            "magi_plan_cache_evictions_total{cache=fingerprint}",
            "magi_plan_cache_evictions_total{cache=runtime}"} <= set(want)
    # the plan layer's catalog (its modeled seconds need a card: none here)
    plan_series = set(telemetry.REQUIRED_PLAN_METRICS) - {
        "magi_plan_modeled_calc_seconds", "magi_plan_modeled_comm_seconds"}
    assert plan_series | set(telemetry.REQUIRED_PLAN_CACHE_METRICS) <= set(got[0]["names"])


def test_runtime_costs_on_a_card_fill_the_plan_catalog():
    """``record_runtime_costs`` priced on the H100's row sets the modeled
    seconds the CPU keys leave out, at the datasheet rates."""
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges as pm
    from magiattention_tpu_torch.parallel.dist_attn import build_dist_attn_plan as pbuild

    r = AttnRanges.from_ranges(CASE["q_ranges"])
    mq, _, bucket = pm(r, r, CASE["types"], TOTAL, TOTAL, CHUNK, CP)
    plan = pbuild(mq, bucket)
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        telemetry.record_runtime_costs(plan, num_heads_q=HQ, num_heads_kv=HK, head_dim=D,
                                       bytes_per_elt=2, card="NVIDIA H100 80GB HBM3")
        g = telemetry.snapshot()["gauges"]
        assert g["magi_plan_modeled_calc_seconds"] == pytest.approx(
            plan.max_rank_area * 4 * HQ * D / 989e12)
        assert g["magi_plan_modeled_comm_seconds"] == pytest.approx(
            max(plan.comm.recv_total) * 2 * HK * D * 2 / 450e9)
        # the plan's ledger is the memory module's, over this plan
        led = plan.memory_ledger(num_heads_q=HQ, num_heads_kv=HK, head_dim=D)
        assert led.as_json() == telemetry.plan_memory_ledger(
            plan, num_heads_q=HQ, num_heads_kv=HK, head_dim=D).as_json()
        assert led.total() > 0
    finally:
        telemetry.set_enabled(None)
        telemetry.reset()
