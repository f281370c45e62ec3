"""Resilience on the port's context-parallel path, cp = 2 over gloo on the
CPU (one ``RankPool`` for the module), overlap degree 1 (a host stage and
one remote stage), causal 512 tokens, d 32, f32, through the keyed API:

- ``MAGI_ATTENTION_GUARD=check`` with no chaos is bit for bit ``off``;
- ``corrupt_partial:site=stage0,rank=0`` under ``check`` raises
  ``NumericalGuardError`` naming ``stage0`` on rank 0 only (JAX raises the
  same sites for its one program);
- under ``repair`` the out and lse match JAX ``make_dist_attn_fn``'s under
  the same spec (rtol 2e-4, atol 2e-5, jnp backend), and the gradients are
  finite and, with the planted row left out of the loss, within 1e-4 of a
  clean run's (the port held against itself: JAX's twin of this check,
  ``test_guard_ad.py``, is marked slow);
- ``corrupt_cast`` (on the stage's cast) and ``corrupt_reduce`` give the
  NaN masks of JAX's outputs, and its values: a NaN key row makes the
  stage's plain kernel report its rows as uncovered (lse -inf, out NaN),
  so the merge drops the stage in both packages, and ``check`` catches the
  non-finite out at ``stage0`` on every rank; ``corrupt_reduce`` has no
  reduce to reach on this path's forward, in either package;
- a ``straggler`` on the hops impl leaves the outputs bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.parallel.dispatch import dispatch, undispatch
from magiattention_tpu.parallel.dist_attn import (
    build_dist_attn_plan,
    make_attn_params,
    make_dist_attn_fn,
)
from magiattention_tpu.resilience import guards
from magiattention_tpu.resilience import reset_chaos as jax_reset_chaos
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

RTOL, ATOL = 2e-4, 2e-5
TOTAL, CHUNK, D, HQ, HK, CP = 512, 64, 32, 4, 2, 2
CASE = dict(q_ranges=[(0, TOTAL)], k_ranges=[(0, TOTAL)], types=[1], total=TOTAL, chunk=CHUNK,
            degree=1, min_stage_rows=64, impl="a2a")
# seed 64: rank 0's local row 64 (a row with remote keys at this layout), head 1
STAGE0 = "corrupt_partial:site=stage0,value=nan,rank=0,seed=64"
PLANTS = {
    "corrupt_cast": "corrupt_cast:value=nan,seed=3",
    "corrupt_reduce": "corrupt_reduce:value=nan,seed=3",
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(TOTAL, HQ, D), k=f(TOTAL, HK, D),
                v=rng.uniform(0.5, 1.5, (TOTAL, HK, D)).astype(np.float32),
                g_out=f(TOTAL, HQ, D), g_lse=f(TOTAL, HQ))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(CP)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_plan():
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        JaxRanges.from_ranges(CASE["q_ranges"]), JaxRanges.from_ranges(CASE["k_ranges"]),
        CASE["types"], TOTAL, TOTAL, chunk_size=CHUNK, cp_size=CP)
    plan = build_dist_attn_plan(mq, bucket, block_q=64, block_k=64, overlap_config=JaxOverlapConfig(
        degree=CASE["degree"], min_stage_rows=CASE["min_stage_rows"]))
    assert plan.overlap_degree == 1
    return mq, plan


def _jax_run(jax_plan, inputs, monkeypatch, env: dict):
    """JAX ``make_dist_attn_fn`` on the 2-device mesh under ``env``, jitted
    (its guard boundary then logs instead of raising): the global (out,
    lse)."""
    mq, plan = jax_plan
    jax_backend(monkeypatch)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax_reset_chaos()
    try:
        mesh = Mesh(np.array(jax.devices()[:CP]), ("cp",))
        fn = make_dist_attn_fn(plan, mesh, make_attn_params(plan, D, out_dtype="float32"))
        def run(q, k, v):
            out, lse = fn(dispatch(q, mq), dispatch(k, mq), dispatch(v, mq))
            return undispatch(out, mq), undispatch(lse, mq)

        out, lse = jax.jit(run)(*(jnp.asarray(inputs[n]) for n in ("q", "k", "v")))
        return np.asarray(out), np.asarray(lse)
    finally:
        for name in env:
            monkeypatch.delenv(name)
        jax_reset_chaos()


@pytest.fixture(scope="module")
def port_runs(pool, jax_plan):
    """Every port run of the module in one task of the pool."""
    inputs = _inputs()
    planted_row = int(jax_plan[0].position_ids(0)[64])  # rank 0's local row 64 (seed 64)
    runs = {
        "off": dict(grad=True, skip_rows=[planted_row]),
        "check": dict(env={"MAGI_ATTENTION_GUARD": "check"}),
        "check_stage0": dict(env={"MAGI_ATTENTION_GUARD": "check",
                                  "MAGI_ATTENTION_CHAOS": STAGE0}),
        "repair_stage0": dict(env={"MAGI_ATTENTION_GUARD": "repair",
                                   "MAGI_ATTENTION_CHAOS": STAGE0},
                              grad=True, skip_rows=[planted_row]),
        **{name: dict(env={"MAGI_ATTENTION_CHAOS": spec}) for name, spec in PLANTS.items()},
        "check_cast": dict(env={"MAGI_ATTENTION_GUARD": "check",
                                "MAGI_ATTENTION_CHAOS": PLANTS["corrupt_cast"]}),
        "hops": dict(impl="hops"),
        "hops_straggler": dict(impl="hops", env={"MAGI_ATTENTION_CHAOS":
                                                 "straggler:hop=1,delay=4"}),
    }
    got = pool.run(workers.resilience_cp, CASE, list(runs.values()), inputs)
    return {name: [r[i] for r in got] for i, name in enumerate(runs)}, inputs, planted_row


def test_check_without_chaos_is_off_bit_for_bit(port_runs):
    runs, _, _ = port_runs
    for name in ("out", "lse"):
        for r in range(CP):
            assert np.array_equal(runs["check"][r][name], runs["off"][r][name]), (name, r)


def test_stage0_plant_raises_on_rank0_only(port_runs, jax_plan):
    runs, _, _ = port_runs
    assert runs["check_stage0"][0]["raised"] == [["stage0"], None]
    # the sites in JAX's bit order for this plan
    assert guards.plan_guard_sites(jax_plan[1]) == ("host", "stage0")


def test_repair_matches_jax_and_keeps_gradients(port_runs, jax_plan, monkeypatch):
    runs, inputs, planted_row = port_runs
    rep, off = runs["repair_stage0"][0], runs["off"][0]
    assert rep["first_row_of_rank0"] == int(jax_plan[0].position_ids(0)[0])
    out, lse = _jax_run(jax_plan, inputs, monkeypatch, {"MAGI_ATTENTION_GUARD": "repair",
                                                        "MAGI_ATTENTION_CHAOS": STAGE0})
    np.testing.assert_allclose(rep["out"], out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rep["lse"], lse, rtol=RTOL, atol=ATOL)
    assert np.isfinite(rep["out"]).all()
    assert not np.array_equal(rep["out"][planted_row], off["out"][planted_row])
    for name in ("dq", "dk", "dv"):
        assert np.isfinite(rep[name]).all(), name
        np.testing.assert_allclose(rep[name], off[name], atol=1e-4, err_msg=name)


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_payload_plants_give_jax_nan_masks(plant, port_runs, jax_plan, monkeypatch):
    runs, inputs, _ = port_runs
    got = runs[plant][0]
    out, lse = _jax_run(jax_plan, inputs, monkeypatch, {"MAGI_ATTENTION_CHAOS": PLANTS[plant]})
    assert np.array_equal(np.isnan(got["out"]), np.isnan(out))
    assert np.array_equal(np.isnan(got["lse"]), np.isnan(lse))
    np.testing.assert_allclose(got["out"], out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["lse"], lse, rtol=RTOL, atol=ATOL)
    clean = runs["off"][0]
    if plant == "corrupt_cast":
        assert not np.allclose(got["out"], clean["out"]), "the cast plant changed nothing"
        assert runs["check_cast"][0]["raised"] == [["stage0"], ["stage0"]]
    else:
        assert np.array_equal(got["out"], clean["out"])


def test_straggler_is_bit_transparent(port_runs):
    runs, _, _ = port_runs
    assert runs["hops"][0]["impls"] == ["hops"]
    for name in ("out", "lse"):
        assert np.array_equal(runs["hops_straggler"][0][name], runs["hops"][0][name])
