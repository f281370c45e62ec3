"""The resilience hooks' telemetry against the JAX package's on the CPU:
guard violations and repairs by site from the same error codes (and the
``numerical_guard`` dump of a check-mode violation), guard checks by the
port's per-call rule (the port runs eagerly; the JAX package counts once
per traced program), ``magi_degraded_path`` by reason from the plan-build
and hop-build fallbacks, and the cross-rank aggregate over a 2-rank gloo
group."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import telemetry as jtel
from magiattention_tpu.resilience import guards as JG
from magiattention_tpu.resilience import reset_chaos as jax_reset_chaos
from magiattention_tpu.telemetry import trace as jtrace
from magiattention_tpu_torch import telemetry as ptel
from magiattention_tpu_torch.resilience import guards as G
from magiattention_tpu_torch.resilience import reset_chaos
from magiattention_tpu_torch.telemetry import trace as ptrace
from tests.torch_jax_backend import jax_backend


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path))
    for name in ("MAGI_ATTENTION_CHAOS", "MAGI_ATTENTION_GUARD", "MAGI_ATTENTION_GROUP_COLL_IMPL"):
        monkeypatch.delenv(name, raising=False)
    for tel, tr in ((jtel, jtrace), (ptel, ptrace)):
        tel.set_enabled(True)
        tel.reset()
        tr.reset_flight_recorder()
    reset_chaos()
    jax_reset_chaos()
    yield
    for tel, tr in ((jtel, jtrace), (ptel, ptrace)):
        tel.set_enabled(None)
        tel.reset()
        tr.reset_flight_recorder()
    reset_chaos()
    jax_reset_chaos()


def _counters(tel, prefix):
    return {k: v for k, v in tel.snapshot()["counters"].items() if k.startswith(prefix)}


@pytest.mark.parametrize("mode", ["check", "repair"])
@pytest.mark.parametrize("codes,sites", [
    ([[0b101], [0b10]], ("host", "stage0", "stage1")),
    ([[1 << 1]], tuple(f"split{i}" for i in range(33))),  # wraps past 31 bits
])
def test_guard_violations_and_repairs_match_jax(mode, codes, sites, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", mode)
    for tr in (jtrace, ptrace):
        tr.get_flight_recorder().record_tick({"step": 1})
    for code in codes:
        for consume, arr, err in (
                (JG.consume_error_code, jnp.asarray(code, jnp.int32), JG.NumericalGuardError),
                (G.consume_error_code, torch.tensor(code, dtype=torch.int32),
                 G.NumericalGuardError)):
            if mode == "check":
                with pytest.raises(err):
                    consume(arr, sites)
            else:
                consume(arr, sites)
    kind = "magi_guard_violations" if mode == "check" else "magi_guard_repairs"
    got = _counters(ptel, kind)
    assert got and got == _counters(jtel, kind)
    paths = ptrace.get_flight_recorder().dump_paths
    # a check-mode violation dumps at once, one dump per raising call
    assert len(paths) == len(jtrace.get_flight_recorder().dump_paths) == (
        len(codes) if mode == "check" else 0)
    if paths:
        payload = json.load(open(paths[0]))
        assert payload["trigger"]["trigger"] == "numerical_guard"


def test_guard_checks_count_once_per_call(monkeypatch):
    """Two flat decodes of 2 splits under ``check``: each guard call counts,
    so every split site counts 2 (the JAX package counts a traced program
    once)."""
    from magiattention_tpu_torch.serving import ServingEngine

    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    eng = ServingEngine(num_pages=8, num_kv_heads=2, head_dim=16, page_size=8, max_seqs=2,
                        max_pages_per_seq=4, dtype=torch.float32, device="cpu")
    slot = eng.admit(24).slot
    rng = np.random.default_rng(0)
    mk = lambda n, h: torch.from_numpy(rng.standard_normal((n, h, 16)).astype(np.float32))  # noqa: E731
    eng.prefill(mk(24, 4), mk(24, 2), mk(24, 2), slot)
    for _ in range(2):
        eng.decode_step(mk(1, 4), mk(1, 2), mk(1, 2), [slot], num_splits=2)
    assert eng.last_decode_info["num_splits"] == 2
    assert _counters(ptel, "magi_guard_checks") == {
        f"magi_guard_checks{{site=split{i}}}": 2.0 for i in range(2)}
    assert _counters(ptel, "magi_guard_violations") == {}


def test_degraded_paths_match_jax(monkeypatch):
    from magiattention_tpu.comm.group_collective import GroupCollectiveMeta as JaxMeta
    from magiattention_tpu_torch.comm import GroupCollectiveMeta
    from tests.test_torch_dist_plan import _plans

    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", "a2a")
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", "plan_error:times=1")
    reset_chaos()
    jax_reset_chaos()
    _plans("varlen_block_causal", 2, 2)
    smap = [[np.arange(4, dtype=np.int64) if s != d else np.empty(0, np.int64)
             for d in range(2)] for s in range(2)]
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", "hops_build_error:times=1")
    reset_chaos()
    jax_reset_chaos()
    GroupCollectiveMeta.build(smap, [8, 8], impl="hops")
    JaxMeta.build(smap, [8, 8], impl="hops")
    gauges = {k: v for k, v in ptel.snapshot()["gauges"].items()
              if k.startswith("magi_degraded_path")}
    assert gauges == {k: v for k, v in jtel.snapshot()["gauges"].items()
                      if k.startswith("magi_degraded_path")}
    assert set(gauges) == {"magi_degraded_path{reason=plan_build_error}",
                           "magi_degraded_path{reason=hops_build_error}"}
    # the degraded build's seconds reached the plan solver's series
    assert ptel.snapshot()["histograms"]["magi_plan_solver_seconds{outcome=miss}"]["count"] == 1


def test_aggregate_across_two_gloo_ranks():
    from magiattention_tpu_torch.testing.dist import RankPool
    from tests import torch_dist_workers as W

    with RankPool(2) as pool:
        res = pool.run(W.telemetry_aggregate, 5)
    assert res[0]["aggregate"] == res[1]["aggregate"]
    snaps = [r["snapshot"] for r in res]
    agg = res[0]["aggregate"]
    assert agg == ptel.merge_snapshots(snaps, ranks=[0, 1]) == jtel.merge_snapshots(
        snaps, ranks=[0, 1])
    assert agg["counters"]["magi_decode_tokens_total"] == 3.0
    assert agg["gauges"]["magi_tier_active_requests{tier=decode}"]["argmax"] == "1"
    assert agg["histograms"]["magi_request_ttft_seconds"]["count"] == 5
