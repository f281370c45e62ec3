"""The serving path's telemetry against the JAX package's on the CPU: the
scheduler trace of ``tests/test_torch_scheduler.py`` through both packages
with telemetry on, under ``MAGI_ATTENTION_UNIFIED_TICK`` off, on and auto,
and the shadow check at every second decode batch. Per mode the counters
and gauges must be equal (time-valued histograms by count; the builds and
the shadow checks' ulp scores are each package's own), the request traces
the same span kinds and attributes (timestamps and durations left out),
the flight recorder the same triggers, and the port's ``StepReport``s the
same as with telemetry off. The shadow check passes on clean traffic and a
planted finite corruption of the production output arms ``numeric_drift``
(its dump written at the tick's end), in both packages."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import telemetry as jtel
from magiattention_tpu.resilience import chaos as jchaos
from magiattention_tpu.serving import ServingEngine as JaxEngine
from magiattention_tpu.telemetry import numerics as jnum
from magiattention_tpu.telemetry import trace as jtrace
from magiattention_tpu_torch import telemetry as ptel
from magiattention_tpu_torch.resilience import chaos as pchaos
from magiattention_tpu_torch.serving import ServingEngine, StepReport
from magiattention_tpu_torch.telemetry import numerics as pnum
from magiattention_tpu_torch.telemetry import trace as ptrace
from tests.test_torch_scheduler import HK, HQ, D, _drive, _mixed_trace
from tests.test_torch_scheduler import _env  # noqa: F401 — the jax backend and split pins

# time-valued (or each package's own) histograms: compared by sample count
_COUNT_ONLY = ("magi_request_queue_seconds", "magi_request_ttft_seconds",
               "magi_request_token_latency_seconds", "magi_numerics_shadow_divergence")
# each package's own: the JAX package counts XLA executables, the port
# kernel builds; the JAX package's kernel autotuner (ROADMAP A.12)
_OWN = ("magi_compile_", "magi_jit_cache_entries", "magi_autotune_")
_TIME_ATTRS = ("queue_s", "ttft_s", "token_latency_s", "e2e_s", "slo_window_s")


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path))
    for tel, tr, num, ch in ((jtel, jtrace, jnum, jchaos), (ptel, ptrace, pnum, pchaos)):
        tel.set_enabled(True)
        tel.reset()
        tr.reset_flight_recorder()
        num.reset_numerics_census()
        ch.reset_chaos()
    yield
    for tel, tr, num, ch in ((jtel, jtrace, jnum, jchaos), (ptel, ptrace, pnum, pchaos)):
        tel.set_enabled(None)
        tel.reset()
        tr.reset_flight_recorder()
        num.reset_numerics_census()
        ch.reset_chaos()


def _spy_triggers(mp, trace_mod, out: list):
    real = trace_mod.FlightRecorder.trigger

    def trigger(self, signal, **kw):
        out.append(signal)
        return real(self, signal, **kw)

    mp.setattr(trace_mod.FlightRecorder, "trigger", trigger)


def _series(snap):
    counters = {k: v for k, v in snap["counters"].items() if not k.startswith(_OWN)}
    gauges = {k: v for k, v in snap["gauges"].items() if not k.startswith(_OWN)}
    hists = {k: (h["count"] if k.startswith(_COUNT_ONLY) else h)
             for k, h in snap["histograms"].items() if not k.startswith(_OWN)}
    return counters, gauges, hists


def _spans_by_rid(tel):
    """Each request's spans as (kind, seq, attrs without time values)."""
    out = {}
    for tr in tel.export_request_traces().values():
        assert tr.complete, tr.trace_id
        out[tr.rid] = [(s["kind"], s["seq"], {k: v for k, v in s["attrs"].items()
                                               if k not in _TIME_ATTRS}) for s in tr.spans]
    return out


def _fields(rep):
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(StepReport)}


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_serving_telemetry_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
    monkeypatch.setenv("MAGI_ATTENTION_SHADOW_SAMPLE_RATE", "2")
    trace = _mixed_trace(16)
    ptel.set_enabled(False)
    _, quiet, _ = _drive("torch", *trace)
    assert ptel.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    ptel.set_enabled(True)
    ptel.reset()
    pnum.reset_numerics_census()  # the census is on whatever the flag says
    triggers = {"jax": [], "torch": []}
    _spy_triggers(monkeypatch, jtrace, triggers["jax"])
    _spy_triggers(monkeypatch, ptrace, triggers["torch"])
    _drive("jax", *trace)
    sched, reps, _ = _drive("torch", *trace)
    assert [_fields(r) for r in reps] == [_fields(r) for r in quiet]
    jsnap, psnap = jtel.snapshot(), ptel.snapshot()
    for got, want in zip(_series(psnap), _series(jsnap)):
        assert got == want, {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                             if got.get(k) != want.get(k)}
    assert _spans_by_rid(ptel) == _spans_by_rid(jtel)
    assert triggers["torch"] == triggers["jax"] == []
    present = {k.split("{")[0] for sec in psnap.values() for k in sec}
    assert set(ptel.REQUIRED_SERVING_METRICS + ptel.REQUIRED_SCHED_METRICS) <= present
    # the shadow check ran on the per-request decode batches (the unified
    # tick has none, in either package) and passed
    checks = psnap["counters"].get("magi_numerics_shadow_checks", 0)
    assert (checks == 0) == (mode == "on")
    assert psnap["counters"].get("magi_numerics_shadow_breaches", 0) == 0
    census = pnum.get_numerics_census().numerics_snapshot()
    assert census["shadow_checks"] == checks and census["shadow_breaches"] == 0
    assert ptrace.get_flight_recorder().snapshot_ticks()[-1]["step"] == reps[-1].step
    assert ptel.get_event_buffer().dropped == 0


_PLANT = "corrupt_partial:site=split0,value=finite:8.0,field=out"


def _one_decode(pkg, rng):
    """One admission, a 16-row prefill and one decode step at 2 splits."""
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rows = [mk(16, HQ, D), mk(16, HK, D), mk(16, HK, D)]
    step = [mk(1, HQ, D), mk(1, HK, D), mk(1, HK, D)]
    if pkg == "jax":
        eng = JaxEngine(num_pages=16, num_kv_heads=HK, head_dim=D, page_size=8, max_seqs=2,
                        dtype=jnp.float32)
        conv = jnp.asarray
    else:
        eng = ServingEngine(num_pages=16, num_kv_heads=HK, head_dim=D, page_size=8,
                            max_seqs=2, dtype=torch.float32, device="cpu")
        conv = torch.from_numpy
    slot = eng.admit(20).slot
    eng.prefill(*map(conv, rows), slot)
    eng.decode_step(*map(conv, step), [slot], num_splits=2)
    return eng


@pytest.mark.parametrize("planted", [False, True])
def test_shadow_check_matches_jax(planted, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_SHADOW_SAMPLE_RATE", "1")
    if planted:
        monkeypatch.setenv("MAGI_ATTENTION_CHAOS", _PLANT)
    snaps = {}
    for pkg, tr, num, ch in (("jax", jtrace, jnum, jchaos), ("torch", ptrace, pnum, pchaos)):
        ch.reset_chaos()
        eng = _one_decode(pkg, np.random.default_rng(13))
        snap = num.get_numerics_census().numerics_snapshot()
        assert snap["shadow_checks"] == 1
        assert snap["shadow_breaches"] == int(planted)
        (rec,) = snap["shadow"]
        assert rec["breached"] == planted
        eng._flight.record_tick({"step": 1})  # the scheduler's tick end
        path = eng._flight.flush()
        assert (path is not None) == planted
        if planted:
            payload = json.load(open(path))
            assert payload["trigger"]["trigger"] == "numeric_drift"
            assert "numerics" in payload and "memory" in payload
        snaps[pkg] = (rec["violations"], rec["report"]["dtype"], rec["report"]["shape"])
    assert snaps["torch"] == snaps["jax"]
    if planted:
        assert "out.max_abs" in snaps["torch"][0]


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_planted_drift_dumps_at_the_tick_end(mode, monkeypatch, tmp_path):
    """Through the port's scheduler: the planted corruption breaches the
    shadow check of a per-request decode batch, and the tick's flush writes
    the ``numeric_drift`` dump with the live trace id and the numerics and
    memory sections."""
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
    monkeypatch.setenv("MAGI_ATTENTION_SHADOW_SAMPLE_RATE", "1")
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", _PLANT)
    pchaos.reset_chaos()
    _drive("torch", *_mixed_trace(16))
    dumps = sorted(tmp_path.glob("magi_flight_*.json"))
    assert dumps
    payload = json.load(open(dumps[0]))
    assert payload["trigger"]["trigger"] == "numeric_drift"
    assert payload["trigger"]["context"]["trace_id"].startswith("req-")
    (census,) = payload["numerics"].values()
    assert census["shadow_breaches"] >= 1
    (memory,) = payload["memory"].values()
    assert set(memory) == {"ledger", "fragmentation"}
    assert ptel.snapshot()["counters"][
        "magi_flight_recorder_dumps_total{trigger=numeric_drift}"] >= 1


def test_engine_fault_dump_holds_the_aborted_tick(monkeypatch, tmp_path):
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", "prefill_error:times=1")
    pchaos.reset_chaos()
    with pytest.raises(pchaos.ChaosInjectedError):
        _drive("torch", *_mixed_trace(16))
    (dump,) = tmp_path.glob("magi_flight_*.json")
    payload = json.load(open(dump))
    assert payload["trigger"]["trigger"] == "engine_fault"
    assert "ChaosInjectedError" in payload["ticks"][-1]["aborted"]


def test_metrics_server_starts_with_the_first_engine(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_METRICS_PORT", "0")
    assert ptel.ensure_metrics_server() is None  # 0 = off
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MAGI_ATTENTION_METRICS_PORT", str(port))
    try:
        ServingEngine(num_pages=8, num_kv_heads=HK, head_dim=D, page_size=8,
                      dtype=torch.float32, device="cpu")
        server = ptel.ensure_metrics_server()
        assert server is not None and server.port == port
    finally:
        ptel.stop_metrics_server()
