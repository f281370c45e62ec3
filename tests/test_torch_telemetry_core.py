"""The port's telemetry spine against the JAX package's on the CPU: the same
recorder calls give equal registry snapshots and byte-identical Prometheus
text (which ``parse_prometheus_text`` round-trips), the cross-rank merges
agree, the span ring honours its size, the compile tracker counts the
builds ``csrc`` makes and arms a recompile storm, the flight recorder's
triggers and dumps, the scrape server answers, and the eight telemetry
flags are read with the JAX package's validation (none of them in
``flags_fingerprint``; ``MAGI_ATTENTION_NUMERICS=census`` still refused)."""

import json
import types
import urllib.request

import numpy as np
import pytest

from magiattention_tpu import env as jenv
from magiattention_tpu import telemetry as jtel
from magiattention_tpu.telemetry import trace as jtrace
from magiattention_tpu_torch import env as penv
from magiattention_tpu_torch import telemetry as ptel
from magiattention_tpu_torch.telemetry import trace as ptrace


@pytest.fixture(autouse=True)
def _fresh():
    for tel in (jtel, ptel):
        tel.set_enabled(True)
        tel.reset()
        tel.reset_compile_tracker()
    yield
    for tel in (jtel, ptel):
        tel.set_enabled(None)
        tel.reset()
        tel.reset_compile_tracker()


def _drive_recorders(tel, seed):
    """One seeded sequence of the recorder calls both packages share."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        b = int(rng.integers(1, 9))
        tel.record_decode_step(batch_size=b, num_splits=int(rng.integers(0, 4)),
                               max_seq_len=int(rng.integers(1, 4096)),
                               cascade_groups=int(rng.integers(0, 3)))
        tel.record_prefill(int(rng.integers(1, 600)))
        tel.record_kvcache_state({"pages_total": 64, "pages_in_use": int(rng.integers(0, 64)),
                                  "occupancy_ratio": float(rng.random()), "active_seqs": b,
                                  "page_size": 16, "shared_pages": int(rng.integers(0, 5))})
        for admitted, reason, evicted in ((True, "ok", ()), (False, "pool_exhausted", (1, 2))):
            tel.record_admission(types.SimpleNamespace(admitted=admitted, reason=reason,
                                                       evicted=evicted))
        tel.record_prefix_lookup(hit=bool(rng.random() < 0.5),
                                 matched_tokens=int(rng.integers(0, 64)))
        tel.record_prefix_registered(int(rng.integers(0, 3)), int(rng.integers(0, 9)))
        tel.record_prefix_cow()
        tel.record_prefix_eviction(int(rng.integers(1, 4)), int(rng.integers(0, 9)))
        tel.record_sched_step(waiting=int(rng.integers(0, 5)), active=b,
                              tokens_used=int(rng.integers(0, 256)),
                              prefill_chunks=int(rng.integers(0, 3)),
                              decode_ran=bool(rng.random() < 0.7),
                              budget_utilization=float(rng.random()),
                              queue_depth=int(rng.integers(0, 5)))
        for rec in ("record_request_queue_time", "record_request_ttft",
                    "record_request_token_latency"):
            getattr(tel, rec)(float(rng.exponential(0.01)),
                              tier=None if rng.random() < 0.5 else "decode")
        tel.record_page_stream(pages=int(rng.integers(1, 9)), nbytes=int(rng.integers(1, 1 << 20)),
                               queue_depth=int(rng.integers(0, 3)))
        tel.record_stream_queue_depth(int(rng.integers(0, 3)))
        tel.record_tier_fault("decode", int(rng.integers(0, 2)))
        tel.record_tier_state("decode", pages_in_use=int(rng.integers(0, 64)), active=b,
                              replica=int(rng.integers(0, 2)))
        tel.record_tier_state("prefill", pages_in_use=int(rng.integers(0, 64)), active=b)
        tel.record_guard_check(f"split{int(rng.integers(0, 3))}")
        tel.record_guard_violation("stage0")
        tel.record_guard_repair("merged")
        tel.record_degraded_path(("plan_build_error", "hops_build_error")[int(rng.integers(0, 2))])
        tel.record_shadow_check(float(rng.integers(0, 100)), breached=bool(rng.random() < 0.3))
        tel.record_admission_watermark(int(rng.integers(0, 8)), int(rng.integers(0, 64)))
        tel.record_compile(f"decode[b={b}]", float(rng.random()), int(rng.integers(1, 9)))
        tel.record_plan_solver(float(rng.random()) * 1e-3, cache_hit=bool(rng.random() < 0.5))
        tel.record_tick_programs(step=1, start_s=1.0, wall_s=0.01, programs=["a", "a", "b"],
                                 compiles=1, solver_s=0.001, compile_s=0.002, device_s=0.003,
                                 residual_s=-0.001)
    return tel.snapshot()


@pytest.mark.parametrize("seed", range(3))
def test_same_recorder_calls_give_the_same_snapshot_and_prometheus_text(seed):
    jsnap, psnap = _drive_recorders(jtel, seed), _drive_recorders(ptel, seed)
    assert psnap == jsnap
    text = ptel.render_prometheus(psnap)
    assert text == jtel.render_prometheus(jsnap)
    parsed = ptel.parse_prometheus_text(text)
    assert parsed == jtel.parse_prometheus_text(text)
    # every counter and gauge series round-trips through the exposition
    for section in ("counters", "gauges"):
        for key, val in psnap[section].items():
            assert parsed[key] == float(val), key
    for key, h in psnap["histograms"].items():
        name, _, labels = key.partition("{")
        count_key = name + "_count" + ("{" + labels if labels else "")
        assert parsed[count_key] == h["count"]
    # the summary reads the same registry
    assert "decode: steps 4" in ptel.telemetry_summary()


def test_escaped_label_values_round_trip():
    reg = ptel.MetricsRegistry()
    reg.gauge_set("m", 1.5, label='a"b\\nc\nd')
    snap = reg.snapshot()
    text = ptel.render_prometheus(snap)
    assert text == jtel.render_prometheus(snap)
    assert ptel.parse_prometheus_text(text) == {'m{label=a"b\\nc\nd}': 1.5}


def test_merges_agree_with_jax():
    snaps = [_drive_recorders(ptel, s) for s in range(3)]
    ptel.reset()
    snaps.append({})  # a rank that recorded nothing
    assert ptel.merge_snapshots(snaps) == jtel.merge_snapshots(snaps)
    assert ptel.merge_snapshots(snaps, ranks=list("abcd")) == jtel.merge_snapshots(
        snaps, ranks=list("abcd"))
    with pytest.raises(ValueError, match="one-to-one"):
        ptel.merge_snapshots(snaps, ranks=[0])
    traces = []
    for r in range(2):
        buf = ptel.EventBuffer(maxlen=8)
        buf.record("host", 1.0 + r, 0.5, {"r": r})
        buf.record("tick", 2.0, 0.1, track="scheduler ticks")
        ev = buf.events()
        traces.append({"traceEvents": ptel.trace_metadata_events(
            ev, thread_names=buf.track_names()) + ev})
    assert ptel.merge_chrome_traces(traces) == jtel.merge_chrome_traces(traces)
    assert ptel.merge_chrome_traces(traces, labels=["x", "y"]) == jtel.merge_chrome_traces(
        traces, labels=["x", "y"])
    # the loopback aggregate in one process
    assert ptel.aggregate_across_mesh(snaps[0]) == jtel.merge_snapshots([snaps[0]], ranks=[0])


@pytest.mark.parametrize("size", [1, 3])
def test_span_ring_honours_its_size(size, monkeypatch):
    from magiattention_tpu_torch.telemetry import events

    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_RING_SIZE", str(size))
    monkeypatch.setattr(events, "_buffer", None)
    for i in range(size + 2):
        ptel.record_event(f"s{i}", float(i), 0.0, {"i": i})
    buf = ptel.get_event_buffer()
    assert len(buf) == size and buf.dropped == 2
    assert [e["args"]["i"] for e in buf.events()] == list(range(2, size + 2))
    assert ptel.snapshot()["counters"]["magi_trace_events_dropped_total"] == 2
    ptel.set_enabled(False)
    ptel.record_event("off", 0.0, 0.0)
    assert buf.dropped == 2  # the disabled path records nothing


def test_request_traces_match_jax():
    """The same span helper calls give the same reconstructed trees."""
    trees = {}
    for tel, tr in ((jtel, jtrace), (ptel, ptrace)):
        tr.reset_request_traces()
        tr.span_submit("t1", 1, prompt_len=10, max_new_tokens=2, priority=0)
        tr.span_admitted("t1", 1, slot=0, prefix_len=0, shared_pages=0, evicted=0,
                         queue_s=0.25)
        tr.span_prefill_chunk("t1", 1, tokens=10, chunk_idx=0, start=0, start_s=1.0,
                              duration_s=0.5, program="prefill[start=0,t=10]")
        tr.span_decode_step("t1", 1, token_idx=0, batch=1, num_splits=1, cascade_group=None,
                            start_s=2.0, duration_s=0.1, ttft_s=0.75)
        tr.span_decode_step("t1", 1, token_idx=1, batch=1, num_splits=1, cascade_group=None,
                            start_s=3.0, duration_s=0.1, token_latency_s=0.5)
        tr.span_finished("t1", 1, tokens=2)
        tr.span_submit("t2", 2, prompt_len=4, max_new_tokens=1)
        out = tel.export_request_traces()
        trees[tel] = {k: (v.rid, v.partial, v.complete, v.stats,
                          [(s["kind"], s["seq"], s["attrs"]) for s in v.spans])
                      for k, v in out.items()}
    assert trees[ptel] == trees[jtel]
    assert trees[ptel]["t1"][2] and not trees[ptel]["t2"][2]  # complete / not terminal
    chrome = ptel.request_traces_to_chrome()
    names = [e["args"]["name"] for e in chrome["traceEvents"] if e["name"] == "process_name"]
    assert names == ["request 1 [t1]", "request 2 [t2]"]


def test_flight_recorder_triggers_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path))
    fr = ptel.FlightRecorder(depth=4, storm_threshold=2)
    assert fr.trigger("numerical_guard") is None  # no tick recorded: arms, writes nothing
    fr.record_tick({"step": 1})
    fr.note_admission(False, "pool_exhausted")
    fr.note_admission(False, "pool_exhausted")  # the storm arms a deferred dump
    path = fr.flush()
    payload = json.load(open(path))
    assert payload["trigger"]["trigger"] == "admission_rejection_storm"
    assert [a["reason"] for a in payload["admissions"]] == ["pool_exhausted"] * 2
    for i in range(6):
        fr.record_tick({"step": i + 2})
    assert len(fr.snapshot_ticks()) == 4
    path = fr.trigger("degraded_path", reason="plan_build_error")
    payload = json.load(open(path))
    assert payload["ticks_dropped"] == 3 and payload["trigger"]["context"] == {
        "reason": "plan_build_error"}
    assert ptel.snapshot()["counters"] == {
        "magi_flight_recorder_dumps_total{trigger=admission_rejection_storm}": 1.0,
        "magi_flight_recorder_dumps_total{trigger=degraded_path}": 1.0}
    assert not ptel.FlightRecorder(depth=0).enabled


def test_compile_tracker_counts_host_builds_and_arms_a_storm(tmp_path, monkeypatch):
    """``csrc.build_host`` into an empty build directory is one compile under
    the live label; loading the built library again is none. Three builds
    of one label with the storm threshold 3 arm ``recompile_storm``, as in
    the JAX package."""
    from magiattention_tpu_torch import csrc

    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path / "build"))
    tracker = ptel.get_compile_tracker()
    with ptel.program("host[entry_table]"):
        csrc.build_host()
        csrc.build_host()  # already built: no compile
    stats = tracker.stats()
    assert list(stats) == ["host[entry_table]"] and stats["host[entry_table]"]["count"] == 1
    snap = ptel.snapshot()
    assert snap["counters"] == {"magi_compile_total{program=host[entry_table]}": 1.0}
    assert snap["gauges"]["magi_jit_cache_entries"] == 1
    monkeypatch.setenv("MAGI_ATTENTION_RECOMPILE_STORM_THRESHOLD", "3")
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path))
    for tr in (jtrace, ptrace):
        tr.reset_flight_recorder().record_tick({"step": 7})
    armed = {}
    for tel, tr in ((jtel, jtrace), (ptel, ptrace)):
        tel.reset_compile_tracker()
        trk = tel.get_compile_tracker()
        trk.note_tick(7)
        for _ in range(3):
            trk.note_compile(0.5, label="decode[b=4]")
        armed[tel] = tr.get_flight_recorder()._armed
        assert trk.stats() == {"decode[b=4]": {"count": 3, "total_s": 1.5}}
    for rec in armed.values():
        rec.pop("t")
    assert armed[ptel] == armed[jtel]
    assert armed[ptel]["trigger"] == "recompile_storm"
    assert armed[ptel]["context"]["tick"] == 7
    for tr in (jtrace, ptrace):
        tr.reset_flight_recorder()


def test_metrics_server_serves_the_registry():
    _drive_recorders(ptel, 0)
    server = ptel.start_metrics_server(port=0, host="127.0.0.1")
    try:
        assert ptel.ensure_metrics_server() is server
        base = f"http://127.0.0.1:{server.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        assert text == ptel.render_prometheus(ptel.snapshot())
        assert ptel.parse_prometheus_text(text)
        assert urllib.request.urlopen(base + "/healthz", timeout=10).read() == b"ok\n"
        body = json.loads(urllib.request.urlopen(base + "/metrics.json", timeout=10).read())
        assert body == json.loads(json.dumps(ptel.snapshot(), sort_keys=True))
    finally:
        ptel.stop_metrics_server()
    assert ptel.ensure_metrics_server() is None  # MAGI_ATTENTION_METRICS_PORT unset


def test_snapshot_delta_matches_jax():
    prev = _drive_recorders(ptel, 1)
    curr = _drive_recorders(ptel, 2)
    assert ptel.snapshot_delta(prev, curr, seconds=2.0) == jtel.snapshot_delta(
        prev, curr, seconds=2.0)


_FLAGS = [  # (variable, value, accessor)
    ("MAGI_ATTENTION_TELEMETRY", "yes", "is_telemetry_enabled"),
    ("MAGI_ATTENTION_TELEMETRY", "0", "is_telemetry_enabled"),
    ("MAGI_ATTENTION_TELEMETRY_RING_SIZE", "17", "telemetry_ring_size"),
    ("MAGI_ATTENTION_TELEMETRY_RING_SIZE", "many", "telemetry_ring_size"),
    ("MAGI_ATTENTION_TRACE_DIR", "/tmp/x", "trace_dir"),
    ("MAGI_ATTENTION_METRICS_PORT", "9464", "metrics_port"),
    ("MAGI_ATTENTION_METRICS_PORT", "70000", "metrics_port"),
    ("MAGI_ATTENTION_METRICS_PORT", "-1", "metrics_port"),
    ("MAGI_ATTENTION_FLIGHT_RECORDER_DEPTH", "0", "flight_recorder_depth"),
    ("MAGI_ATTENTION_FLIGHT_RECORDER_DEPTH", "-3", "flight_recorder_depth"),
    ("MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD", "0.25", "mem_pressure_threshold"),
    ("MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD", "1.5", "mem_pressure_threshold"),
    ("MAGI_ATTENTION_RECOMPILE_STORM_THRESHOLD", "4", "recompile_storm_threshold"),
    ("MAGI_ATTENTION_RECOMPILE_STORM_THRESHOLD", "-1", "recompile_storm_threshold"),
    ("MAGI_ATTENTION_SHADOW_SAMPLE_RATE", "4", "shadow_sample_rate"),
    ("MAGI_ATTENTION_SHADOW_SAMPLE_RATE", "-2", "shadow_sample_rate"),
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("var,value,accessor", _FLAGS)
def test_flags_read_with_jax_validation(var, value, accessor, monkeypatch):
    from magiattention_tpu_torch.api.interface import flags_fingerprint

    base = flags_fingerprint()
    monkeypatch.setenv(var, value)
    got = _outcome(getattr(penv, accessor))
    assert got == _outcome(getattr(jenv, accessor))
    if got[0] == "ok":
        assert flags_fingerprint() == base  # observability never re-keys


def test_numerics_census_is_still_refused(monkeypatch):
    """The census is honoured now (``telemetry/numerics.py``): only
    ``MAGI_ATTENTION_VALIDATE`` is still refused, and a numerics value
    outside its domain raises the JAX package's message."""
    monkeypatch.setenv("MAGI_ATTENTION_NUMERICS", "census")
    penv.refuse_unhonoured_flags("here")
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", "plan")
    with pytest.raises(ValueError, match="A.18"):
        penv.refuse_unhonoured_flags("here")
    monkeypatch.delenv("MAGI_ATTENTION_VALIDATE")
    monkeypatch.setenv("MAGI_ATTENTION_NUMERICS", "full")
    with pytest.raises(ValueError) as got:
        penv.refuse_unhonoured_flags("here")
    with pytest.raises(ValueError) as want:
        jenv.numerics_mode()
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("MAGI_ATTENTION_NUMERICS", "off")
    penv.refuse_unhonoured_flags("here")
