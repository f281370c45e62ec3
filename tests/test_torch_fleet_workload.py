"""The port's fleet traces (``fleet/workload.py``) and flags against the JAX
package's: the same arguments give byte-identical trace JSON for every
arrival kind, ``scale_rate`` and ``validate_trace`` agree, and the four
``MAGI_ATTENTION_FLEET_*`` readers have JAX's defaults and messages and stay
out of ``flags_fingerprint``."""

import dataclasses
import json

import pytest

from magiattention_tpu import env as jax_env
from magiattention_tpu.fleet import workload as jax_wl
from magiattention_tpu_torch import env
from magiattention_tpu_torch.api.interface import flags_fingerprint
from magiattention_tpu_torch.fleet import workload as wl

CASES = {
    "poisson": dict(arrival="poisson", rate=1.3),
    "mmpp": dict(arrival="mmpp", rate=0.8, burst_rate=9.0, burst_prob=0.1, calm_prob=0.3),
    "mmpp_default_burst": dict(arrival="mmpp", rate=0.5),
    "diurnal": dict(arrival="diurnal", rate=2.0, diurnal_period=24, diurnal_amplitude=0.9),
    "wide": dict(arrival="poisson", rate=0.7, page_size=128, prefix_pool=4, prefix_pages=4,
                 zipf_alpha=1.2, suffix_len_range=(64, 1536), output_len_median=16,
                 output_len_max=64, vocab=128256, priority_levels=3),
}


def _dump(trace) -> str:
    return json.dumps(trace.to_json(), indent=1, sort_keys=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_json_is_byte_identical_to_jax(case, tmp_path):
    kw = dict(seed=17, horizon_ticks=40, **CASES[case])
    trace = wl.generate_trace(case, **kw)
    jtrace = jax_wl.generate_trace(case, **kw)
    assert trace.num_requests > 0
    assert _dump(trace) == _dump(jtrace)
    assert list(trace.offered_per_tick()) == list(jtrace.offered_per_tick())
    # the artifact round-trips, and each package reads the other's file
    trace.save(tmp_path / "port.json")
    jtrace.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert wl.FleetTrace.load(tmp_path / "jax.json") == trace
    assert wl.validate_trace(trace) == [] == jax_wl.validate_trace(jtrace)


def test_trace_generation_is_deterministic_and_format_is_jax_format():
    a = wl.generate_trace("d", seed=3, horizon_ticks=20)
    b = wl.generate_trace("d", seed=3, horizon_ticks=20)
    assert a == b
    assert wl.FLEET_TRACE_FORMAT == jax_wl.FLEET_TRACE_FORMAT == "magi-fleet-trace/v1"
    assert wl.ARRIVAL_KINDS == jax_wl.ARRIVAL_KINDS


@pytest.mark.parametrize("kw", [
    dict(horizon_ticks=0),
    dict(horizon_ticks=8, shared_fraction=1.5),
    dict(horizon_ticks=8, arrival="weibull"),
], ids=["horizon", "shared_fraction", "arrival"])
def test_generator_errors_match_jax(kw):
    with pytest.raises(ValueError) as ours:
        wl.generate_trace("bad", seed=1, **kw)
    with pytest.raises(ValueError) as theirs:
        jax_wl.generate_trace("bad", seed=1, **kw)
    assert str(ours.value) == str(theirs.value)


def test_from_json_refuses_another_format():
    d = wl.generate_trace("f", seed=2, horizon_ticks=4).to_json()
    d["format"] = "magi-fleet-trace/v0"
    with pytest.raises(ValueError) as ours:
        wl.FleetTrace.from_json(d)
    with pytest.raises(ValueError) as theirs:
        jax_wl.FleetTrace.from_json(d)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw,rate", [
    (dict(rate=1.0), 4.0),
    (dict(rate=2.0, burst_rate=12.0), 0.5),
    (dict(rate=0.0, burst_rate=3.0), 2.0),
    (dict(seed=9), 1.5),
])
def test_scale_rate_matches_jax(kw, rate):
    assert wl.scale_rate(kw, rate) == jax_wl.scale_rate(kw, rate)


def _planted(pkg):
    trace = pkg.generate_trace("lint", seed=5, horizon_ticks=12, rate=2.0, page_size=4,
                               prefix_pages=2, suffix_len_range=(1, 3))
    reqs = list(trace.requests)
    req = pkg.TraceRequest
    reqs[1] = dataclasses.replace(reqs[1], rid=reqs[0].rid)
    reqs[2] = dataclasses.replace(reqs[2], arrival_tick=99)
    reqs[3] = dataclasses.replace(reqs[3], output_len=0)
    reqs.append(req(rid=1000, arrival_tick=0, prompt_tokens=(), output_len=1))
    reqs.append(req(rid=1001, arrival_tick=0, prompt_tokens=(1, 2), output_len=1, prefix_id=0))
    return dataclasses.replace(trace, requests=tuple(reqs))


def test_validate_trace_messages_match_jax():
    errs = wl.validate_trace(_planted(wl))
    assert errs == jax_wl.validate_trace(_planted(jax_wl))
    for want in ("duplicate rid", "outside [0, 12)", "output_len 0 < 1", "empty prompt",
                 "does not extend past one page (4)"):
        assert any(want in e for e in errs), want


FLAGS = {
    "MAGI_ATTENTION_FLEET_WINDOW": ("fleet_window_ticks", 16, "0", "8", 8),
    "MAGI_ATTENTION_FLEET_COOLDOWN": ("fleet_cooldown_windows", 3, "-1", "5", 5),
    "MAGI_ATTENTION_FLEET_SLO_TTFT": ("fleet_slo_ttft_ticks", 16.0, "0", "12.5", 12.5),
    "MAGI_ATTENTION_FLEET_SLO_TOKLAT": ("fleet_slo_toklat_ticks", 8.0, "-2.5", "4", 4.0),
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_fleet_flags_read_as_jax_reads_them(name, monkeypatch):
    reader, default, bad, good, parsed = FLAGS[name]
    monkeypatch.delenv(name, raising=False)
    assert getattr(env, reader)() == getattr(jax_env, reader)() == default
    monkeypatch.setenv(name, good)
    assert getattr(env, reader)() == getattr(jax_env, reader)() == parsed
    monkeypatch.setenv(name, bad)
    with pytest.raises(ValueError) as ours:
        getattr(env, reader)()
    with pytest.raises(ValueError) as theirs:
        getattr(jax_env, reader)()
    assert str(ours.value) == str(theirs.value)


def test_fleet_flags_are_not_in_flags_fingerprint(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    before = flags_fingerprint()
    for name, (_reader, _default, _bad, good, _parsed) in FLAGS.items():
        monkeypatch.setenv(name, good)
    assert flags_fingerprint() == before
    # and an entry point's flag check still passes with them set
    env.refuse_unhonoured_flags("fleet")
