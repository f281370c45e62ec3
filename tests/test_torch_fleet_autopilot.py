"""The port's SLO autopilot (``fleet/autopilot.py``) against the JAX
package's: the same scripted windows give the same decisions (every hold
reason: steady, hysteresis, cooldown, fault, reversal, bounds), the same
registry series, and ``find_oscillations`` flags the same planted logs with
the same messages."""

import dataclasses

import pytest

from magiattention_tpu import telemetry as jax_tel
from magiattention_tpu.fleet import autopilot as jax_ap
from magiattention_tpu_torch import telemetry
from magiattention_tpu_torch.fleet import autopilot as ap
from magiattention_tpu_torch.telemetry.collectors import (
    M_FLEET_SLO_ATTAINMENT,
    M_KVCACHE_FREE,
    M_SCHED_BUDGET_UTIL,
    M_SCHED_QUEUE_DEPTH,
    M_TIER_FAULTS,
)


@pytest.fixture(autouse=True)
def _telemetry_on_then_off():
    for t in (telemetry, jax_tel):
        t.set_enabled(True)
        t.reset()
    yield
    for t in (telemetry, jax_tel):
        t.set_enabled(None)
        t.reset()


def _window(att, util=0.0, queue=0.0, free=None, faults=0):
    gauges = {M_FLEET_SLO_ATTAINMENT: att, M_SCHED_BUDGET_UTIL: util,
              M_SCHED_QUEUE_DEPTH: queue}
    if free is not None:
        gauges[M_KVCACHE_FREE] = free
    counters = {"magi_sched_steps_total": 8.0}
    if faults:
        counters[M_TIER_FAULTS + "{replica=1,tier=decode}"] = float(faults)
    return {"seconds": 8.0, "counters": counters, "gauges": gauges, "rates": {}}


# (window, overrides of the live knobs before it); cooldown 2, target 0.9,
# hysteresis 0.02 (0.88 sits on the float edge of the band: not under, yet
# more than the hysteresis below the target)
SCRIPT = (
    (_window(1.0, util=0.9), {}),                              # steady
    (_window(0.88), {}),                                       # hysteresis
    (_window(0.5, util=0.95, queue=3, free=100), {}),          # act: decode up
    (_window(0.5, util=0.95, queue=3, free=100), {}),          # cooldown, act: prefill up
    (_window(0.4, util=0.95, queue=3, free=100, faults=2), {}),  # fault
    (_window(1.0, util=0.1, free=200), {}),                    # reversal x2
    (_window(0.5, util=0.95, free=10), {}),                    # act: decode up
    (_window(0.5, util=0.95, free=10), {"prefill_budget": 1024}),  # cooldown, bounds, act
)


def _drive(pkg):
    pilot = pkg.Autopilot(pkg.SLOTargets(16, 8, 0.9), mode="tiered", cooldown_windows=2)
    knobs = {s.name: s.default for s in pilot.specs}
    out = []
    for window, overrides in SCRIPT:
        knobs.update(overrides)
        current = dict(knobs, __num_pages=256)
        d = pilot.evaluate(window, current=current)
        knobs.update(d.actions)
        out.append((d.window, d.actions, d.holds, d.facts, d.acted))
    return out, pilot.actions_taken


def _fleet_series(snap):
    return {kind: {k: v for k, v in series.items() if k.startswith("magi_fleet_")}
            for kind, series in snap.items() if isinstance(series, dict)}


def test_scripted_windows_decide_as_jax_decides():
    ours, our_actions = _drive(ap)
    our_snap = _fleet_series(telemetry.snapshot())
    theirs, their_actions = _drive(jax_ap)
    assert ours == theirs
    assert our_actions == their_actions
    assert our_snap == _fleet_series(jax_tel.snapshot())
    reasons = {r for _w, _a, holds, _f, _acted in ours for _k, r in holds}
    assert reasons == set(ap.HOLD_REASONS) == set(jax_ap.HOLD_REASONS)
    assert our_actions == [(2, "decode_budget", 48.0), (3, "prefill_budget", 96.0),
                           (6, "decode_budget", 64.0), (7, "admission_watermark", 2.0)]
    holds = our_snap["counters"]
    assert holds["magi_fleet_autopilot_holds_total{reason=reversal}"] == 2
    assert our_snap["gauges"]["magi_fleet_knob_value{knob=admission_watermark}"] == 2.0
    assert ap.find_oscillations(our_actions, cooldown_windows=2) == []


@pytest.mark.parametrize("mode", ["single", "tiered"])
def test_default_knob_specs_match_jax(mode):
    ours = [dataclasses.asdict(s) for s in ap.default_knob_specs(mode)]
    assert ours == [dataclasses.asdict(s) for s in jax_ap.default_knob_specs(mode)]


@pytest.mark.parametrize("make", [
    lambda m: m.default_knob_specs("pipeline"),
    lambda m: m.SLOTargets(ttft_p99_ticks=0),
    lambda m: m.SLOTargets(toklat_p99_ticks=-1),
    lambda m: m.SLOTargets(attainment_target=0.0),
    lambda m: m.KnobSpec("k", lo=4, hi=8, step=1, default=2),
    lambda m: m.KnobSpec("k", lo=0, hi=8, step=0, default=2),
    lambda m: m.Autopilot(cooldown_windows=0),
    lambda m: m.find_oscillations([], cooldown_windows=0),
], ids=["mode", "ttft", "toklat", "target", "default", "step", "cooldown", "checker"])
def test_refusals_match_jax(make):
    with pytest.raises(ValueError) as ours:
        make(ap)
    with pytest.raises(ValueError) as theirs:
        make(jax_ap)
    assert str(ours.value) == str(theirs.value)


def test_slo_and_cooldown_defaults_come_from_the_flags(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_FLEET_SLO_TTFT", "6")
    monkeypatch.setenv("MAGI_ATTENTION_FLEET_SLO_TOKLAT", "2.5")
    monkeypatch.setenv("MAGI_ATTENTION_FLEET_COOLDOWN", "5")
    slo = ap.SLOTargets()
    assert (slo.ttft_p99_ticks, slo.toklat_p99_ticks) == (6.0, 2.5)
    assert slo.to_json() == jax_ap.SLOTargets().to_json()
    assert ap.Autopilot().cooldown_windows == jax_ap.Autopilot().cooldown_windows == 5
    assert slo.met_by(6.0, 2.5) and not slo.met_by(6.5, 1.0)
    spec = ap.KnobSpec("k", lo=0, hi=10, step=3, default=2)
    assert (spec.clamp(11.4), spec.clamp(-1), spec.clamp(4.6)) == (10, 0, 5)


OSC_LOGS = {
    "clean": [(0, "decode_budget", 48.0), (3, "decode_budget", 64.0),
              (9, "decode_budget", 48.0), (1, "prefill_budget", 96.0)],
    "too_soon": [(0, "decode_budget", 48.0), (2, "decode_budget", 64.0)],
    "reversal": [(0, "token_budget", 96.0), (3, "token_budget", 128.0),
                 (7, "token_budget", 96.0)],
    "limit_cycle": [(w, "token_budget", 96.0 if w % 2 == 0 else 64.0) for w in range(6)],
    "unsorted": [(6, "k", 3.0), (0, "k", 1.0), (3, "k", 2.0), (4, "j", 1.0), (5, "j", 0.0)],
}


@pytest.mark.parametrize("log", sorted(OSC_LOGS))
def test_find_oscillations_matches_jax(log):
    ours = ap.find_oscillations(OSC_LOGS[log], cooldown_windows=3)
    assert ours == jax_ap.find_oscillations(OSC_LOGS[log], cooldown_windows=3)
    assert (ours == []) == (log == "clean")
    if log == "limit_cycle":
        assert any("windows apart" in e for e in ours)
        assert any("reversal" in e for e in ours)
