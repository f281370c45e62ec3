"""The port's fleet simulator and capacity planner (``fleet/sim.py``,
``fleet/capacity.py``) against the JAX package's: the same seeded trace
through the same stack gives an equal ``FleetReport`` (every request, every
window, the action log) in single and tiered mode, with and without the
autopilot, under chaos, and in the burst and fault scenarios of the JAX
fleet gate; the registry's ``magi_fleet_*`` series are equal; and a
subclass can replace the device layer and the clock."""

import contextlib
import json

import pytest

from magiattention_tpu import fleet as jax_fleet
from magiattention_tpu import telemetry as jax_tel
from magiattention_tpu.fleet import capacity as jax_capacity
from magiattention_tpu_torch import fleet
from magiattention_tpu_torch import telemetry
from magiattention_tpu_torch.analysis.lifecycle import stubbed_device_layer
from magiattention_tpu_torch.fleet import capacity
from magiattention_tpu_torch.telemetry.collectors import REQUIRED_FLEET_METRICS

SLO = dict(ttft_p99_ticks=16.0, toklat_p99_ticks=8.0, attainment_target=0.9)
# the JAX fleet gate's undersized static config (exps/run_fleet_check.py)
STATIC_SIM = dict(mode="tiered", window_ticks=8, dp=2, prefill_budget=32, decode_budget=16,
                  chunk=8, num_pages=256, max_seqs=32, max_pages_per_seq=8)


@pytest.fixture(autouse=True)
def _telemetry_off_after(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_CHAOS", raising=False)
    yield
    for t in (telemetry, jax_tel):
        t.set_enabled(None)
        t.reset()
        t.reset_request_traces()


def _fleet_series(snap):
    return {kind: {k: v for k, v in series.items() if k.startswith("magi_fleet_")}
            for kind, series in snap.items() if isinstance(series, dict)}


def _replay(pkg, tel, trace_kw, *, autopilot=None, **sim):
    trace = pkg.generate_trace(**trace_kw)
    slo = pkg.SLOTargets(**SLO)
    pilot = None
    if autopilot is not None:
        pilot = pkg.Autopilot(slo, mode=sim.get("mode", "tiered"), **autopilot)
    report = pkg.FleetSimulator(trace, autopilot=pilot, slo=slo, **sim).run()
    return report, _fleet_series(tel.snapshot())


def _both(trace_kw, **kw):
    ours, our_series = _replay(fleet, telemetry, trace_kw, **kw)
    theirs, their_series = _replay(jax_fleet, jax_tel, trace_kw, **kw)
    assert json.dumps(ours.to_json(include_requests=True), sort_keys=True) == json.dumps(
        theirs.to_json(include_requests=True), sort_keys=True)
    assert our_series == their_series
    return ours, our_series


def _light(name, seed, horizon, rate):
    return dict(name=name, seed=seed, horizon_ticks=horizon, arrival="poisson", rate=rate,
                output_len_max=8, suffix_len_range=(2, 8))


# the JAX package's tests/test_fleet/test_sim.py cases
REPLAYS = {
    "single_static": (_light("light", 41, 48, 1.0), dict(mode="single")),
    "tiered_static": (_light("light", 41, 48, 1.0), dict(mode="tiered")),
    "single_autopilot": (
        dict(name="sat1", seed=53, horizon_ticks=48, arrival="poisson", rate=3.0,
             output_len_max=8, suffix_len_range=(2, 8)),
        dict(mode="single", autopilot=dict(cooldown_windows=2), window_ticks=8,
             token_budget=32)),
    "tiered_autopilot": (
        dict(name="sat", seed=53, horizon_ticks=48, arrival="poisson", rate=3.0,
             output_len_max=8, suffix_len_range=(2, 8)),
        dict(mode="tiered", autopilot=dict(cooldown_windows=2), window_ticks=8,
             prefill_budget=32, decode_budget=16)),
    "tiered_decode_fault": (
        _light("light", 59, 64, 1.5),
        dict(mode="tiered", autopilot=dict(cooldown_windows=3), window_ticks=8,
             chaos_ticks={t: "decode_fault:times=1" for t in (12, 20, 28)})),
    "single_pool_exhaust": (_light("light", 61, 32, 1.0),
                            dict(mode="single", chaos_ticks={6: "pool_exhaust"})),
}


@pytest.mark.parametrize("case", sorted(REPLAYS))
def test_report_equals_jax(case):
    trace_kw, kw = REPLAYS[case]
    rep, series = _both(trace_kw, **kw)
    assert rep.offered > 0 and rep.finished == rep.offered
    counters = series["counters"]
    assert counters["magi_fleet_offered_requests_total"] == rep.offered
    assert counters["magi_fleet_served_requests_total"] == rep.finished
    assert counters.get("magi_fleet_slo_ok_total", 0) == rep.slo_ok
    assert series["histograms"]["magi_fleet_ttft_ticks"]["count"] == rep.finished
    if "chaos_ticks" in kw:
        assert rep.chaos_faults == len(kw["chaos_ticks"])
    if case.endswith("_autopilot"):
        # saturation on a small static config: the autopilot acts, and the
        # whole fleet catalog is live
        assert rep.actions
        names = {k.split("{", 1)[0] for d in series.values() for k in d}
        assert set(REQUIRED_FLEET_METRICS) <= names
    if "autopilot" in kw:
        assert fleet.find_oscillations(
            rep.actions, cooldown_windows=kw["autopilot"]["cooldown_windows"]) == []
        last = {k: v for _w, k, v in rep.actions}
        assert all(rep.final_knobs[k] == v for k, v in last.items())
    if case == "tiered_decode_fault":
        held = [w for w in rep.windows if ["*", "fault"] in w.get("holds", [])]
        assert held and not any(w.get("actions") for w in held)


GATE = {
    "burst": (dict(name="burst", seed=11, horizon_ticks=160, arrival="mmpp", rate=0.8,
                   burst_rate=12.0, burst_prob=0.04, calm_prob=0.10, output_len_max=16,
                   suffix_len_range=(2, 10)), None),
    "fault": (dict(name="fault", seed=23, horizon_ticks=160, arrival="poisson", rate=4.5,
                   output_len_max=16, suffix_len_range=(2, 10)),
              {t: "decode_fault:times=1" for t in (40, 44, 48, 52, 56, 60)}),
}


@pytest.mark.parametrize("scenario", sorted(GATE))
def test_gate_scenario_equals_jax(scenario):
    trace_kw, chaos = GATE[scenario]
    static, _ = _both(trace_kw, chaos_ticks=chaos, **STATIC_SIM)
    auto, _ = _both(trace_kw, chaos_ticks=chaos, autopilot=dict(cooldown_windows=3),
                    **STATIC_SIM)
    # the JAX gate's own claims hold for the port's reports
    assert auto.attainment_offered >= static.attainment_offered + 0.1
    assert auto.goodput_tokens > static.goodput_tokens
    assert auto.actions and fleet.find_oscillations(auto.actions, cooldown_windows=3) == []
    if chaos:
        assert auto.chaos_faults == len(chaos)


class _Oscillating:
    """The JAX gate's planted controller: the first knob up and down every
    window, past the cooldown bookkeeping (a mixin over either package's
    Autopilot)."""

    def evaluate(self, window, *, current):
        spec = self.specs[0]
        cur = float(current.get(spec.name, spec.default))
        direction = +1 if self._window % 2 == 0 else -1
        decision = self._decision(window=self._window,
                                  actions={spec.name: spec.clamp(cur + direction * spec.step)},
                                  holds=(), facts={})
        self.history.append(decision)
        self._window += 1
        return decision


def test_planted_oscillator_is_caught_as_jax_catches_it():
    trace_kw = dict(name="selftest", seed=71, horizon_ticks=64, arrival="poisson", rate=1.5,
                    output_len_max=8, suffix_len_range=(2, 8))
    found = []
    for pkg, mod in ((fleet, fleet.autopilot), (jax_fleet, jax_fleet.autopilot)):
        cls = type("Osc", (_Oscillating, pkg.Autopilot), {"_decision": mod.AutopilotDecision})
        bad = cls(pkg.SLOTargets(**SLO), mode="tiered", cooldown_windows=3)
        rep = pkg.FleetSimulator(pkg.generate_trace(**trace_kw), autopilot=bad,
                                 **STATIC_SIM).run()
        found.append((rep.actions, pkg.find_oscillations(rep.actions, cooldown_windows=3)))
    assert found[0] == found[1]
    actions, osc = found[0]
    assert len(actions) >= 4
    assert any("windows apart" in e for e in osc) and any("reversal" in e for e in osc)


SMALL_PROBE = dict(capacity.DEFAULT_TRACE_KWARGS, horizon_ticks=48)


@pytest.mark.parametrize("mode,sim", [
    ("single", {"token_budget": 64}),
    ("tiered", {"dp": 2, "prefill_budget": 64, "decode_budget": 32}),
])
def test_capacity_search_equals_jax(mode, sim):
    kw = dict(mode=mode, sim_kwargs=sim, trace_kwargs=SMALL_PROBE, iterations=2,
              lo_rate=0.5, hi_rate=12.0)
    ours = capacity.capacity_search(slo=fleet.SLOTargets(**SLO), **kw)
    assert ours == jax_capacity.capacity_search(slo=jax_fleet.SLOTargets(**SLO), **kw)
    assert ours["rate"] > 0


def test_capacity_curve_file_equals_jax(tmp_path):
    cfg = (capacity.DEFAULT_CAPACITY_CONFIGS[0],)
    kw = dict(configs=cfg, trace_kwargs=dict(SMALL_PROBE, horizon_ticks=24), iterations=1)
    ours = capacity.write_capacity_curve(tmp_path / "port.json",
                                         slo=fleet.SLOTargets(**SLO), **kw)
    theirs = jax_capacity.write_capacity_curve(tmp_path / "jax.json",
                                               slo=jax_fleet.SLOTargets(**SLO), **kw)
    assert ours == theirs
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert capacity.DEFAULT_CAPACITY_CONFIGS == jax_capacity.DEFAULT_CAPACITY_CONFIGS
    assert capacity.DEFAULT_TRACE_KWARGS == jax_capacity.DEFAULT_TRACE_KWARGS


class _CountingClock(fleet.TickClock):
    def __init__(self):
        self.sets = 0
        super().__init__()

    @property
    def t(self):
        return self._t

    @t.setter
    def t(self, value):
        self.sets += 1
        self._t = value


class _Seamed(fleet.FleetSimulator):
    """Overrides the two seams: the clock counts its assignments, the device
    layer counts its entries (and still stubs the device work)."""

    def _make_clock(self):
        self.clock = _CountingClock()
        return self.clock

    @contextlib.contextmanager
    def _device_layer(self):
        self.entered = getattr(self, "entered", 0) + 1
        with stubbed_device_layer():
            yield


@pytest.mark.parametrize("mode", ["single", "tiered"])
def test_seams_see_one_clock_assignment_per_tick(mode):
    trace = fleet.generate_trace(**_light("seams", 43, 32, 1.2))
    base = fleet.FleetSimulator(trace, mode=mode, window_ticks=8).run()
    sim = _Seamed(trace, mode=mode, window_ticks=8)
    rep = sim.run()
    assert sim.entered == 1
    # the constructor's assignment, then one per tick
    assert sim.clock.sets == 1 + rep.ticks_run
    assert rep.to_json(include_requests=True) == base.to_json(include_requests=True)


def test_mode_is_checked():
    trace = fleet.generate_trace(**_light("m", 1, 4, 1.0))
    with pytest.raises(ValueError) as ours:
        fleet.FleetSimulator(trace, mode="pipeline")
    with pytest.raises(ValueError) as theirs:
        jax_fleet.FleetSimulator(jax_fleet.generate_trace(**_light("m", 1, 4, 1.0)),
                                 mode="pipeline")
    assert str(ours.value) == str(theirs.value)
