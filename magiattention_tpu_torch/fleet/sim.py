"""Discrete-event fleet simulator.

The JAX package's ``fleet/sim.py``. It replays a
:class:`~magiattention_tpu_torch.fleet.workload.FleetTrace` through the
REAL serving stack — ``Scheduler``/``ServingEngine`` (single-chip) or
``TieredScheduler``/``TieredEngine`` (disaggregated) — over the
lifecycle checker's stubbed device layer
(:func:`~magiattention_tpu_torch.analysis.lifecycle.stubbed_device_layer`).
Every host decision (admission, priority eviction, prefix-trie fork,
chunked prefill interleave, per-replica decode grouping, page
streaming, fault requeue) is the production code path; only the device
work is stubbed, so a tick costs microseconds and thousands of
concurrent requests replay in seconds.

Time is the LOGICAL tick clock (one unit per ``Scheduler.step``): all
SLO samples are deterministic tick counts. The simulator emits the
production ``magi_*`` metrics (scheduler gauges, SLO histograms,
lifecycle spans — the stack records those itself) plus the fleet
catalog (``REQUIRED_FLEET_METRICS``), and closes the loop: every
``window_ticks`` ticks it hands the ``snapshot_delta`` window to the
attached :class:`~magiattention_tpu_torch.fleet.autopilot.Autopilot` and
applies the decision through ``Scheduler.apply_knobs``.

Chaos: ``chaos_ticks={tick: spec}`` pins ``MAGI_ATTENTION_CHAOS`` for
exactly that tick (the lifecycle checker's pinning discipline), so a
decode-replica fault or pool exhaustion lands mid-replay and the
autopilot's fault-hold contract is exercised for real.

Where the port departs from the JAX simulator: a request's tensors are
CPU ``torch.zeros`` of its shape (the scheduler checks that a request's
device is its engine's; JAX uses shape-only stubs), and the engines are
built on the CPU in float32. Two private seams, :meth:`FleetSimulator.
_device_layer` and :meth:`FleetSimulator._make_clock`, together with
:meth:`~FleetSimulator._build_stack` and :meth:`~FleetSimulator.
_mk_request`, let a subclass replay the same loop through real devices
on a clock of its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import telemetry
from ..analysis.lifecycle import stubbed_device_layer
from ..analysis.trace_audit import _pinned_env
from ..resilience import chaos as chaos_mod
from ..telemetry.collectors import (
    record_fleet_finished,
    record_fleet_knob,
    record_fleet_offered,
    record_fleet_window,
)
from .autopilot import Autopilot, SLOTargets
from .workload import FleetTrace

# stub request geometry (shapes only — the device layer is stubbed)
_HEADS, _HEAD_DIM = 2, 4


class TickClock:
    """Logical scheduler clock: reads the CURRENT tick number (the
    simulator advances it once per step), so every latency sample the
    stack records is a deterministic tick count."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@dataclasses.dataclass
class FinishedRequest:
    """Per-request outcome (the reconciliation surface for the trace
    tests: these numbers must agree with the span-derived stats)."""

    rid: int
    arrival_tick: int
    finish_tick: float
    ttft_ticks: float
    toklat_ticks: float  # mean inter-token gap (0 for 1-token outputs)
    tokens: int
    evictions: int
    slo_ok: bool
    trace_id: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetReport:
    """One simulation run's outcome."""

    trace_name: str
    mode: str
    ticks_run: int
    offered: int
    finished: int
    slo_ok: int
    goodput_tokens: int
    attainment_finished: float  # slo_ok / finished
    attainment_offered: float  # slo_ok / offered (unfinished = miss)
    ttft_p50: float
    ttft_p99: float
    toklat_p99: float
    peak_concurrent: int
    chaos_faults: int
    requests: list[FinishedRequest]
    windows: list[dict]
    actions: list[tuple[int, str, float]]  # (window, knob, value)
    final_knobs: dict
    slo: dict

    def to_json(self, *, include_requests: bool = False) -> dict:
        d = {
            "trace_name": self.trace_name,
            "mode": self.mode,
            "ticks_run": self.ticks_run,
            "offered": self.offered,
            "finished": self.finished,
            "slo_ok": self.slo_ok,
            "goodput_tokens": self.goodput_tokens,
            "attainment_finished": self.attainment_finished,
            "attainment_offered": self.attainment_offered,
            "ttft_p50": self.ttft_p50,
            "ttft_p99": self.ttft_p99,
            "toklat_p99": self.toklat_p99,
            "peak_concurrent": self.peak_concurrent,
            "chaos_faults": self.chaos_faults,
            "windows": self.windows,
            "actions": [list(a) for a in self.actions],
            "final_knobs": {
                k: v for k, v in self.final_knobs.items()
            },
            "slo": self.slo,
        }
        if include_requests:
            d["requests"] = [r.to_json() for r in self.requests]
        return d


class FleetSimulator:
    """Replay one trace through the real serving stack (see module
    docstring). ``mode``: ``"single"`` (Scheduler over one engine) or
    ``"tiered"`` (TieredScheduler over 1 prefill chip + ``dp`` decode
    replicas). ``autopilot=None`` replays the static config — the
    baseline the gate compares against."""

    def __init__(
        self,
        trace: FleetTrace,
        *,
        mode: str = "tiered",
        autopilot: Autopilot | None = None,
        slo: SLOTargets | None = None,
        window_ticks: int | None = None,
        num_pages: int = 256,
        max_seqs: int = 32,
        max_pages_per_seq: int = 8,
        dp: int = 2,
        token_budget: int = 64,
        prefill_budget: int = 64,
        decode_budget: int = 32,
        chunk: int = 8,
        max_decode_batch: int | None = None,
        stream_queue_max: int = 8,
        chaos_ticks: dict[int, str] | None = None,
        max_ticks: int | None = None,
        manage_telemetry: bool = True,
        plan_probe=None,
    ):
        from .. import env

        if mode not in ("single", "tiered"):
            raise ValueError(
                f"mode={mode!r} must be 'single' or 'tiered'"
            )
        self.trace = trace
        self.mode = mode
        self.autopilot = autopilot
        self.slo = slo if slo is not None else (
            autopilot.slo if autopilot is not None else SLOTargets()
        )
        self.window_ticks = (
            int(window_ticks) if window_ticks is not None
            else env.fleet_window_ticks()
        )
        self.num_pages = int(num_pages)
        self.max_seqs = int(max_seqs)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.dp = int(dp)
        self.token_budget = int(token_budget)
        self.prefill_budget = int(prefill_budget)
        self.decode_budget = int(decode_budget)
        self.chunk = int(chunk)
        self.max_decode_batch = max_decode_batch
        self.stream_queue_max = int(stream_queue_max)
        self.chaos_ticks = dict(chaos_ticks or {})
        self.max_ticks = (
            int(max_ticks) if max_ticks is not None
            else 4 * trace.horizon_ticks + 256
        )
        self.manage_telemetry = bool(manage_telemetry)
        # plan-reuse probe: attached to the scheduler so every replayed
        # tick's request shapes resolve real runtime keys
        self.plan_probe = plan_probe

    # -- stack construction (under the stub layer) -----------------------

    def _build_stack(self, clock):
        geom = dict(
            num_pages=self.num_pages,
            page_size=self.trace.page_size,
            max_seqs=self.max_seqs,
            max_pages_per_seq=self.max_pages_per_seq,
        )
        if self.mode == "single":
            from ..serving.engine import ServingEngine
            from ..serving.scheduler import Scheduler

            engine = ServingEngine(
                num_kv_heads=_HEADS, head_dim=_HEAD_DIM,
                dtype=torch.float32, device="cpu", **geom
            )
            sched = Scheduler(
                engine,
                token_budget=self.token_budget,
                chunk=self.chunk,
                max_decode_batch=self.max_decode_batch,
                clock=clock,
                plan_probe=self.plan_probe,
            )
        else:
            from ..serving.distributed import TieredEngine, TieredScheduler

            engine = TieredEngine(
                num_kv_heads=_HEADS,
                head_dim=_HEAD_DIM,
                mesh_spec={
                    "prefill": 1, "decode_dp": self.dp, "decode_tp": 1,
                },
                devices=["cpu"] * (1 + self.dp),
                dtype=torch.float32,
                stream_queue_max=self.stream_queue_max,
                **geom,
            )
            sched = TieredScheduler(
                engine,
                prefill_budget=self.prefill_budget,
                decode_budget=self.decode_budget,
                chunk=self.chunk,
                max_decode_batch=self.max_decode_batch,
                clock=clock,
                plan_probe=self.plan_probe,
            )
        return sched, engine

    def _mk_request(self, tr):
        from ..serving.scheduler import Request

        p, g = tr.prompt_len, tr.output_len
        prompt = torch.zeros((p, _HEADS, _HEAD_DIM))
        gen = torch.zeros((g, _HEADS, _HEAD_DIM))
        return Request(
            rid=tr.rid,
            prompt_q=prompt,
            prompt_k=prompt,
            prompt_v=prompt,
            decode_q=gen,
            decode_k=gen,
            decode_v=gen,
            tokens=list(tr.prompt_tokens),
            max_new_tokens=g,
            priority=tr.priority,
            trace_id=f"fleet-{self.trace.name}-{tr.rid}",
        )

    def _device_layer(self):
        """The context the replay runs in: the stubbed device layer."""
        return stubbed_device_layer()

    def _make_clock(self):
        """The scheduler's clock: the logical tick clock."""
        return TickClock()

    # -- the replay loop -------------------------------------------------

    def run(self) -> FleetReport:
        if self.manage_telemetry:
            telemetry.set_enabled(True)
            telemetry.reset()
            telemetry.reset_request_traces()
        arrivals = self.trace.arrivals_by_tick()
        by_rid = {r.rid: r for r in self.trace.requests}
        clock = self._make_clock()
        finished: list[FinishedRequest] = []
        windows: list[dict] = []
        window_finished: list[FinishedRequest] = []
        offered = 0
        peak_concurrent = 0
        chaos_faults = 0
        prev_snapshot: dict | None = None
        tick = 0

        with self._device_layer():
            sched, _engine = self._build_stack(clock)
            if self.autopilot is not None:
                for name, value in sched.knobs().items():
                    if isinstance(value, (int, float)) and not isinstance(
                        value, bool
                    ):
                        record_fleet_knob(name, float(value))
            while tick < self.max_ticks:
                clock.t = float(tick)
                for tr in arrivals.get(tick, ()):
                    sched.submit(self._mk_request(tr))
                    offered += 1
                    record_fleet_offered()
                concurrent = len(sched._queue) + len(sched._active)
                peak_concurrent = max(peak_concurrent, concurrent)
                spec = self.chaos_ticks.get(tick)
                if spec is not None:
                    report, faulted = self._step_with_chaos(sched, spec)
                    chaos_faults += faulted
                else:
                    report = sched.step()
                for rid in report.finished:
                    fr = self._finish(sched, by_rid[rid])
                    finished.append(fr)
                    window_finished.append(fr)
                tick += 1
                if tick % self.window_ticks == 0:
                    prev_snapshot = self._close_window(
                        sched, tick, window_finished, windows,
                        prev_snapshot,
                    )
                    window_finished = []
                # drain exit: past the arrival horizon with nothing left
                if tick >= self.trace.horizon_ticks and sched.done:
                    break
            final_knobs = dict(sched.knobs())

        return self._report(
            ticks_run=tick,
            offered=offered,
            finished=finished,
            windows=windows,
            peak_concurrent=peak_concurrent,
            chaos_faults=chaos_faults,
            final_knobs=final_knobs,
        )

    def _step_with_chaos(self, sched, spec: str):
        """Run one tick with MAGI_ATTENTION_CHAOS pinned to ``spec``
        (armed fresh, disarmed after — the lifecycle checker's pinning
        discipline). Returns (StepReport, faults_absorbed)."""
        faulted = 0
        with _pinned_env("MAGI_ATTENTION_CHAOS", spec):
            chaos_mod.reset_chaos()
            try:
                report = sched.step()
            except chaos_mod.ChaosInjectedError:
                # an injector the stack treats as backpressure elsewhere
                # surfaced raw (single-mode pool chaos): count it and
                # keep the fleet ticking — a chaos tick must never kill
                # the sim
                report = None
                faulted = 1
        chaos_mod.reset_chaos()
        if report is None:
            report = sched.step()
        else:
            # a tiered decode fault is absorbed internally (requeue +
            # replay) — it shows up as evictions/requeues, and in the
            # tier-fault counter the autopilot's fault-hold reads
            faulted = 1
        return report, faulted

    def _finish(self, sched, tr) -> FinishedRequest:
        st = sched._finished[tr.rid]
        ttft = (
            float(st.first_token_at - st.slo_start)
            if st.first_token_at is not None
            else float("inf")
        )
        tokens = int(st.tokens_done)
        if tokens > 1 and st.last_token_at is not None:
            toklat = float(st.last_token_at - st.first_token_at) / (
                tokens - 1
            )
        else:
            toklat = 0.0
        slo_ok = self.slo.met_by(ttft, toklat)
        record_fleet_finished(
            ttft_ticks=ttft,
            token_latency_ticks=toklat,
            tokens=tokens,
            slo_ok=slo_ok,
        )
        return FinishedRequest(
            rid=tr.rid,
            arrival_tick=tr.arrival_tick,
            finish_tick=float(
                st.last_token_at
                if st.last_token_at is not None
                else st.slo_start
            ),
            ttft_ticks=ttft,
            toklat_ticks=toklat,
            tokens=tokens,
            evictions=int(st.evictions),
            slo_ok=slo_ok,
            trace_id=st.trace_id,
        )

    def _close_window(
        self, sched, tick, window_finished, windows, prev_snapshot
    ):
        """End one evaluation window: record the window gauges, diff
        the registry, hand the delta to the autopilot, apply its
        decision. Returns the new snapshot baseline."""
        n = len(window_finished)
        ok = sum(1 for r in window_finished if r.slo_ok)
        attainment = (ok / n) if n else 1.0
        concurrent = len(sched._queue) + len(sched._active)
        record_fleet_window(
            slo_attainment=attainment, concurrent=concurrent
        )
        curr = telemetry.snapshot()
        delta = telemetry.snapshot_delta(
            prev_snapshot, curr, seconds=float(self.window_ticks)
        )
        entry = {
            "window": len(windows),
            "tick": tick,
            "finished": n,
            "slo_ok": ok,
            "attainment": attainment,
            "concurrent": concurrent,
        }
        if self.autopilot is not None:
            current = dict(sched.knobs())
            current["__num_pages"] = self.num_pages
            decision = self.autopilot.evaluate(delta, current=current)
            if decision.actions:
                sched.apply_knobs(**decision.actions)
            entry["actions"] = dict(decision.actions)
            entry["holds"] = [list(h) for h in decision.holds]
            entry["facts"] = decision.facts
        windows.append(entry)
        return curr

    def _report(
        self, *, ticks_run, offered, finished, windows,
        peak_concurrent, chaos_faults, final_knobs,
    ) -> FleetReport:
        ttfts = [r.ttft_ticks for r in finished if np.isfinite(r.ttft_ticks)]
        toklats = [r.toklat_ticks for r in finished]
        slo_ok = sum(1 for r in finished if r.slo_ok)
        goodput = sum(r.tokens for r in finished if r.slo_ok)
        return FleetReport(
            trace_name=self.trace.name,
            mode=self.mode,
            ticks_run=int(ticks_run),
            offered=int(offered),
            finished=len(finished),
            slo_ok=int(slo_ok),
            goodput_tokens=int(goodput),
            attainment_finished=(
                slo_ok / len(finished) if finished else 0.0
            ),
            attainment_offered=(slo_ok / offered if offered else 1.0),
            ttft_p50=float(np.percentile(ttfts, 50)) if ttfts else 0.0,
            ttft_p99=float(np.percentile(ttfts, 99)) if ttfts else 0.0,
            toklat_p99=(
                float(np.percentile(toklats, 99)) if toklats else 0.0
            ),
            peak_concurrent=int(peak_concurrent),
            chaos_faults=int(chaos_faults),
            requests=finished,
            windows=windows,
            actions=(
                list(self.autopilot.actions_taken)
                if self.autopilot is not None
                else []
            ),
            final_knobs=final_knobs,
            slo=self.slo.to_json(),
        )
