"""Chunked-prefill continuous-batching scheduler: the control layer over
:class:`~.engine.ServingEngine`.

The counterpart of the JAX package's ``serving/scheduler.py``. A step loop
under a **token budget**:

1. **Admit** queued requests (priority descending, FIFO within a priority)
   through the engine's typed admission; a request whose prompt and decode
   budget can never fit one sequence's reservation (or the pool) is
   rejected, and an admission with no eviction power must leave one free
   page of decode headroom per decoding sequence;
2. **Decode first**: if any sequence is decoding, one batched decode step
   runs before any prefill work, so a long prefill never starves the
   decoders; pool pressure during its growth preempts the lowest-priority,
   youngest member, whose request replays through admission;
3. **Prefill chunks** with the remaining budget: prefilling requests in
   priority order advance by up to ``chunk`` tokens each.

Under ``MAGI_ATTENTION_UNIFIED_TICK`` (``env.unified_tick_mode``) the
decode group and the planned chunks go down as one
:meth:`~.engine.ServingEngine.unified_tick` call instead: the same schedule
in one ``paged_decode`` launch. The launch census (``_tick_programs``, the
labels of the engine calls a tick made) must match the count the tick's
hoisted state scan predicts.

Requests carry their attention inputs (per-token prompt q/k/v and one q/k/v
row per decode step) as tensors on the engine's device: this package is the
attention runtime, a model is the caller's. Host-side only.

Telemetry, as the JAX scheduler records it, none of which changes the
schedule: every request gets a trace id at submission, and its lifecycle
spans (``submit``, ``admitted``, ``prefill_chunk``, ``decode_step``,
``evicted`` / ``requeued``, ``finished`` ...) land in the span ring through
``telemetry/trace.py``, the SLO histograms (queue wait, TTFT, inter-token
latency) fed from the same floats; per tick the launch ledger and its cost
decomposition (``record_tick_programs``: host solver, kernel builds, engine
calls, an honest residual), ``record_sched_step``, the admission watermark,
the ``MemPressureWatcher`` (``MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD``, also
the ``mem_pressure_threshold`` knob), and the always-on flight recorder's
tick record and flush — a tick that raises is recorded and flushed too.
The engine-call wall time of a tick is host time: the scheduler never
synchronises the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from .. import telemetry
from ..telemetry import trace as reqtrace
from ..telemetry.memory import MemPressureWatcher
from .engine import AdmissionResult, ServingEngine
from .kv_cache import PageAllocatorError

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
FINISHED = "finished"
REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One serving request, attention-level.

    - ``prompt_q/k/v``: ``[P, h, d]`` per-token prompt projections;
    - ``tokens``: optional host token ids (length P) for shared-prefix
      matching and registration at admission;
    - ``decode_q/k/v``: ``[G, h, d]`` the projections of each generated
      step; ``max_new_tokens`` defaults to G;
    - ``priority``: admission priority (higher wins; the engine may evict
      strictly lower-priority residents under pressure);
    - ``trace_id``: the request's lifecycle trace id; None lets
      :meth:`Scheduler.submit` assign a process-unique one.
    """

    rid: int
    prompt_q: torch.Tensor
    prompt_k: torch.Tensor
    prompt_v: torch.Tensor
    decode_q: torch.Tensor
    decode_k: torch.Tensor
    decode_v: torch.Tensor
    tokens: Sequence[int] | None = None
    max_new_tokens: int | None = None
    priority: int = 0
    trace_id: str | None = None

    @property
    def prompt_len(self) -> int:
        return self.prompt_q.shape[0]

    @property
    def num_new_tokens(self) -> int:
        if self.max_new_tokens is not None:
            return int(self.max_new_tokens)
        return int(self.decode_q.shape[0])


@dataclasses.dataclass
class RequestState:
    """Scheduler-side lifecycle record of one request. ``slo_start`` is
    reset to the requeue instant after an eviction (the retry's clocks
    measure the retry); ``submitted_at`` keeps the FIFO seniority."""

    request: Request
    status: str = QUEUED
    slot: int | None = None
    submitted_at: float = 0.0
    slo_start: float = 0.0
    admitted_at: float | None = None
    first_token_at: float | None = None
    last_token_at: float | None = None
    prefill_pos: int = 0  # prompt tokens committed (incl. shared prefix)
    prefix_len: int = 0  # tokens installed by reference at admission
    tokens_done: int = 0
    prefill_chunk_idx: int = 0  # chunks run so far
    evictions: int = 0  # evictions and preemptions suffered
    requeues: list = dataclasses.field(default_factory=list)  # (tier, reason) of each
    trace_id: str = ""
    prefill_out_tail: torch.Tensor | None = None  # last prompt row's out
    decode_outs: list = dataclasses.field(default_factory=list)

    @property
    def rid(self) -> int:
        return self.request.rid


@dataclasses.dataclass(frozen=True)
class StepReport:
    """What one :meth:`Scheduler.step` tick did."""

    step: int
    admitted: tuple[int, ...]
    rejected: tuple[int, ...]
    decode_ran: bool
    decode_batch: int
    prefill_chunks: tuple[tuple[int, int], ...]  # (rid, chunk tokens)
    tokens_used: int
    finished: tuple[int, ...]
    queue_depth: int = 0  # queued requests at the tick's start
    budget_utilization: float = 0.0

    @property
    def idle(self) -> bool:
        return not self.decode_ran and not self.prefill_chunks and not self.admitted


class Scheduler:
    """Token-budget continuous-batching loop over one engine.

    ``token_budget``: attention tokens one step may process (decode counts 1
    per sequence, a prefill chunk its rows). ``chunk`` overrides
    ``MAGI_ATTENTION_PREFILL_CHUNK`` (None = env; env unset = the whole
    remaining prompt, bounded by the budget). ``plan_probe`` (duck-typed:
    ``note_decode(states)``, ``note_prefill(rid, lo, hi)``,
    ``on_step_end(report)``) sees each tick's real request shapes; it is
    host work and never enters the launch census.
    """

    # the tier labels of spans and SLO samples: None here (the unlabeled
    # series); the tiered scheduler sets both
    _prefill_tier: str | None = None
    _decode_tier: str | None = None

    def __init__(
        self,
        engine: ServingEngine,
        *,
        token_budget: int = 256,
        chunk: int | None = None,
        max_decode_batch: int | None = None,
        clock=time.perf_counter,
        plan_probe=None,
    ):
        from .. import env

        self.engine = engine
        self.plan_probe = plan_probe
        self.token_budget = int(token_budget)
        self.chunk = int(chunk) if chunk is not None else env.prefill_chunk()
        self.max_decode_batch = max_decode_batch
        # extra free pages an evictionless admission must leave beyond the
        # decode-growth headroom
        self.admission_watermark = 0
        self._clock = clock
        self._queue: list[RequestState] = []
        self._active: dict[int, RequestState] = {}  # rid -> state
        self._finished: dict[int, RequestState] = {}
        self._step = 0
        self._flight = reqtrace.get_flight_recorder()
        self._mem_watcher = MemPressureWatcher()
        # the launch census: labels of the engine calls this tick made, and
        # their host wall seconds, reset at the top of every step()
        self._tick_programs: list[str] = []
        self._tick_engine_s = 0.0

    # -- submission --

    def submit(self, request: Request) -> RequestState:
        """Queue ``request``; its tensors must lie on the engine's device (a
        request is never moved, and never run on another device)."""
        dev = self.engine.device
        for name in ("prompt_q", "prompt_k", "prompt_v", "decode_q", "decode_k", "decode_v"):
            t = getattr(request, name)
            if t.device.type != dev.type:
                raise ValueError(f"request {request.rid}: {name} is on {t.device}, the engine "
                                 f"on {dev}")
        now = self._clock()
        st = RequestState(request=request, submitted_at=now, slo_start=now,
                          trace_id=(request.trace_id if request.trace_id is not None
                                    else reqtrace.new_trace_id(request.rid)))
        self._queue.append(st)
        reqtrace.span_submit(st.trace_id, st.rid, prompt_len=request.prompt_len,
                             max_new_tokens=request.num_new_tokens, priority=request.priority)
        return st

    @property
    def waiting(self) -> int:
        return len(self._queue)

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def done(self) -> bool:
        return not self._queue and not self._active

    def result(self, rid: int) -> RequestState:
        return self._finished[rid]

    # -- admission --

    def _admission_order(self) -> list[RequestState]:
        return sorted(self._queue, key=lambda s: (-s.request.priority, s.submitted_at))

    def _reject(self, st: RequestState, rejected: list[int], reason: str) -> None:
        st.status = REJECTED
        self._queue.remove(st)
        self._finished[st.rid] = st
        rejected.append(st.rid)
        reqtrace.span_rejected(st.trace_id, st.rid, reason=reason)

    def _admit_queued(self) -> tuple[list[int], list[int]]:
        admitted, rejected = [], []
        alc = self.engine.allocator
        for st in self._admission_order():
            req = st.request
            # prompt + decode budget past one sequence's reservation (or the
            # pool) can never be served: reject it before the decode growth
            # would raise out of the tick loop
            cap = min(alc.max_pages_per_seq, alc.num_pages) * alc.page_size
            if req.prompt_len + req.num_new_tokens > cap:
                # the engine never sees it: mirror its rejection telemetry
                telemetry.record_admission(AdmissionResult(False, None, "too_long"))
                self._flight.note_admission(False, "too_long")
                self._reject(st, rejected, "too_long")
                continue
            # an admission with no eviction power leaves one free page of
            # decode headroom per decoding sequence: without it a request a
            # decode-pressure preemption just requeued re-admits into the
            # pages it freed and the loop ping-pongs
            if not any(s.request.priority < req.priority for s in self._active.values()):
                headroom = self._admission_headroom()
                free = alc.num_pages - alc.pages_in_use
                if headroom and free - alc.pages_needed(req.prompt_len) < headroom:
                    reqtrace.span_backpressure(st.trace_id, st.rid, reason="decode_headroom")
                    break  # transient: decoders finish, pages free
            with reqtrace.request_context(st.trace_id, st.rid):
                res = self.engine.admit(req.prompt_len, priority=req.priority,
                                        tokens=req.tokens)
            # an attempt may have evicted residents even when it failed
            for victim_slot in res.evicted:
                self._handle_eviction(victim_slot)
            if not res.admitted:
                if res.reason == "too_long":
                    self._reject(st, rejected, res.reason)
                    continue
                reqtrace.span_backpressure(st.trace_id, st.rid, reason=res.reason)
                break  # transient backpressure: keep FIFO order, retry later
            st.slot = res.slot
            st.prefix_len = res.prefix_len
            st.prefill_pos = res.prefix_len
            st.admitted_at = self._clock()
            # a fully-cached prompt still takes one empty prefill tick (the
            # registration hook)
            st.status = PREFILLING
            self._queue.remove(st)
            self._active[st.rid] = st
            admitted.append(st.rid)
            # the span and the queue-wait histogram from one float, measured
            # from the SLO clock origin (which a requeue resets)
            reqtrace.span_admitted(
                st.trace_id, st.rid, slot=res.slot, prefix_len=res.prefix_len,
                shared_pages=res.prefix_len // max(alc.page_size, 1),
                evicted=len(res.evicted), queue_s=st.admitted_at - st.slo_start,
                tier=self._prefill_tier)
        return admitted, rejected

    def _admission_headroom(self) -> int:
        """Free pages an admission must leave for decode growth: one per
        decoding sequence, plus ``admission_watermark``."""
        return len(self._decode_states()) + self.admission_watermark

    # -- runtime knobs --

    _KNOB_NAMES: tuple[str, ...] = ("token_budget", "chunk", "max_decode_batch",
                                    "admission_watermark", "mem_pressure_threshold", "cascade",
                                    "decode_splits")

    def knobs(self) -> dict:
        """Current value of every runtime-retunable knob."""
        return {
            "token_budget": self.token_budget,
            "chunk": self.chunk,
            "max_decode_batch": self.max_decode_batch,
            "admission_watermark": self.admission_watermark,
            "mem_pressure_threshold": self._mem_watcher.threshold,
            "cascade": self._knob_engines()[0].cascade_override,
            "decode_splits": self._knob_engines()[0].decode_splits_override,
        }

    def apply_knobs(self, **updates) -> dict:
        """Retune knobs between ticks: every update is validated first, then
        all apply (a bad value changes nothing). Returns the coerced
        ``{knob: value}`` applied; an unknown name raises ``ValueError``."""
        staged = {}
        for name, value in updates.items():
            if name not in self._KNOB_NAMES:
                raise ValueError(f"unknown scheduler knob {name!r}; retunable knobs are "
                                 f"{sorted(self._KNOB_NAMES)}")
            staged[name] = self._coerce_knob(name, value)
        for name, value in staged.items():
            self._set_knob(name, value)
        return staged

    def _knob_engines(self) -> list:
        """The engines the cascade and decode-splits knobs write through
        (the tiered scheduler's: the prefill engine and every replica's)."""
        return [self.engine]

    def _set_knob(self, name: str, value) -> None:
        if name == "mem_pressure_threshold":
            self._mem_watcher.threshold = value
        elif name == "cascade":
            for eng in self._knob_engines():
                eng.cascade_override = value
        elif name == "decode_splits":
            for eng in self._knob_engines():
                eng.decode_splits_override = value
        else:
            setattr(self, name, value)

    def _coerce_knob(self, name: str, value):
        from .. import env

        if name == "token_budget":
            v = int(value)
            if v < 1:
                raise ValueError(f"knob {name}={value!r} must be >= 1")
            return v
        if name in ("chunk", "max_decode_batch", "decode_splits"):
            if value is None:
                return None
            v = int(value)
            if v < 1:
                raise ValueError(f"knob {name}={value!r} must be >= 1 (or None)")
            return v
        if name == "admission_watermark":
            v = int(value)
            if v < 0:
                raise ValueError(f"knob admission_watermark={value!r} must be >= 0")
            return v
        if name == "mem_pressure_threshold":
            v = float(value)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"knob mem_pressure_threshold={value!r} must be in [0, 1] "
                                 "(a free-page fraction; 0 disables)")
            return v
        # cascade
        if value is None:
            return None
        v = str(value).strip().lower()
        if v not in env.CASCADE_MODES:
            raise ValueError(f"knob cascade={value!r} must be one of {env.CASCADE_MODES} "
                             "(or None = env)")
        return v

    # -- eviction and requeue --

    def _handle_eviction(self, slot: int) -> None:
        """A live sequence was evicted by the engine: its request goes back
        to the queue for a clean retry (shared prefix pages stay resident,
        so the retry re-forks cheaply)."""
        for st in list(self._active.values()):
            if st.slot == slot:
                self._requeue(st)
                return

    def _requeue(self, st: RequestState, *, tier: str | None = None,
                 reason: str | None = None) -> None:
        """One in-flight request back to the queue, its generation restarted
        and its SLO clock reset to now; ``(tier, reason)`` is recorded in
        ``st.requeues`` (a decode-tier fault: ``("decode", "decode_fault")``)."""
        reqtrace.span_evicted(st.trace_id, st.rid, slot=st.slot, tier=tier, reason=reason)
        st.requeues.append((tier, reason))
        self._active.pop(st.rid, None)
        st.slot = None
        st.status = QUEUED
        st.prefill_pos = 0
        st.prefix_len = 0
        st.tokens_done = 0
        st.prefill_chunk_idx = 0
        st.evictions += 1
        st.decode_outs.clear()
        st.first_token_at = None
        st.last_token_at = None
        st.slo_start = self._clock()
        self._queue.append(st)
        reqtrace.span_requeued(st.trace_id, st.rid)

    def _preempt(self, states: list[RequestState]) -> None:
        """Decode-pressure preemption: the lowest-priority, youngest member
        frees its slot (the engine still holds it) and replays through
        admission."""
        victim = min(states, key=lambda s: (s.request.priority, -s.submitted_at))
        self.engine.free(victim.slot)
        self._requeue(victim, reason="decode_pressure")

    # -- the decode group and the prefill chunks --

    def _decode_states(self) -> list[RequestState]:
        return [st for st in self._active.values() if st.status == DECODING]

    def _prefill_states(self) -> list[RequestState]:
        sts = [st for st in self._active.values() if st.status == PREFILLING]
        return sorted(sts, key=lambda s: (-s.request.priority, s.submitted_at))

    def _run_decode(self, states: list[RequestState]) -> int:
        if self.max_decode_batch is not None:
            states = states[: self.max_decode_batch]
        return self._decode_group(states)

    def _decode_group(self, states: list[RequestState], *, replica: int | None = None) -> int:
        """One batched decode step over ``states``; 0 when pool pressure
        preempted a member instead. The tiered scheduler calls it once per
        decode replica (``replica``, its index), so that a replica's fault
        stays with its own group."""
        if self.plan_probe is not None:
            self.plan_probe.note_decode(states)
        qs = torch.stack([st.request.decode_q[st.tokens_done] for st in states])
        ks = torch.stack([st.request.decode_k[st.tokens_done] for st in states])
        vs = torch.stack([st.request.decode_v[st.tokens_done] for st in states])
        t0 = time.perf_counter()
        try:
            # the batch lead's trace tags the engine's own emissions (a shadow
            # check's numeric_drift dump names a live request this way)
            with reqtrace.request_context(states[0].trace_id, states[0].rid):
                out, _lse = self.engine.decode_step(qs, ks, vs, [st.slot for st in states])
        except PageAllocatorError:
            # transient pool pressure mid-growth: an operating condition,
            # not a crash; retry the batch next tick
            self._preempt(states)
            return 0
        dur = time.perf_counter() - t0
        info = self.engine.last_decode_info or {}
        program = info.get("program") or telemetry.decode_program_label(len(states))
        self._tick_programs.append(program)
        self._tick_engine_s += dur
        self._decode_done(states, [out[j] for j in range(len(states))], info=info, t0=t0,
                          dur=dur, program=program, replica=replica)
        return len(states)

    def _decode_done(self, states: list[RequestState], outs: list, *, info: dict, t0: float,
                     dur: float, program: str | None, replica: int | None = None) -> None:
        """The per-request bookkeeping of a decode step's outputs: each
        request's ``decode_step`` span and its TTFT or inter-token latency
        sample from one float."""
        now = self._clock()
        group_of = info.get("cascade_group_of", {})
        for st, o in zip(states, outs):
            st.decode_outs.append(o)
            st.tokens_done += 1
            ttft_s = token_latency_s = None
            if st.first_token_at is None:
                st.first_token_at = now
                ttft_s = now - st.slo_start
            else:
                token_latency_s = now - (st.last_token_at or now)
            st.last_token_at = now
            reqtrace.span_decode_step(
                st.trace_id, st.rid, token_idx=st.tokens_done - 1, batch=len(states),
                num_splits=int(info.get("num_splits", 0)), cascade_group=group_of.get(st.slot),
                start_s=t0, duration_s=dur, ttft_s=ttft_s, token_latency_s=token_latency_s,
                tier=self._decode_tier, replica=replica, program=program)
            if st.tokens_done >= st.request.num_new_tokens:
                self._finish(st)

    def _finish(self, st: RequestState) -> None:
        st.status = FINISHED
        self.engine.free(st.slot)
        del self._active[st.rid]
        self._finished[st.rid] = st
        now = self._clock()
        reqtrace.span_finished(
            st.trace_id, st.rid, tokens=st.tokens_done, prefill_chunks=st.prefill_chunk_idx,
            prefix_len=st.prefix_len, evictions=st.evictions, e2e_s=now - st.submitted_at,
            slo_window_s=now - st.slo_start)

    def _run_prefill_chunk(self, st: RequestState, budget: int) -> int:
        req = st.request
        remaining = req.prompt_len - st.prefill_pos
        cap = self.chunk if self.chunk else remaining
        n = max(min(cap, remaining, budget), 0)
        if remaining > 0 and n == 0:
            return 0  # budget exhausted
        lo, hi = st.prefill_pos, st.prefill_pos + n
        if self.plan_probe is not None and n:
            self.plan_probe.note_prefill(st.rid, lo, hi)
        t0 = time.perf_counter()
        with reqtrace.request_context(st.trace_id, st.rid):
            out, _lse = self.engine.prefill(req.prompt_q[lo:hi], req.prompt_k[lo:hi],
                                            req.prompt_v[lo:hi], st.slot)
        dur = time.perf_counter() - t0
        # a zero-token chunk (fully-cached prompt) launches nothing
        program = telemetry.prefill_program_label(lo, n) if n else None
        if n:
            self._tick_programs.append(program)
            self._tick_engine_s += dur
        self._chunk_done(st, lo, n, out, t0=t0, dur=dur, program=program)
        return n

    def _chunk_done(self, st: RequestState, lo: int, n: int, out, *, t0: float, dur: float,
                    program: str | None) -> None:
        """The per-request bookkeeping of one prefill chunk, its
        ``prefill_chunk`` span first."""
        reqtrace.span_prefill_chunk(st.trace_id, st.rid, tokens=n,
                                    chunk_idx=st.prefill_chunk_idx, start=lo, start_s=t0,
                                    duration_s=dur, tier=self._prefill_tier, program=program)
        req = st.request
        hi = lo + n
        st.prefill_chunk_idx += 1
        st.prefill_pos = hi
        if n and hi == req.prompt_len:
            st.prefill_out_tail = out[-1]
        if st.prefill_pos >= req.prompt_len:
            st.status = DECODING
            if req.num_new_tokens == 0:
                self._finish(st)

    def _run_prefill_loop(self, budget: int, states: list[RequestState] | None = None
                          ) -> tuple[list[tuple[int, int]], int]:
        """Advance prefilling requests (priority order, at most one chunk
        each) until the budget is spent; returns the ``(rid, tokens)``
        chunks and the budget left."""
        chunks: list[tuple[int, int]] = []
        if states is None:
            states = self._prefill_states()
        for st in states:
            if budget <= 0:
                break
            n = self._run_prefill_chunk(st, budget)
            if n == 0 and st.request.prompt_len - st.prefill_pos > 0:
                break  # the budget cannot fit the next chunk's first token
            budget -= n
            chunks.append((st.rid, n))
        return chunks, budget

    # -- the tick --

    def step(self) -> StepReport:
        """One tick: admissions, at most one decode step, then prefill
        chunks with the budget left (or all of it as one unified tick).
        Every tick lands in the flight recorder; a tick aborted by an
        engine fault is recorded (with the error) before the armed dump
        flushes, so the dump holds the faulting tick."""
        self._step += 1
        tick_start = time.perf_counter()  # the flight recorder's arm window
        # the tick's cost attribution: marks on the compile tracker's
        # always-on accumulators, diffed at the end (telemetry on or off)
        tracker = telemetry.get_compile_tracker()
        tracker.note_tick(self._step)
        compile_mark = tracker.mark()
        solver_mark = tracker.solver_mark()
        self._tick_programs = []
        self._tick_engine_s = 0.0
        queue_depth = self.waiting  # at the tick's start, before admissions
        try:
            report = self._step_body(queue_depth)
        except Exception as e:  # noqa: BLE001 — recorded, then re-raised
            self._flight.record_tick({"step": self._step, "aborted": repr(e),
                                      "queue_depth": queue_depth, "active": self.num_active,
                                      "budget": self.token_budget}, start_t=tick_start)
            self._flight.flush()
            raise
        self._record_tick(report, tick_start, tracker, compile_mark, solver_mark)
        if self.plan_probe is not None:
            self.plan_probe.on_step_end(report)
        return report

    def _record_tick(self, report: StepReport, tick_start: float, tracker, compile_mark,
                     solver_mark: float) -> None:
        """A finished tick's telemetry: its wall-clock decomposed into host
        solver, kernel builds, engine calls (less the builds inside them)
        and an honest residual (negative when attribution over-counts),
        the step and launch records, the admission watermark, the memory
        pressure watcher, then the flight recorder's tick record and
        flush."""
        wall_s = time.perf_counter() - tick_start
        compile_n, compile_s = tracker.since(compile_mark)
        solver_s = tracker.solver_since(solver_mark)
        device_s = max(self._tick_engine_s - compile_s, 0.0)
        residual_s = wall_s - solver_s - compile_s - device_s
        programs = list(self._tick_programs)
        telemetry.record_sched_step(
            waiting=self.waiting, active=self.num_active, tokens_used=report.tokens_used,
            prefill_chunks=len([c for c in report.prefill_chunks if c[1] > 0]),
            decode_ran=report.decode_ran, budget_utilization=report.budget_utilization,
            queue_depth=report.queue_depth)
        telemetry.record_tick_programs(
            step=self._step, start_s=tick_start, wall_s=wall_s, programs=programs,
            compiles=compile_n, solver_s=solver_s, compile_s=compile_s, device_s=device_s,
            residual_s=residual_s)
        alloc = self.engine.allocator
        free = alloc.num_pages - alloc.pages_in_use
        telemetry.record_admission_watermark(self._admission_headroom(), free)
        if self._mem_watcher.observe(free / max(alloc.num_pages, 1)):
            self._flight.trigger(
                "mem_pressure", immediate=False, free_pages=free, pages_total=alloc.num_pages,
                threshold=self._mem_watcher.threshold,
                consecutive_ticks=self._mem_watcher.ticks)
        self._flight.record_tick({
            "step": report.step,
            "admitted": list(report.admitted),
            "rejected": list(report.rejected),
            "decode_ran": report.decode_ran,
            "decode_batch": report.decode_batch,
            "prefill_chunks": [list(c) for c in report.prefill_chunks],
            "tokens_used": report.tokens_used,
            "budget": self.token_budget,
            "budget_utilization": report.budget_utilization,
            "queue_depth": report.queue_depth,
            "waiting": self.waiting,
            "active": self.num_active,
            "finished": list(report.finished),
            "launches": len(set(programs)),
            "programs": programs,
            "compiles": compile_n,
            "cost_ms": {
                "wall": round(wall_s * 1e3, 3),
                "solver": round(solver_s * 1e3, 3),
                "compile": round(compile_s * 1e3, 3),
                "device": round(device_s * 1e3, 3),
                "residual": round(residual_s * 1e3, 3),
            },
        }, start_t=tick_start)
        self._flight.flush()

    def _report(self, admitted, rejected, finished_before, queue_depth, decode_ran: bool,
                decode_batch: int, chunks, tokens_used: int) -> StepReport:
        return StepReport(
            step=self._step,
            admitted=tuple(admitted),
            rejected=tuple(rejected),
            decode_ran=decode_ran,
            decode_batch=decode_batch,
            prefill_chunks=tuple(chunks),
            tokens_used=tokens_used,
            finished=tuple(set(self._finished) - finished_before),
            queue_depth=queue_depth,
            budget_utilization=tokens_used / max(self.token_budget, 1),
        )

    def _step_body(self, queue_depth: int) -> StepReport:
        budget = self.token_budget
        admitted, rejected = self._admit_queued()
        finished_before = set(self._finished)
        # one pass over the active set per tick: both censuses here, threaded
        # to whichever launch path runs (decode never changes the prefill set)
        decoding = self._decode_states()
        prefilling = self._prefill_states()
        unified = self._unified_tick_enabled(decoding, prefilling)
        if unified:
            report = self._unified_step_body(budget, admitted, rejected, finished_before,
                                             queue_depth, decoding, prefilling)
        else:
            decode_ran, decode_batch = False, 0
            if decoding:
                decode_batch = self._run_decode(decoding)
                decode_ran = True
                budget -= decode_batch
            chunks, budget = self._run_prefill_loop(budget, states=prefilling)
            report = self._report(admitted, rejected, finished_before, queue_depth, decode_ran,
                                  decode_batch, chunks, self.token_budget - budget)
        # the launch census: one unified call when any attention ran, else
        # one per decode group and one per token-carrying chunk
        chunk_calls = sum(1 for _rid, n in report.prefill_chunks if n > 0)
        if unified:
            expected = 1 if report.decode_batch > 0 or chunk_calls else 0
        else:
            expected = (1 if report.decode_batch > 0 else 0) + chunk_calls
        if len(self._tick_programs) != expected:
            raise AssertionError(
                f"scheduler launch census drift: {len(self._tick_programs)} programs recorded "
                f"({self._tick_programs}) but the tick census predicted {expected} "
                f"(unified={unified}, decode_batch={report.decode_batch}, "
                f"chunks={report.prefill_chunks})")
        return report

    def _unified_tick_enabled(self, decoding: list[RequestState],
                              prefilling: list[RequestState]) -> bool:
        """Whether this tick runs as one launch: never under ``off``; under
        ``on`` whenever there is attention work; under ``auto`` exactly when
        the per-request path would make two or more calls."""
        from .. import env

        mode = env.unified_tick_mode()
        if mode == "off" or not hasattr(self.engine, "unified_tick"):
            return False
        if getattr(self.engine, "_decode_attn_fn", None) is not None:
            return False  # a substituted decode (TP) keeps the per-request path
        n_pf = sum(1 for st in prefilling if st.request.prompt_len - st.prefill_pos > 0)
        if mode == "on":
            return bool(decoding) or n_pf > 0
        return (bool(decoding) and n_pf > 0) or n_pf >= 2

    def _unified_step_body(self, budget: int, admitted: list, rejected: list,
                           finished_before: set, queue_depth: int,
                           decoding: list[RequestState],
                           prefilling: list[RequestState]) -> StepReport:
        """One fused tick: the decode group and every planned prefill chunk
        as one ``engine.unified_tick`` call, then the per-request bookkeeping
        of the two paths. Chunks are planned as ``_run_prefill_loop`` runs
        them. Pool pressure during growth preempts a decode member and
        retries the whole tick next step (the per-request path still runs
        prefill that tick: the one difference, under pressure only)."""
        decode_states = decoding
        if self.max_decode_batch is not None:
            decode_states = decode_states[: self.max_decode_batch]
        b = budget - len(decode_states)
        plan: list[tuple[RequestState, int, int]] = []  # (state, lo, n)
        for st in prefilling:
            if b <= 0:
                break
            remaining = st.request.prompt_len - st.prefill_pos
            cap = self.chunk if self.chunk else remaining
            n = max(min(cap, remaining, b), 0)
            if remaining > 0 and n == 0:
                break
            plan.append((st, st.prefill_pos, n))
            b -= n
        if self.plan_probe is not None:
            if decode_states:
                self.plan_probe.note_decode(decode_states)
            for st, lo, n in plan:
                if n:
                    self.plan_probe.note_prefill(st.rid, lo, lo + n)
        decode_items = [(st.slot, st.request.decode_q[st.tokens_done],
                         st.request.decode_k[st.tokens_done], st.request.decode_v[st.tokens_done])
                        for st in decode_states]
        prefill_items = [(st.slot, st.request.prompt_q[lo:lo + n], st.request.prompt_k[lo:lo + n],
                          st.request.prompt_v[lo:lo + n]) for st, lo, n in plan]
        t0 = time.perf_counter()
        try:
            decode_res, prefill_res = self.engine.unified_tick(decode_items, prefill_items)
        except PageAllocatorError:
            if not decode_states:
                raise
            self._preempt(decode_states)  # nothing launched
            return self._report(admitted, rejected, finished_before, queue_depth,
                                bool(decode_states), 0, (), 0)
        dur = time.perf_counter() - t0
        info = self.engine.last_tick_info or {}
        program = info.get("program")
        if program is not None:  # the whole tick was one call
            self._tick_programs.append(program)
            self._tick_engine_s += dur
        self._decode_done(decode_states, [o for o, _lse in decode_res], info=info, t0=t0,
                          dur=dur, program=program)
        chunks: list[tuple[int, int]] = []
        for (st, lo, n), (out_rows, _lse_rows) in zip(plan, prefill_res):
            self._chunk_done(st, lo, n, out_rows, t0=t0, dur=dur if n else 0.0,
                             program=program if n else None)
            chunks.append((st.rid, n))
        return self._report(admitted, rejected, finished_before, queue_depth,
                            bool(decode_states), len(decode_states), chunks,
                            self.token_budget - b)

    def run(self, max_steps: int = 10_000) -> list[StepReport]:
        """Step until every submitted request finished; raises after
        ``max_steps``, or on an idle step with work pending and nothing
        active (a queue the pool can never admit)."""
        reports = []
        while not self.done:
            if len(reports) >= max_steps:
                raise RuntimeError(f"Scheduler.run: {max_steps} steps without draining "
                                   f"({self.waiting} queued, {self.num_active} active)")
            rep = self.step()
            reports.append(rep)
            if rep.idle and not self.done and self.num_active == 0:
                raise RuntimeError("Scheduler.run: queue blocked with no active work "
                                   "(pool too small for the queue head?)")
        return reports
