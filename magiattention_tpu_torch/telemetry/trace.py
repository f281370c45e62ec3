"""Request-lifecycle tracing + serving flight recorder.

The JAX package's ``telemetry/trace.py``. Beside the aggregate SLO
histograms and step counters, the serving stack (engine / prefix cache /
scheduler / tiers) keeps *per-request* lifecycle traces on top of the
span-event ring (``telemetry/events.py``):

- **Request spans.** Every :class:`~magiattention_tpu_torch.serving.scheduler.
  Request` gets a ``trace_id``; the scheduler and engine emit typed
  lifecycle spans (``submit``, ``admitted``, ``prefill_chunk``,
  ``decode_step``, ``evicted``/``requeued``, ``degraded``, ``finished``
  ...) into the ring via :func:`record_request_span`, each tagged with
  the trace id and a per-trace sequence number. The SLO-histogram
  samples (queue wait, TTFT, inter-token latency) are emitted *by the
  same helpers* that emit the spans, so the per-request view and the
  aggregate view are computed from one number and cannot drift.
- **Reconstruction.** :func:`export_request_traces` folds the ring back
  into one :class:`RequestTrace` span tree per trace id — ordered spans,
  derived stats (queue ms, TTFT, tokens/s, prefill chunks, evictions,
  prefix-hit tokens) — and marks trees whose spans were evicted from
  the ring as ``partial`` (sequence-number gaps; the ring's dropped
  counter corroborates) instead of presenting them as complete.
  :func:`request_traces_to_chrome` lays the trees out as a Chrome trace
  with **one track per request** (reusing ``merge_chrome_traces``), and
  :func:`dump_request_traces_jsonl` writes one JSON object per request.
- **Flight recorder.** :class:`FlightRecorder` keeps a bounded
  always-on ring of the last N scheduler ticks (StepReport + queue
  depth + budget utilization) and admission decisions, independent of
  the telemetry enable flag (one small host dict per tick). When a
  resilience signal fires — ``NumericalGuardError``, a degradation
  path, an admission-rejection storm, an engine fault mid-request, a
  recompile storm (``telemetry/compile.py``) — the
  ring auto-dumps to ``MAGI_ATTENTION_TRACE_DIR`` as a post-mortem
  artifact. Depth via ``MAGI_ATTENTION_FLIGHT_RECORDER_DEPTH`` (0
  disables).

Everything here is host-side; nothing may be called from traced code.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import threading
import time
import weakref
from typing import Sequence

# ---------------------------------------------------------------------------
# span catalog
# ---------------------------------------------------------------------------

SPAN_SUBMIT = "submit"  # request entered the scheduler queue
SPAN_BACKPRESSURE = "backpressure"  # admission parked it (transient)
SPAN_REJECTED = "rejected"  # terminal: too_long / storm give-up
SPAN_ADMITTED = "admitted"  # slot + pages reserved {prefix_len, ...}
SPAN_PREFILL_CHUNK = "prefill_chunk"  # one chunk {tokens, chunk_idx}
SPAN_DECODE_STEP = "decode_step"  # one generated token {batch, ...}
SPAN_EVICTED = "evicted"  # priority-evicted mid-flight
SPAN_REQUEUED = "requeued"  # back in the queue after eviction
SPAN_DEGRADED = "degraded"  # a degradation path engaged {reason}
SPAN_COW = "cow"  # a copy-on-write page split served this request
SPAN_FINISHED = "finished"  # terminal: all tokens produced
# disaggregated serving (serving/distributed.py): where in the
# tiered mesh a request's life happened
SPAN_TIER_ASSIGNED = "tier_assigned"  # admitted onto a tier {tier}
SPAN_PAGES_STREAMED = "pages_streamed"  # prefill->decode page transfer
SPAN_TIER_MIGRATED = "tier_migrated"  # now served by {to_tier, replica}

# terminal kinds release the per-trace sequence counter
_TERMINAL_KINDS = (SPAN_FINISHED, SPAN_REJECTED)

# every span lands in the events ring under this name prefix, so the
# reconstruction can cheaply filter request spans from planning spans
_NAME_PREFIX = "req:"

_seq_lock = threading.Lock()
_seqs: dict[str, int] = {}
_trace_counter = 0

# the current request context: set by the scheduler around engine calls
# so engine-internal emissions (CoW splits, degradation paths) can tag
# their span with the request that triggered them
_current_trace: contextvars.ContextVar[tuple[str, int] | None] = (
    contextvars.ContextVar("magi_current_trace", default=None)
)


def new_trace_id(rid) -> str:
    """Process-unique trace id for one request (``req-<rid>-<n>``)."""
    global _trace_counter
    with _seq_lock:
        _trace_counter += 1
        return f"req-{rid}-{_trace_counter}"


def current_trace() -> tuple[str, int] | None:
    """The (trace_id, rid) the calling context is serving, or None."""
    return _current_trace.get()


@contextlib.contextmanager
def request_context(trace_id: str, rid: int):
    """Tag engine-internal emissions inside the block with this request
    (contextvar — safe under threads and nested scopes)."""
    token = _current_trace.set((trace_id, int(rid)))
    try:
        yield
    finally:
        _current_trace.reset(token)


def _next_seq(trace_id: str, terminal: bool) -> int:
    with _seq_lock:
        seq = _seqs.get(trace_id, 0)
        if terminal:
            _seqs.pop(trace_id, None)
        else:
            _seqs[trace_id] = seq + 1
        return seq


def reset_request_traces() -> None:
    """Drop the per-trace sequence counters (tests / fresh schedulers).
    The span ring itself is cleared via ``telemetry.reset()``."""
    with _seq_lock:
        _seqs.clear()


def record_request_span(
    trace_id: str,
    kind: str,
    *,
    rid: int | None = None,
    start_s: float | None = None,
    duration_s: float = 0.0,
    **attrs,
) -> None:
    """Emit one lifecycle span into the events ring, tagged with the
    trace id and a per-trace monotonic sequence number. No-op while
    telemetry is disabled (same gate as every other span)."""
    from . import enabled
    from .events import record_event

    if not enabled():
        return
    seq = _next_seq(trace_id, kind in _TERMINAL_KINDS)
    args = {"trace_id": trace_id, "kind": kind, "seq": seq}
    if rid is not None:
        args["rid"] = int(rid)
    args.update({k: v for k, v in attrs.items() if v is not None})
    record_event(
        _NAME_PREFIX + kind,
        time.perf_counter() if start_s is None else start_s,
        duration_s,
        args,
    )


# ---------------------------------------------------------------------------
# typed emission helpers — single-sourced with the SLO histograms
# ---------------------------------------------------------------------------
#
# The scheduler calls THESE instead of the histogram collectors: each
# helper records the span attr and the matching histogram sample from
# the same float, so a per-request trace always reconciles exactly with
# the aggregate SLO view (their sums match exactly).


def span_submit(
    trace_id: str, rid: int, *, prompt_len: int, max_new_tokens: int,
    priority: int = 0,
) -> None:
    from .collectors import record_request_traced

    record_request_span(
        trace_id, SPAN_SUBMIT, rid=rid, prompt_len=prompt_len,
        max_new_tokens=max_new_tokens, priority=priority,
    )
    record_request_traced()


def span_admitted(
    trace_id: str, rid: int, *, slot: int, prefix_len: int,
    shared_pages: int, evicted: int, queue_s: float,
    tier: str | None = None,
) -> None:
    from .collectors import record_request_queue_time

    record_request_span(
        trace_id, SPAN_ADMITTED, rid=rid, slot=slot, prefix_len=prefix_len,
        shared_pages=shared_pages, evicted=evicted, queue_s=queue_s,
        tier=tier,
    )
    record_request_queue_time(queue_s, tier=tier)


def span_backpressure(trace_id: str, rid: int, *, reason: str) -> None:
    record_request_span(trace_id, SPAN_BACKPRESSURE, rid=rid, reason=reason)


def span_rejected(trace_id: str, rid: int, *, reason: str) -> None:
    record_request_span(trace_id, SPAN_REJECTED, rid=rid, reason=reason)


def span_prefill_chunk(
    trace_id: str, rid: int, *, tokens: int, chunk_idx: int, start: int,
    start_s: float, duration_s: float, tier: str | None = None,
    program: str | None = None,
) -> None:
    record_request_span(
        trace_id, SPAN_PREFILL_CHUNK, rid=rid, tokens=tokens,
        chunk_idx=chunk_idx, start=start, start_s=start_s,
        duration_s=duration_s, tier=tier, program=program,
    )


def span_decode_step(
    trace_id: str, rid: int, *, token_idx: int, batch: int,
    num_splits: int, cascade_group: int | None, start_s: float,
    duration_s: float, ttft_s: float | None = None,
    token_latency_s: float | None = None, tier: str | None = None,
    replica: int | None = None, program: str | None = None,
) -> None:
    from .collectors import (
        record_request_token_latency,
        record_request_ttft,
    )

    record_request_span(
        trace_id, SPAN_DECODE_STEP, rid=rid, token_idx=token_idx,
        batch=batch, num_splits=num_splits, cascade_group=cascade_group,
        start_s=start_s, duration_s=duration_s, ttft_s=ttft_s,
        token_latency_s=token_latency_s, tier=tier, replica=replica,
        program=program,
    )
    if ttft_s is not None:
        record_request_ttft(ttft_s, tier=tier)
    if token_latency_s is not None:
        record_request_token_latency(token_latency_s, tier=tier)


def span_evicted(
    trace_id: str, rid: int, *, slot: int, tier: str | None = None,
    reason: str | None = None,
) -> None:
    record_request_span(
        trace_id, SPAN_EVICTED, rid=rid, slot=slot, tier=tier,
        reason=reason,
    )


# -- disaggregated-serving lifecycle ------------------------------------------


def span_tier_assigned(
    trace_id: str, rid: int, *, tier: str, slot: int,
) -> None:
    record_request_span(
        trace_id, SPAN_TIER_ASSIGNED, rid=rid, tier=tier, slot=slot
    )


def span_pages_streamed(
    trace_id: str, rid: int, *, pages: int, tokens: int, nbytes: int,
    replica: int, digest_ok: bool | None = None,
    start_s: float | None = None, duration_s: float = 0.0,
) -> None:
    record_request_span(
        trace_id, SPAN_PAGES_STREAMED, rid=rid, pages=pages,
        tokens=tokens, nbytes=nbytes, replica=replica,
        digest_ok=digest_ok, start_s=start_s, duration_s=duration_s,
    )


def span_tier_migrated(
    trace_id: str, rid: int, *, from_tier: str, to_tier: str,
    replica: int | None = None, reason: str = "commit",
) -> None:
    record_request_span(
        trace_id, SPAN_TIER_MIGRATED, rid=rid, from_tier=from_tier,
        to_tier=to_tier, replica=replica, reason=reason,
    )


def span_requeued(trace_id: str, rid: int) -> None:
    record_request_span(trace_id, SPAN_REQUEUED, rid=rid)


def span_finished(trace_id: str, rid: int, **stats) -> None:
    record_request_span(trace_id, SPAN_FINISHED, rid=rid, **stats)


def span_for_current(kind: str, **attrs) -> None:
    """Attach a span to the request the calling context serves (no-op
    outside a :func:`request_context` block) — how engine-internal
    events (CoW splits, degradation paths) land on the right trace."""
    cur = current_trace()
    if cur is None:
        return
    record_request_span(cur[0], kind, rid=cur[1], **attrs)


# ---------------------------------------------------------------------------
# reconstruction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestTrace:
    """One request's reconstructed span tree.

    ``spans`` is seq-ordered ``{"kind", "seq", "ts", "dur", "attrs"}``
    dicts (``ts``/``dur`` in seconds on the span perf_counter clock).
    ``partial`` means the ring evicted spans of this trace (sequence
    gaps / a missing leading span): its stats cover only what survived.
    ``complete`` = a terminal span is present AND nothing was lost.
    """

    trace_id: str
    rid: int | None
    spans: list[dict]
    partial: bool
    complete: bool
    stats: dict

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "rid": self.rid,
            "partial": self.partial,
            "complete": self.complete,
            "stats": self.stats,
            "spans": self.spans,
        }


def _derive_stats(spans: list[dict]) -> dict:
    """Per-request derived stats from the span attrs. The latency
    figures reuse the exact floats the emission helpers fed the SLO
    histograms, so aggregate sums reconcile bit-for-bit."""
    queue_samples: list[float] = []
    ttft_s = None
    token_latencies: list[float] = []
    tokens = 0
    prefill_chunks = 0
    prefill_tokens = 0
    evictions = 0
    prefix_hit_tokens = 0
    decode_ts: list[float] = []
    for s in spans:
        a = s["attrs"]
        k = s["kind"]
        if k == SPAN_ADMITTED:
            queue_samples.append(float(a.get("queue_s", 0.0)))
            prefix_hit_tokens = int(a.get("prefix_len", 0))
        elif k == SPAN_PREFILL_CHUNK:
            prefill_chunks += 1
            prefill_tokens += int(a.get("tokens", 0))
        elif k == SPAN_DECODE_STEP:
            tokens += 1
            decode_ts.append(s["ts"] + s["dur"])
            if a.get("ttft_s") is not None:
                ttft_s = float(a["ttft_s"])
            if a.get("token_latency_s") is not None:
                token_latencies.append(float(a["token_latency_s"]))
        elif k == SPAN_EVICTED:
            evictions += 1
    span_total = sum(token_latencies)
    return {
        "queue_s": queue_samples[-1] if queue_samples else None,
        "queue_samples": queue_samples,
        "ttft_s": ttft_s,
        "tokens": tokens,
        "token_latency_samples": token_latencies,
        "tokens_per_s": (
            (len(token_latencies) / span_total) if span_total > 0 else None
        ),
        "prefill_chunks": prefill_chunks,
        "prefill_tokens": prefill_tokens,
        "evictions": evictions,
        "prefix_hit_tokens": prefix_hit_tokens,
    }


def export_request_traces(
    events: Sequence[dict] | None = None,
    *,
    dropped: int | None = None,
) -> dict[str, RequestTrace]:
    """Reconstruct per-request span trees from the events ring.

    ``events`` defaults to the live ring's contents; ``dropped``
    defaults to the ring's evicted-span count. A trace whose sequence
    numbers do not run gap-free from 0 lost spans to ring eviction and
    is marked ``partial`` — it is never presented as complete.
    """
    from .events import get_event_buffer

    if events is None:
        buf = get_event_buffer()
        events = buf.events()
        if dropped is None:
            dropped = buf.dropped
    dropped = int(dropped or 0)
    by_trace: dict[str, list[dict]] = {}
    rids: dict[str, int | None] = {}
    for ev in events:
        if not str(ev.get("name", "")).startswith(_NAME_PREFIX):
            continue
        args = dict(ev.get("args") or {})
        tid = args.pop("trace_id", None)
        if tid is None:
            continue
        kind = args.pop("kind", ev["name"][len(_NAME_PREFIX):])
        seq = int(args.pop("seq", -1))
        rid = args.pop("rid", None)
        if rid is not None:
            rids[tid] = int(rid)
        rids.setdefault(tid, None)
        by_trace.setdefault(tid, []).append(
            {
                "kind": kind,
                "seq": seq,
                "ts": float(ev.get("ts", 0.0)) / 1e6,
                "dur": float(ev.get("dur", 0.0)) / 1e6,
                "attrs": args,
            }
        )
    out: dict[str, RequestTrace] = {}
    for tid, spans in by_trace.items():
        spans.sort(key=lambda s: (s["seq"], s["ts"]))
        seqs = [s["seq"] for s in spans]
        # gap-free from 0 or spans were lost (ring eviction — `dropped`
        # corroborates — or an emitter restart; flagged either way)
        partial = seqs != list(range(len(seqs)))
        terminal = spans[-1]["kind"] in _TERMINAL_KINDS
        out[tid] = RequestTrace(
            trace_id=tid,
            rid=rids.get(tid),
            spans=spans,
            partial=partial,
            complete=terminal and not partial,
            stats=_derive_stats(spans),
        )
    return out


def request_traces_to_chrome(
    traces: dict[str, RequestTrace] | None = None,
) -> dict:
    """Chrome trace-event payload with ONE track per request (pid = the
    request's position, labeled ``request <rid> [<trace_id>]``), built
    on the cross-rank ``merge_chrome_traces`` machinery — so a
    multi-tenant run opens in Perfetto as parallel request swimlanes."""
    from .aggregate import merge_chrome_traces

    if traces is None:
        traces = export_request_traces()
    ordered = sorted(
        traces.values(),
        key=lambda tr: (tr.rid if tr.rid is not None else 1 << 30,
                        tr.trace_id),
    )
    payloads, labels = [], []
    for tr in ordered:
        payloads.append(
            [
                {
                    "name": _NAME_PREFIX + s["kind"],
                    "ph": "X",
                    "ts": s["ts"] * 1e6,
                    "dur": s["dur"] * 1e6,
                    "pid": 0,
                    "tid": 0,
                    "args": {"seq": s["seq"], **s["attrs"]},
                }
                for s in tr.spans
            ]
        )
        label = f"request {tr.rid} [{tr.trace_id}]"
        if tr.partial:
            label += " (partial)"
        labels.append(label)
    return merge_chrome_traces(payloads, labels=labels)


def dump_request_traces(path: str) -> str:
    """Write the live ring's request traces as a one-track-per-request
    Chrome trace JSON; returns ``path``."""
    payload = request_traces_to_chrome()
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return path


def dump_request_traces_jsonl(path: str) -> str:
    """Write one JSON object per request (``RequestTrace.to_json``
    layout, rid-ordered) — the machine-consumable export; returns
    ``path``."""
    traces = export_request_traces()
    ordered = sorted(
        traces.values(),
        key=lambda tr: (tr.rid if tr.rid is not None else 1 << 30,
                        tr.trace_id),
    )
    with open(path, "w") as f:
        for tr in ordered:
            f.write(json.dumps(tr.to_json(), sort_keys=True))
            f.write("\n")
    return path


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded always-on ring of scheduler ticks + admission decisions,
    auto-dumped on resilience signals (the serving post-mortem).

    - :meth:`record_tick` — the scheduler appends one dict per tick
      (StepReport fields + queue depth + budget utilization); cheap
      enough to leave on in production.
    - :meth:`note_admission` — the engine reports every admission
      verdict; ``storm_threshold`` consecutive rejections arm a dump.
    - :meth:`trigger` — a resilience signal fires: the trigger record
      joins the ring and the dump is written now (``immediate=True``,
      guard violations / degradations) or at the end of the current
      tick (``immediate=False``, engine faults and recompile storms —
      so the dump contains the tick that was aborted or thrashed).

    Dumps land in ``MAGI_ATTENTION_TRACE_DIR`` as
    ``magi_flight_<pid>_<n>.json`` and are capped at ``max_dumps`` per
    process (a crash loop must not fill the disk). A trigger with an
    empty tick ring arms but never writes — unit tests exercising
    degradation paths outside any scheduler don't spray files.
    """

    # an armed (deferred) trigger that predates the current tick and
    # that nothing flushed promptly is stale — the tick it was waiting
    # for never came (e.g. an engine fault outside any scheduler).
    # Dropping it keeps an old signal from attaching itself to a later,
    # unrelated scheduler run. An arm that fired DURING the recorded
    # tick is never stale, however long that tick took (a first call that
    # builds its kernels runs for minutes): the scheduler stamps each tick with
    # its start time so flush can tell the two apart.
    ARM_TTL_S = 2.0

    def __init__(
        self,
        depth: int | None = None,
        *,
        storm_threshold: int = 8,
        max_dumps: int = 16,
    ):
        from .. import env

        self.depth = env.flight_recorder_depth() if depth is None else depth
        self.storm_threshold = int(storm_threshold)
        self.max_dumps = int(max_dumps)
        self._lock = threading.Lock()
        self._ticks: list[dict] = []
        self._admissions: list[dict] = []
        self._ticks_dropped = 0
        self._consecutive_rejections = 0
        self._armed: dict | None = None
        self._last_tick_start: float | None = None
        self._dump_count = 0
        self.dump_paths: list[str] = []
        # memory-forensics sources: weakly-held objects with
        # a memory_snapshot() method (engines register themselves);
        # every dump embeds their ledger + fragmentation snapshots
        self._memory_sources: list[tuple[str, weakref.ref]] = []
        # numerics sources: same weakly-held contract, but
        # the method is numerics_snapshot() and the dump section is
        # `numerics` (the value census + shadow-sentinel scores)
        self._numerics_sources: list[tuple[str, weakref.ref]] = []
        self._source_counter = 0

    @property
    def enabled(self) -> bool:
        return self.depth > 0

    def _append(self, store: list[dict], rec: dict) -> None:
        store.append(rec)
        if len(store) > self.depth:
            del store[: len(store) - self.depth]
            if store is self._ticks:
                self._ticks_dropped += 1

    def record_tick(self, tick: dict, *, start_t: float | None = None) -> None:
        """Append one tick record. ``start_t`` (perf_counter) is when
        the tick STARTED: an armed trigger that fired at-or-after it is
        "during this tick" and survives :meth:`flush` no matter how
        long the tick ran."""
        if not self.enabled:
            return
        with self._lock:
            if start_t is not None:
                self._last_tick_start = start_t
            self._append(self._ticks, dict(tick))

    def snapshot_ticks(self) -> list[dict]:
        """Copy of the live tick ring (the ``"ticks"`` payload a dump
        would carry right now) — lets tests and REPL post-mortems read
        the ledger without forcing a dump."""
        with self._lock:
            return [dict(t) for t in self._ticks]

    def note_admission(self, admitted: bool, reason: str = "ok") -> None:
        """One engine admission verdict; a run of ``storm_threshold``
        consecutive rejections arms a ``admission_rejection_storm``
        dump (re-armed only after the storm breaks). The verdict record
        — and any storm trigger it tips — carries the trace id of the
        request being admitted when a ``request_context`` is live, so a
        post-mortem names the admission that broke the camel's back."""
        if not self.enabled:
            return
        cur = current_trace()
        storm = False
        with self._lock:
            rec = {
                "t": time.perf_counter(),
                "admitted": bool(admitted),
                "reason": reason,
            }
            if cur is not None:
                rec["trace_id"] = cur[0]
            self._append(self._admissions, rec)
            if admitted:
                self._consecutive_rejections = 0
            else:
                self._consecutive_rejections += 1
                storm = (
                    self._consecutive_rejections == self.storm_threshold
                )
        if storm:
            self.trigger(
                "admission_rejection_storm",
                immediate=False,
                consecutive_rejections=self.storm_threshold,
                reason=reason,
                trace_id=cur[0] if cur is not None else None,
            )

    def trigger(self, signal: str, *, immediate: bool = True, **context):
        """A resilience signal fired. The trigger record always joins
        the ring; ``immediate`` dumps now, otherwise the dump flushes
        at the next :meth:`flush` (the scheduler calls it at tick end,
        faulting ticks included)."""
        if not self.enabled:
            return None
        rec = {
            "t": time.perf_counter(),
            "trigger": signal,
            "context": {k: repr(v) if not isinstance(
                v, (str, int, float, bool, type(None), list, dict)
            ) else v for k, v in context.items()},
        }
        with self._lock:
            # first signal wins — unless the existing arm went stale
            # (nothing flushed it within the TTL and it predates the
            # last tick): a stale arm must never swallow a live
            # signal's dump
            if self._armed is None or self._arm_is_stale(self._armed):
                self._armed = rec
        if immediate:
            return self.flush()
        return None

    def _arm_is_stale(self, rec: dict) -> bool:
        """Lock held. An arm that fired during the last recorded tick
        is never stale (slow ticks — first-call kernel builds — must
        still get their post-mortem); otherwise the TTL governs."""
        if (
            self._last_tick_start is not None
            and rec["t"] >= self._last_tick_start
        ):
            return False
        return time.perf_counter() - rec["t"] > self.ARM_TTL_S

    def register_memory_source(self, name: str, obj) -> str:
        """Attach a memory-forensics source: ``obj`` must
        expose ``memory_snapshot() -> dict`` (JSON-safe; ledger +
        fragmentation map — see ``telemetry/memory.
        engine_memory_snapshot``). Held weakly, so a retired engine
        never pins itself or stales the recorder; every subsequent dump
        embeds a ``memory`` section with one entry per live source.
        Returns the (uniquified) registered name."""
        return self._register_source("_memory_sources", name, obj)

    def register_numerics_source(self, name: str, obj) -> str:
        """Attach a numerics source: ``obj`` must expose
        ``numerics_snapshot() -> dict`` (JSON-safe; the in-graph value
        census + shadow-sentinel scores — see ``telemetry/numerics.
        NumericsCensus``). Same weakly-held contract as
        :meth:`register_memory_source`; every subsequent dump embeds a
        ``numerics`` section with one entry per live source. Returns
        the (uniquified) registered name."""
        return self._register_source("_numerics_sources", name, obj)

    def _register_source(self, attr: str, name: str, obj) -> str:
        with self._lock:
            # prune dead sources here too: churny construction (tests,
            # the lifecycle model checker) must not grow the list
            # unboundedly between dumps
            setattr(self, attr, [
                (n, r) for n, r in getattr(self, attr)
                if r() is not None
            ])
            self._source_counter += 1
            uname = f"{name}#{self._source_counter}"
            getattr(self, attr).append((uname, weakref.ref(obj)))
        return uname

    def _collect_memory(self) -> dict | None:
        return self._collect_sources(
            "_memory_sources", "memory_snapshot"
        )

    def _collect_numerics(self) -> dict | None:
        return self._collect_sources(
            "_numerics_sources", "numerics_snapshot"
        )

    def _collect_sources(self, attr: str, method: str) -> dict | None:
        """Snapshot every live source of one kind (best-effort —
        forensics must never turn a dump into a crash). Runs OUTSIDE
        the ring lock: sources execute arbitrary ledger code that may
        itself touch the recorder. Dead weakrefs are pruned."""
        with self._lock:
            sources = list(getattr(self, attr))
        out: dict = {}
        for name, ref in sources:
            obj = ref()
            if obj is None:
                continue
            try:
                out[name] = getattr(obj, method)()
            except Exception as e:  # noqa: BLE001 — recorded, not raised
                out[name] = {"error": repr(e)}
        with self._lock:
            # prune dead refs from the CURRENT list (never replace it
            # wholesale: a source registered while the snapshots ran
            # above must survive into future dumps)
            setattr(self, attr, [
                (n, r) for n, r in getattr(self, attr)
                if r() is not None
            ])
        return out or None

    def flush(self) -> str | None:
        """Write the armed dump, if any (no-op otherwise). Returns the
        dump path (None when nothing was armed, the tick ring is empty,
        or the per-process dump cap was reached)."""
        with self._lock:
            armed = self._armed is not None
        # ledger + fragmentation snapshots are collected lock-free and
        # only when a dump is plausibly coming (the OOM-forensics
        # payload: what the pools looked like at the incident)
        memory = self._collect_memory() if armed else None
        numerics = self._collect_numerics() if armed else None
        with self._lock:
            rec = self._armed
            if rec is None:
                return None
            self._armed = None
            if not self._ticks or self._arm_is_stale(rec):
                # nothing recorded to post-mortem (or the signal went
                # stale waiting for a tick that never came): disarm
                # without writing
                return None
            if self._dump_count >= self.max_dumps:
                return None
            self._dump_count += 1
            payload = {
                "trigger": rec,
                "depth": self.depth,
                "ticks_dropped": self._ticks_dropped,
                "ticks": list(self._ticks),
                "admissions": list(self._admissions),
                "wall_time": time.time(),
            }
            if memory is not None:
                payload["memory"] = memory
            if numerics is not None:
                payload["numerics"] = numerics
            n = self._dump_count
        path = self._write_dump(payload, n)
        if path is not None:
            with self._lock:
                self.dump_paths.append(path)
            from . import collectors

            collectors.record_flight_dump(rec["trigger"])
            from .logger import get_logger

            get_logger("telemetry").warning(
                "flight recorder dumped %d ticks to %s (trigger: %s)",
                len(payload["ticks"]), path, rec["trigger"],
            )
        return path

    def _write_dump(self, payload: dict, n: int) -> str | None:
        from .. import env

        try:
            d = env.trace_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"magi_flight_{os.getpid()}_{n:03d}.json"
            )
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=repr)
                f.write("\n")
            return path
        except OSError:
            from .logger import get_logger

            get_logger("telemetry").warning(
                "flight recorder dump failed", exc_info=True
            )
            return None

    def reset(self) -> None:
        with self._lock:
            self._ticks.clear()
            self._admissions.clear()
            self._ticks_dropped = 0
            self._consecutive_rejections = 0
            self._armed = None
            self._last_tick_start = None


_flight: FlightRecorder | None = None
_flight_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-global flight recorder (depth lazily read from
    ``MAGI_ATTENTION_FLIGHT_RECORDER_DEPTH``)."""
    global _flight
    if _flight is None:
        with _flight_lock:
            if _flight is None:
                _flight = FlightRecorder()
    return _flight


def reset_flight_recorder() -> FlightRecorder:
    """Replace the global recorder with a fresh one (tests; also picks
    up a changed depth env)."""
    global _flight
    with _flight_lock:
        _flight = FlightRecorder()
    return _flight
