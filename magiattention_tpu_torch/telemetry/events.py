"""Host-side span ring and its Chrome trace-event export.

The JAX package's ``telemetry/events.py``. Host work (admission, scheduling,
page streams, the request lifecycle) lands here as spans; ``dump_events``
writes the Chrome trace-event JSON format (``chrome://tracing``, Perfetto),
so the spans can be laid beside a ``torch.profiler`` trace of the card.

The buffer is a fixed-size ring (``collections.deque(maxlen=...)``, sized
by ``MAGI_ATTENTION_TELEMETRY_RING_SIZE``): a long-running server keeps the
most recent N spans and never grows without bound; an evicted span ticks
``magi_trace_events_dropped_total``. Recording is gated by
``telemetry.enabled()`` at every call site, so the disabled path allocates
nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

# registry counter ticked when the ring evicts a span to admit a new one
# (collectors re-exports it as M_TRACE_DROPPED): silent truncation would make a reconstructed request
# trace look complete when it is not
DROPPED_COUNTER = "magi_trace_events_dropped_total"


class EventBuffer:
    """Ring buffer of span events (host wall-clock, microsecond stamps).

    Spans land on the recording thread's track by default; ``track=``
    puts a span on a named synthetic track instead (a small stable tid +
    a ``thread_name`` metadata event at dump time): the scheduler's tick
    decomposition has a track of its own."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=maxlen)
        # track name -> synthetic tid (small ints, far below real thread
        # idents, assigned in first-use order — deterministic per run)
        self._tracks: dict[str, int] = {}
        # spans silently evicted by the ring (oldest-first): surfaced as
        # a counter + one-time warning so a truncated trace is
        # detectable, and read by export_request_traces to mark
        # reconstructed span trees partial instead of complete
        self._dropped = 0
        self._drop_warned = False

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring since construction/clear."""
        with self._lock:
            return self._dropped

    def _track_tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks) + 1
        return tid

    def track_names(self) -> dict[int, str]:
        """Synthetic-track names by tid (for dump-time metadata)."""
        with self._lock:
            return {tid: name for name, tid in self._tracks.items()}

    def record(
        self,
        name: str,
        start_s: float,
        duration_s: float,
        attrs: dict | None = None,
        *,
        track: str | None = None,
    ) -> None:
        with self._lock:
            tid = (
                self._track_tid(track)
                if track is not None
                else threading.get_ident()
            )
            ev = {
                "name": name,
                "ph": "X",  # Chrome trace "complete" event
                "ts": start_s * 1e6,  # trace format wants microseconds
                "dur": duration_s * 1e6,
                "pid": os.getpid(),
                "tid": tid,
            }
            if attrs:
                ev["args"] = dict(attrs)
            full = (
                self._events.maxlen is not None
                and len(self._events) >= self._events.maxlen
            )
            if full:
                self._dropped += 1
            warn_first_drop = full and not self._drop_warned
            if warn_first_drop:
                self._drop_warned = True
            self._events.append(ev)
        if full:
            from .registry import get_registry

            get_registry().counter_inc(DROPPED_COUNTER)
        if warn_first_drop:
            from .logger import get_logger

            get_logger("telemetry").warning(
                "span-event ring full (maxlen=%d): oldest spans are being "
                "dropped — request traces reconstructed from this buffer "
                "will be marked partial. Raise "
                "MAGI_ATTENTION_TELEMETRY_RING_SIZE to keep more.",
                self._events.maxlen,
            )

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._drop_warned = False

    def dump(self, path: str) -> str:
        """Write the buffered spans as Chrome trace-event JSON; returns
        ``path``. Loadable in Perfetto / chrome://tracing / TensorBoard's
        trace viewer. Metadata events (phase ``M``) name each pid/tid
        track, so the viewer shows "magiattention host (pid N)" instead of
        a raw number."""
        events = self.events()
        payload = {
            "traceEvents": trace_metadata_events(
                events, thread_names=self.track_names()
            )
            + events,
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        return path


def trace_metadata_events(
    events: list[dict],
    process_name: str | None = None,
    thread_names: dict[int, str] | None = None,
) -> list[dict]:
    """Chrome-trace metadata (phase ``M``) naming every pid/tid seen in
    ``events``: one ``process_name`` per distinct pid, one ``thread_name``
    per distinct (pid, tid). Perfetto then labels the tracks instead of
    showing raw ids. ``thread_names`` maps tids of synthetic tracks
    (the tick track) to their names; unlisted tids keep the generic
    host-thread label. The cross-rank merge (``telemetry/aggregate.py``)
    reuses this with a per-rank ``process_name`` and the rank-local
    thread names it harvested."""
    pids: dict[int, set] = {}
    for ev in events:
        if ev.get("ph") == "M":
            continue
        pid = ev.get("pid", 0)
        pids.setdefault(pid, set()).add(ev.get("tid", 0))
    meta: list[dict] = []
    for pid in sorted(pids):
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {
                    "name": process_name or f"magiattention host (pid {pid})"
                },
            }
        )
        for tid in sorted(pids[pid]):
            name = (thread_names or {}).get(tid) or f"host thread {tid}"
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
    return meta


def _default_buffer() -> EventBuffer:
    from .. import env

    return EventBuffer(maxlen=env.telemetry_ring_size())


_buffer: EventBuffer | None = None
_buffer_lock = threading.Lock()


def get_event_buffer() -> EventBuffer:
    """The process-global span ring buffer (lazily sized from
    ``MAGI_ATTENTION_TELEMETRY_RING_SIZE``)."""
    global _buffer
    if _buffer is None:
        with _buffer_lock:
            if _buffer is None:
                _buffer = _default_buffer()
    return _buffer


def record_event(
    name: str,
    start_s: float,
    duration_s: float,
    attrs: dict | None = None,
    *,
    track: str | None = None,
) -> None:
    """Append one completed span (no-op while telemetry is disabled).
    ``track`` routes it onto a named synthetic Chrome-trace track."""
    from . import enabled

    if not enabled():
        return
    get_event_buffer().record(name, start_s, duration_s, attrs, track=track)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a host-side region into the ring buffer. Disabled mode yields
    immediately with no clock reads or allocation."""
    from . import enabled

    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        get_event_buffer().record(
            name, t0, time.perf_counter() - t0, attrs or None
        )
