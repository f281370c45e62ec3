"""Program observability: program labels and the compile tracker.

The JAX package's ``telemetry/compile.py`` for a runtime with no JIT:

- **What a compile is here.** The port builds its kernels once per source
  version (``csrc.build``: nvcc for the CUDA libraries; ``csrc.build_host``:
  g++ for the host planner's library) and loads them with ctypes. Each
  library that nvcc or g++ actually builds is one compile event, with its
  build seconds, attributed to the program label live on the building
  thread (``anon`` outside any). Loading a library that is already built
  is no compile. So a process counts each kernel once, the first time a
  call needs it, where the JAX package counts one XLA executable per
  traced shape.
- **Program labels.** :func:`program` is the context the serving engine
  wraps its calls in (``prefill[start=S,t=N]``, ``decode[b=B]``,
  ``tick[r=R,e=E,s=S]``); the scheduler's launch census reads them.
- **Recompile storms.** N builds of one label inside a 30 s window
  (``MAGI_ATTENTION_RECOMPILE_STORM_THRESHOLD``, 0 = off) arm a deferred
  ``recompile_storm`` flight-recorder dump tagged with the scheduler tick
  and the live trace id.
- **Where a tick's wall-clock goes.** :meth:`CompileTracker.mark` /
  :meth:`~CompileTracker.since` give the scheduler per-tick (builds, build
  seconds) deltas, and the solver accumulator (:func:`add_solver_seconds`,
  fed by the keyed planner's lookups and builds) host-solver seconds.

The tracker's own accumulators are always on, like the flight recorder;
only the registry series (``magi_compile_total{program=}``,
``magi_compile_seconds``, ``magi_jit_cache_entries``) go through the
``telemetry.enabled()`` gate, in ``collectors.record_compile``. Host-side
only.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from dataclasses import dataclass, field

# the label builds fall under when no program() context is live
ANON_PROGRAM = "anon"

# sliding window of the recompile-storm detector (seconds): wide enough
# that a thrashing serving loop (ticks are ms-scale) cannot stay under
# it, narrow enough that N legitimate cold builds spread over a long
# bring-up don't alias into a storm
STORM_WINDOW_S = 30.0


# ---------------------------------------------------------------------------
# program labels
# ---------------------------------------------------------------------------

_current_program: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "magi_current_program", default=None
)


@contextlib.contextmanager
def program(label: str):
    """Attribute every build on this thread/context to ``label`` while the
    body runs (contextvar, so async/thread-local like ``request_context``).
    The serving engine wraps its prefill/decode/tick calls in this;
    nesting keeps the innermost label."""
    tok = _current_program.set(str(label))
    try:
        yield
    finally:
        _current_program.reset(tok)


def current_program() -> str | None:
    """The live program label, or None outside any :func:`program`."""
    return _current_program.get()


def prefill_program_label(start: int, tokens: int) -> str:
    """Canonical label of one prefill-chunk call: its (history offset,
    chunk rows)."""
    return f"prefill[start={int(start)},t={int(tokens)}]"


def decode_program_label(batch: int) -> str:
    """Canonical label of one batched decode-step call: its batch size."""
    return f"decode[b={int(batch)}]"


def tick_program_label(rows: int, entries: int, splits: int) -> str:
    """Canonical label of one unified serving tick: its padded geometry
    buckets (row capacity, entry capacity) and split count, never the
    request mix, so a multi-tenant trace cycles a bounded label set."""
    return f"tick[r={int(rows)},e={int(entries)},s={int(splits)}]"


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------


@dataclass
class ProgramCompileStats:
    """Per-label build record (plain data; snapshot via
    :meth:`CompileTracker.stats`)."""

    count: int = 0
    total_s: float = 0.0
    # timestamps (perf_counter) of recent builds — the storm window
    recent_t: deque = field(default_factory=lambda: deque(maxlen=256))


class CompileTracker:
    """Process-wide build registry, fed by ``csrc.build`` and
    ``csrc.build_host``.

    Always on: ingestion is one dict update per *build* (builds are rare
    and seconds-scale — the bookkeeping is noise), so unlike the metrics
    registry there is no enable gate on the accumulators. The registry
    series it mirrors are gated as usual inside
    ``collectors.record_compile``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, ProgramCompileStats] = {}
        self._total_count = 0
        self._total_seconds = 0.0
        # always-on host-solver accumulator (plan builds + LRU lookups)
        self._solver_seconds = 0.0
        # measured plan-build cost model for the ms-saved credit
        self._plan_build_count = 0
        self._plan_build_total_s = 0.0
        # the scheduler stamps its tick number here so a storm dump can
        # name the tick that thrashed
        self._tick: int | None = None
        # where events come from: the kernel and host-library builds
        self.ingestion: str = "csrc.build"

    # -- ingestion --------------------------------------------------------

    def note_compile(
        self, seconds: float, label: str | None = None
    ) -> None:
        """One library that nvcc or g++ built (``csrc``'s entry point;
        tests call it directly to plant scenarios)."""
        lab = label if label is not None else (
            current_program() or ANON_PROGRAM
        )
        now = time.perf_counter()
        with self._lock:
            st = self._stats.get(lab)
            if st is None:
                st = self._stats[lab] = ProgramCompileStats()
            st.count += 1
            st.total_s += float(seconds)
            st.recent_t.append(now)
            self._total_count += 1
            self._total_seconds += float(seconds)
            total_programs = self._total_count
            tick = self._tick
            in_window = sum(
                1 for t in st.recent_t if now - t <= STORM_WINDOW_S
            )
        from .collectors import record_compile

        record_compile(lab, float(seconds), total_programs)
        self._maybe_storm(lab, in_window, tick)

    def _maybe_storm(
        self, label: str, compiles_in_window: int, tick: int | None
    ) -> None:
        """Fire the deferred recompile-storm trigger exactly when the
        window count REACHES the threshold (not on every build past
        it — the flight recorder's first-signal-wins arm would ignore
        repeats anyway, but the exact-match keeps the trigger record's
        count meaningful)."""
        from .. import env

        threshold = env.recompile_storm_threshold()
        if threshold <= 0 or compiles_in_window != threshold:
            return
        from .trace import current_trace, get_flight_recorder

        cur = current_trace()
        get_flight_recorder().trigger(
            "recompile_storm",
            immediate=False,  # flush at tick end: the dump holds the tick
            program=label,
            compiles_in_window=compiles_in_window,
            threshold=threshold,
            window_s=STORM_WINDOW_S,
            tick=tick,
            trace_id=cur[0] if cur is not None else None,
        )

    # -- per-tick attribution ---------------------------------------------

    def note_tick(self, step: int) -> None:
        """The scheduler's current tick number (storm-dump tagging)."""
        with self._lock:
            self._tick = int(step)

    def mark(self) -> tuple[int, float]:
        """Opaque point-in-time mark for :meth:`since`."""
        with self._lock:
            return (self._total_count, self._total_seconds)

    def since(self, mark: tuple[int, float]) -> tuple[int, float]:
        """(builds, build seconds) since ``mark``."""
        with self._lock:
            return (
                self._total_count - mark[0],
                self._total_seconds - mark[1],
            )

    def add_solver_seconds(self, seconds: float) -> None:
        with self._lock:
            self._solver_seconds += float(seconds)

    def solver_mark(self) -> float:
        with self._lock:
            return self._solver_seconds

    def solver_since(self, mark: float) -> float:
        with self._lock:
            return self._solver_seconds - mark

    def note_plan_build(self, seconds: float) -> None:
        """One measured cold plan build — the sample the cache-hit
        ms-saved credit prices against."""
        with self._lock:
            self._plan_build_count += 1
            self._plan_build_total_s += float(seconds)

    def plan_build_mean_s(self) -> float | None:
        """Mean measured cold-build seconds (None before any build)."""
        with self._lock:
            if not self._plan_build_count:
                return None
            return self._plan_build_total_s / self._plan_build_count

    # -- introspection ----------------------------------------------------

    def stats(self) -> dict[str, dict]:
        """Plain-dict per-label view: ``{label: {count, total_s}}``."""
        with self._lock:
            return {
                lab: {"count": st.count, "total_s": st.total_s}
                for lab, st in self._stats.items()
            }

    def total(self) -> tuple[int, float]:
        """(build count, build seconds) process-wide."""
        with self._lock:
            return (self._total_count, self._total_seconds)

    def reset(self) -> None:
        """Clear the records."""
        with self._lock:
            self._stats.clear()
            self._total_count = 0
            self._total_seconds = 0.0
            self._solver_seconds = 0.0
            self._plan_build_count = 0
            self._plan_build_total_s = 0.0
            self._tick = None


# ---------------------------------------------------------------------------
# process singleton + module-level conveniences
# ---------------------------------------------------------------------------

_tracker: CompileTracker | None = None
_tracker_lock = threading.Lock()


def get_compile_tracker() -> CompileTracker:
    """The process-wide tracker (made on first use)."""
    global _tracker
    if _tracker is None:
        with _tracker_lock:
            if _tracker is None:
                _tracker = CompileTracker()
    return _tracker


def reset_compile_tracker() -> None:
    """Clear the tracker's records (no-op if never created). Explicit —
    deliberately NOT part of ``telemetry.reset()``: build history is
    process-lifetime state (libraries stay built across registry resets),
    and per-tick attribution uses marks, not absolutes."""
    if _tracker is not None:
        _tracker.reset()


def add_solver_seconds(seconds: float) -> None:
    """Always-on host-solver accumulator (plan builds + LRU lookups);
    the scheduler diffs it per tick. Outside the metrics registry by
    design — the disabled-mode no-op contract covers the registry."""
    get_compile_tracker().add_solver_seconds(seconds)
