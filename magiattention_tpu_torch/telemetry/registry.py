"""Process-global metrics registry: counters, gauges and histograms.

The JAX package's ``telemetry/registry.py``, plus ``scoped_registry``
(below): the serving path,
the tiers and the resilience hooks record what they did into one registry,
and ``snapshot()`` returns it as a plain JSON-serialisable dict.

- Recording entry points that the runtime calls unconditionally go through
  the collectors (``collectors.py``), which check ``telemetry.enabled()``
  first and return at once; the registry itself is unconditional, so tests
  can drive it directly.
- Host-side only: nothing here reads a device tensor.
- A snapshot holds dicts, lists, floats, ints and strings only.

Series are keyed ``name{label=value,...}`` with the labels sorted by key
(the Prometheus convention).
"""

from __future__ import annotations

import contextlib
import json
import threading
from dataclasses import dataclass, field

# log-scale default histogram bounds (seconds-flavored but unit-agnostic):
# planning latencies span ~1e-5 s (tiny masks) to ~1e2 s (128k+ masks)
DEFAULT_BUCKET_BOUNDS: tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0,
)


def series_key(name: str, labels: dict | None = None) -> str:
    """Canonical series key: ``name`` or ``name{k=v,...}``, labels sorted."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def estimate_percentiles(
    bounds,
    bucket_counts,
    count: int,
    vmin: float,
    vmax: float,
    qs=(0.5, 0.95, 0.99),
) -> list[float | None]:
    """Approximate quantiles from histogram bucket counts (the Prometheus
    ``histogram_quantile`` method): find the bucket holding the q-th sample
    and interpolate linearly inside it. Resolution is bounded by the bucket
    width — with log-scale default bounds an estimate can be off by up to
    the span of its bucket. The observed ``vmin``/``vmax`` clamp the first
    and overflow buckets (which have no finite lower resp. upper edge), so
    single-bucket and extreme quantiles stay inside the observed range.

    Shared by live snapshots and the cross-rank aggregate merge
    (``telemetry/aggregate.py``), so both report the same estimator.
    """
    if count <= 0:
        return [None] * len(qs)
    out: list[float | None] = []
    for q in qs:
        target = q * count
        cum = 0.0
        val: float | None = None
        for i, c in enumerate(bucket_counts):
            prev_cum = cum
            cum += c
            if cum >= target and c > 0:
                lo = vmin if i == 0 else float(bounds[i - 1])
                hi = vmax if i >= len(bounds) else float(bounds[i])
                lo = max(lo, vmin)
                hi = min(hi, vmax)
                if hi < lo:
                    lo = hi
                frac = (target - prev_cum) / c
                val = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                break
        if val is None:  # numeric drift: everything counted, target beyond
            val = vmax
        out.append(min(max(val, vmin), vmax))
    return out


@dataclass
class _Histogram:
    bounds: tuple[float, ...] = DEFAULT_BUCKET_BOUNDS
    count: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = float("-inf")
    bucket_counts: list[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.bucket_counts:
            # one count per bound plus the +inf overflow bucket
            self.bucket_counts = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def as_dict(self) -> dict:
        p50, p95, p99 = estimate_percentiles(
            self.bounds, self.bucket_counts, self.count, self.vmin, self.vmax
        )
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "mean": (self.total / self.count) if self.count else None,
            # approximate (bucket-interpolated; see estimate_percentiles)
            "p50": p50,
            "p95": p95,
            "p99": p99,
            "bounds": list(self.bounds),
            "bucket_counts": list(self.bucket_counts),
        }


class MetricsRegistry:
    """Labeled counters, gauges and histograms with a plain-dict snapshot.

    Thread-safe (one lock; every operation is O(1)-ish host work). Not a
    Prometheus client: ``exposition.py`` walks the snapshot.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, _Histogram] = {}

    # -- write side ---------------------------------------------------------

    def counter_inc(
        self, name: str, value: float = 1.0, **labels
    ) -> None:
        """Monotonic accumulate (negative increments are rejected)."""
        if value < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0")
        key = series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, **labels) -> None:
        """Last-write-wins point-in-time value."""
        key = series_key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def histogram_observe(
        self,
        name: str,
        value: float,
        bounds: tuple[float, ...] | None = None,
        **labels,
    ) -> None:
        """Record one sample; ``bounds`` (first observation wins) override
        the log-scale defaults for this series."""
        key = series_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = _Histogram(bounds=tuple(bounds) if bounds else DEFAULT_BUCKET_BOUNDS)
                self._histograms[key] = h
            h.observe(value)

    # -- read side ----------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(series_key(name, labels), 0.0)

    def gauge_value(self, name: str, default=None, **labels):
        with self._lock:
            return self._gauges.get(series_key(name, labels), default)

    def snapshot(self) -> dict:
        """Plain-dict view: ``{"counters": {...}, "gauges": {...},
        "histograms": {series: {count, sum, min, max, mean, ...}}}``.
        Always JSON-serializable; deep-copied so later recording never
        mutates an already-taken snapshot."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: h.as_dict() for k, h in self._histograms.items()
                },
            }

    def clear_series(self, name: str, **labels) -> None:
        """Drop ONE labeled series of a metric (exact label match) —
        for collectors that re-record a single workload's family and
        must not leave a stale member behind without wiping the other
        workloads' series (contrast :meth:`clear_metric`)."""
        key = series_key(name, labels)
        with self._lock:
            for d in (self._counters, self._gauges, self._histograms):
                d.pop(key, None)

    def clear_metric(self, name: str) -> None:
        """Drop every series of one metric (bare and labeled). Collectors
        use this before re-recording per-rank families whose label set can
        shrink between plans (a cp=4 plan after a cp=8 one must not leave
        stale rank=4..7 series in the snapshot)."""
        pref = name + "{"
        with self._lock:
            for d in (self._counters, self._gauges, self._histograms):
                for k in [k for k in d if k == name or k.startswith(pref)]:
                    del d[k]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def dump(self, path: str) -> str:
        """Write ``snapshot()`` as JSON to ``path``; returns the path."""
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
        return path


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every runtime layer records into."""
    return _global_registry


@contextlib.contextmanager
def scoped_registry(reg: MetricsRegistry | None = None):
    """Every record made in the block goes to ``reg`` (default: a fresh
    registry), which the block receives; the process registry is put back
    after it. Recorders look the registry up at each record, so none keeps
    the old one; a reference taken before the block does."""
    global _global_registry
    saved = _global_registry
    _global_registry = MetricsRegistry() if reg is None else reg
    try:
        yield _global_registry
    finally:
        _global_registry = saved
