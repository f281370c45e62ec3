"""Perf regression sentinel: bench history, expectation windows and the
gate; the port's twin of the JAX package's ``telemetry/baseline.py``, with
the same semantics.

- **History** (:data:`HISTORY_FILENAME` at the repo root): one JSON line per
  completed benchmark run on the card: the metrics, the card's name and
  power limit, and the tuner's choice the run executed with. The port's
  benchmark writes it; nothing is seeded from the JAX package's TPU rounds,
  and the JAX package's ``BENCH_HISTORY.jsonl`` (TPU numbers) is never read
  by default.
- **Expectations** (:data:`EXPECTATIONS_RELPATH`): a ``[low, high]`` window
  per metric, seeded from history.
- **Gate** (:func:`check_gate`): the newest value per metric must stay above
  ``low * (1 - tolerance)`` (``MAGI_ATTENTION_PERF_GATE_TOLERANCE``, default
  0.10, for a shared card's run-to-run drift). A value above the window is
  an *improvement* (passes, with a re-seed hint). A changed tuner rung
  between consecutive runs is flagged, never fatal by itself.

Plain file parsing on the host: like the JAX module, this one has no
package-relative imports (importing the package would pull torch), so a
gate script can load it by file path anywhere, and it reads the tolerance's
environment variable itself instead of through ``env.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os

# the port's own files (the JAX package's hold TPU numbers)
HISTORY_FILENAME = "BENCH_HISTORY_TORCH.jsonl"
EXPECTATIONS_RELPATH = os.path.join("magiattention_tpu_torch", "benchmarking",
                                    "perf_expectations.json")

# bench payload keys that are per-run context, not gateable throughput
# metrics (everything numeric under "metrics" is gateable)
_NON_METRIC_KEYS = ("jax_flash_best_tuned_blocks",)


def default_tolerance() -> float:
    """``MAGI_ATTENTION_PERF_GATE_TOLERANCE``, read directly from the
    environment (the module imports nothing of the package; see its
    docstring); agrees with ``env.perf_gate_tolerance``
    (``tests/test_torch_baseline.py``)."""
    v = os.environ.get("MAGI_ATTENTION_PERF_GATE_TOLERANCE")
    return float(v) if v is not None else 0.10


# ---------------------------------------------------------------------------
# history
# ---------------------------------------------------------------------------


def append_history(path: str, entry: dict) -> str:
    """Append one run entry as a JSON line (append-only; concurrent
    appenders interleave whole lines on POSIX). Returns ``path``."""
    line = json.dumps(entry, sort_keys=True)
    with open(path, "a") as f:
        f.write(line + "\n")
    return path


def load_history(path: str) -> list[dict]:
    """Parse a history file, skipping blank/corrupt lines (a truncated
    append from a killed bench run must not take the gate down)."""
    entries: list[dict] = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and isinstance(obj.get("metrics"), dict):
                entries.append(obj)
    return entries


def make_history_entry(
    *,
    source: str,
    metrics: dict,
    recorded_unix: int | None = None,
    device: str | None = None,
    power_limit: str | None = None,
    vs_baseline: float | None = None,
    autotune_rung: str | None = None,
    varlen_rung: str | None = None,
    mask_density: dict | None = None,
    roofline_efficiency: dict | None = None,
    peak_hbm_bytes: int | None = None,
    compile_s: float | None = None,
) -> dict:
    """Canonical history-entry schema (one place, so every writer agrees).
    ``device`` is the card's name (``torch.cuda.get_device_name``) and
    ``power_limit`` its limit as ``nvidia-smi --query-gpu=power.limit``
    prints it: a card set below its maximum runs slower under load, so
    the limit stands beside every number.

    ``mask_density`` / ``roofline_efficiency`` are per-metric context
    maps (``{metric_name: value}``) recorded NEXT TO the metrics, like
    ``autotune_rung`` — context for attributing a TF/s delta (workload
    density changed vs kernel regressed), never gated themselves.
    ``peak_hbm_bytes`` is the max across devices of the
    caching allocator's high-water mark (``torch.cuda.memory_stats``
    through the ``telemetry/memory`` sampler) —
    memory context beside the density context, so a perf shift that
    coincides with a footprint shift is attributable; absent on
    the CPU. ``compile_s`` is the headline kernel's cold-build seconds
    (first call minus warm step) — build-time context beside the TF/s, so a compile-time
    regression is visible in the same trajectory; ``0.0`` is a real
    value (fully cache-absorbed compile) and is recorded."""
    entry: dict = {
        "source": source,
        "metrics": {
            k: v
            for k, v in metrics.items()
            if k not in _NON_METRIC_KEYS and isinstance(v, (int, float))
        },
    }
    if recorded_unix is not None:
        entry["recorded_unix"] = int(recorded_unix)
    if device is not None:
        entry["device"] = device
    if power_limit is not None:
        entry["power_limit"] = power_limit
    if vs_baseline is not None:
        entry["vs_baseline"] = vs_baseline
    if autotune_rung is not None:
        entry["autotune_rung"] = autotune_rung
    if varlen_rung is not None:
        # the 16k-varlen workload's resolved rung incl. grid layout
        # ("BQxBKxHB:grid") — the sparse-grid sibling of
        # ``autotune_rung`` (which names the 64k dense headline's rung)
        entry["varlen_rung"] = varlen_rung
    if mask_density:
        entry["mask_density"] = {
            k: float(v) for k, v in sorted(mask_density.items())
        }
    if roofline_efficiency:
        entry["roofline_efficiency"] = {
            k: float(v) for k, v in sorted(roofline_efficiency.items())
        }
    if peak_hbm_bytes:
        entry["peak_hbm_bytes"] = int(peak_hbm_bytes)
    if compile_s is not None:
        entry["compile_s"] = float(compile_s)
    return entry


def newest_metrics(history: list[dict]) -> dict[str, float]:
    """The NEWEST entry's metrics — what the gate checks. Deliberately
    not a fold over the whole history: an old good value must never
    stand in for a metric the newest run didn't measure (that case is
    the gate's ``missing`` verdict, a warning, not a silent pass)."""
    return dict(history[-1].get("metrics", {})) if history else {}


def newest_metric_value(
    history: list[dict], name: str
) -> "tuple[float, str] | tuple[None, None]":
    """(value, source) of the newest entry recording metric ``name`` —
    the ONE history-schema lookup shared by the bench's roofline probe
    and ``exps/run_roofline_report.py`` (unlike :func:`newest_metrics`,
    this walks back past newer entries that didn't measure it: a probe
    wants the latest available number, the gate wants the newest run)."""
    for entry in reversed(history):
        v = entry.get("metrics", {}).get(name)
        if isinstance(v, (int, float)):
            return float(v), str(entry.get("source", "?"))
    return None, None


def rung_changes(history: list[dict]) -> list[str]:
    """Human-readable flags for autotuner rung changes between
    consecutive runs that recorded one (both the 64k headline's
    ``autotune_rung`` and the 16k-varlen ``varlen_rung``, incl. its
    grid layout). A rung change re-prices every kernel-tier number, so
    the gate surfaces it next to any TF/s delta."""
    flags: list[str] = []
    for key, label in (
        ("autotune_rung", "autotune rung"),
        ("varlen_rung", "varlen rung"),
    ):
        prev: tuple[str, str] | None = None  # (source, rung)
        for entry in history:
            rung = entry.get(key)
            if not rung:
                continue
            src = str(entry.get("source", "?"))
            if prev is not None and prev[1] != rung:
                flags.append(
                    f"{label} changed {prev[1]} -> {rung} "
                    f"(between {prev[0]} and {src})"
                )
            prev = (src, rung)
    return flags


# density is a pure function of the workload definition, so any drift
# beyond float noise means the benched mask itself changed shape
_DENSITY_CHANGE_RTOL = 0.01


def density_changes(history: list[dict]) -> list[str]:
    """Human-readable flags for mask-density changes between consecutive
    runs that recorded one, per metric. Density re-defines what a TF/s
    number means (the convention divides by TRUE mask FLOPs): a TF/s
    delta WITH a density change is a workload story, not a kernel
    regression — the gate surfaces the pair, never fails on it."""
    flags: list[str] = []
    prev: dict[str, tuple[str, float]] = {}  # metric -> (source, density)
    for entry in history:
        dens = entry.get("mask_density")
        if not isinstance(dens, dict):
            continue
        src = str(entry.get("source", "?"))
        for name, value in dens.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            old = prev.get(name)
            if old is not None and abs(value - old[1]) > (
                _DENSITY_CHANGE_RTOL * max(abs(old[1]), 1e-12)
            ):
                flags.append(
                    f"mask density of {name} changed {old[1]:g} -> "
                    f"{value:g} (between {old[0]} and {src}) — a TF/s "
                    "delta here is a workload story, not a regression"
                )
            prev[name] = (src, value)
    return flags


# ---------------------------------------------------------------------------
# expectations
# ---------------------------------------------------------------------------


def seed_expectations(
    history: list[dict],
    metrics_filter=None,
    window_last: int | None = None,
) -> dict:
    """Expectation windows from history: per metric, ``low``/``high`` =
    min/max of the last ``window_last`` observed values (``None`` = the
    whole history). ``metrics_filter`` (callable or container) restricts
    which metrics get windows (e.g. only TF/s throughput metrics). The
    one seeding implementation: a gate's update calls it with
    ``window_last=1``, so that older runs never loosen the guarded
    floor."""
    if window_last is not None and window_last < 1:
        raise ValueError(f"window_last must be >= 1, got {window_last}")
    values: dict[str, list[float]] = {}
    for entry in history:
        for name, value in entry.get("metrics", {}).items():
            if metrics_filter is not None:
                keep = (
                    metrics_filter(name)
                    if callable(metrics_filter)
                    else name in metrics_filter
                )
                if not keep:
                    continue
            values.setdefault(name, []).append(float(value))
    return {
        name: {
            "low": min(vals[-window_last:] if window_last else vals),
            "high": max(vals[-window_last:] if window_last else vals),
        }
        for name, vals in sorted(values.items())
    }


def load_expectations(path: str) -> dict:
    """Read the expectation file; returns its ``metrics`` window map."""
    with open(path) as f:
        data = json.load(f)
    return data.get("metrics", {})


def write_expectations(path: str, windows: dict, provenance: str) -> str:
    payload = {
        "_provenance": provenance,
        "metrics": {k: windows[k] for k in sorted(windows)},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GateResult:
    metric: str
    status: str  # ok | regression | improvement | no-expectation | missing
    message: str
    value: float | None = None
    low: float | None = None
    high: float | None = None

    @property
    def failed(self) -> bool:
        return self.status == "regression"


def check_gate(
    metrics: dict[str, float],
    expectations: dict[str, dict],
    tolerance: float | None = None,
) -> list[GateResult]:
    """Gate the newest per-metric values against expectation windows.

    Verdicts, per metric union of both maps (deterministic name order):

    - ``regression`` (FAILS): value < ``low * (1 - tolerance)``
    - ``improvement``: value > ``high * (1 + tolerance)`` — passes, with
      a hint to re-seed so the new level becomes the guarded floor
    - ``ok``: inside the tolerated window
    - ``no-expectation``: measured but never seeded (passes)
    - ``missing``: expected but absent from the newest run (passes —
      bench rounds legitimately vary in which extras they measure)
    """
    if tolerance is None:
        tolerance = default_tolerance()
    results: list[GateResult] = []
    for name in sorted(set(metrics) | set(expectations)):
        value = metrics.get(name)
        window = expectations.get(name)
        if window is None:
            results.append(
                GateResult(
                    metric=name,
                    status="no-expectation",
                    value=value,
                    message=(
                        f"{name}={value:g}: no expectation window seeded "
                        "(re-seed the expectations to adopt it)"
                    ),
                )
            )
            continue
        low, high = float(window["low"]), float(window["high"])
        if value is None:
            results.append(
                GateResult(
                    metric=name,
                    status="missing",
                    low=low,
                    high=high,
                    message=(
                        f"{name}: expected [{low:g}, {high:g}] but the "
                        "newest run did not measure it"
                    ),
                )
            )
            continue
        floor = low * (1.0 - tolerance)
        ceil = high * (1.0 + tolerance)
        if value < floor:
            results.append(
                GateResult(
                    metric=name,
                    status="regression",
                    value=value,
                    low=low,
                    high=high,
                    message=(
                        f"{name}={value:g} fell below {floor:g} "
                        f"(window [{low:g}, {high:g}], tolerance "
                        f"{tolerance:.0%}) — perf regression"
                    ),
                )
            )
        elif value > ceil:
            results.append(
                GateResult(
                    metric=name,
                    status="improvement",
                    value=value,
                    low=low,
                    high=high,
                    message=(
                        f"{name}={value:g} exceeds the window "
                        f"[{low:g}, {high:g}] — improvement; re-seed "
                        "the expectations to guard the new level"
                    ),
                )
            )
        else:
            results.append(
                GateResult(
                    metric=name,
                    status="ok",
                    value=value,
                    low=low,
                    high=high,
                    message=(
                        f"{name}={value:g} within [{floor:g}, {ceil:g}]"
                    ),
                )
            )
    return results


def gate_report(results: list[GateResult], flags: list[str]) -> str:
    """Plain-text gate verdict: one line per metric, rung-change flags,
    then the PASS/FAIL summary line."""
    icon = {
        "ok": "ok  ",
        "regression": "FAIL",
        "improvement": "up  ",
        "no-expectation": "new ",
        "missing": "n/a ",
    }
    lines = [
        f"  [{icon.get(r.status, '??? ')}] {r.message}" for r in results
    ]
    for f in flags:
        lines.append(f"  [flag] {f}")
    n_fail = sum(1 for r in results if r.failed)
    lines.append(
        f"perf gate: {'FAIL' if n_fail else 'PASS'} "
        f"({n_fail} regression(s), {len(results)} metric(s) checked)"
    )
    return "\n".join(lines)
