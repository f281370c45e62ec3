"""Live metrics exposition: Prometheus text rendering + scrape server.

The JAX package's ``telemetry/exposition.py``. The registry
(``telemetry/registry.py``) is in-process; a fleet needs an *off-process*
scrape surface. Three pieces:

- :func:`render_prometheus` — render a registry snapshot in the
  Prometheus text exposition format (``# TYPE`` lines, cumulative
  ``_bucket{le=...}`` histogram series, escaped label values). The
  registry's ``name{k=v,...}`` series keys are the Prometheus
  convention already, so the mapping is mechanical.
- :func:`snapshot_delta` — diff two snapshots so monotonic counters
  become per-window increments (and, given the window length, rates):
  what a scrape loop or dashboard computes between two scrapes.
- :class:`MetricsServer` / :func:`ensure_metrics_server` — a stdlib
  ``http.server`` thread serving ``GET /metrics`` (text format),
  ``/metrics.json`` (the raw snapshot) and ``/healthz``, gated behind
  ``MAGI_ATTENTION_METRICS_PORT`` (0 = off, the default). One server
  per process, started lazily by the serving engine (or explicitly).

:func:`parse_prometheus_text` round-trips the renderer's output back to
``{series_key: value}``, so "the exposition parses" is asserted, not
assumed. The ``# HELP`` lines name the metric namespace as the JAX package
does, so a scrape of either package renders the same bytes.
"""

from __future__ import annotations

import http.server
import json
import re
import threading

from .registry import get_registry

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
# DOTALL: a label VALUE may contain a newline (escaped on render) and
# the series key must still split into name + labels
_SERIES_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$", re.DOTALL
)


def _escape_label_value(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _split_series_key(key: str) -> tuple[str, list[tuple[str, str]]]:
    """Registry series key -> (metric name, [(label, value), ...])."""
    m = _SERIES_RE.match(key)
    if m is None:
        # a name the exposition grammar can't carry: sanitize
        return re.sub(r"[^a-zA-Z0-9_:]", "_", key), []
    name, inner = m.group(1), m.group(2)
    labels: list[tuple[str, str]] = []
    if inner:
        for part in inner.split(","):
            k, _, v = part.partition("=")
            labels.append((k.strip(), v.strip()))
    return name, labels


def _fmt_labels(labels: list[tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict | None = None) -> str:
    """Render a registry snapshot (default: the live registry's) in the
    Prometheus text exposition format, deterministically ordered (metric
    families sorted by name, series sorted within a family).

    Counters keep their registry names (the catalog already follows the
    ``_total`` convention where applicable); histograms expand to the
    standard ``_bucket``/``_sum``/``_count`` triple with cumulative
    ``le`` buckets.
    """
    if snapshot is None:
        snapshot = get_registry().snapshot()
    families: dict[str, dict] = {}

    def family(name: str, kind: str) -> dict:
        fam = families.setdefault(name, {"kind": kind, "lines": []})
        return fam

    for key, val in (snapshot.get("counters") or {}).items():
        name, labels = _split_series_key(key)
        family(name, "counter")["lines"].append(
            f"{name}{_fmt_labels(labels)} {_fmt_value(val)}"
        )
    for key, val in (snapshot.get("gauges") or {}).items():
        name, labels = _split_series_key(key)
        family(name, "gauge")["lines"].append(
            f"{name}{_fmt_labels(labels)} {_fmt_value(val)}"
        )
    for key, h in (snapshot.get("histograms") or {}).items():
        name, labels = _split_series_key(key)
        fam = family(name, "histogram")
        bounds = h.get("bounds") or []
        counts = h.get("bucket_counts") or []
        cum = 0
        for i, b in enumerate(bounds):
            cum += int(counts[i]) if i < len(counts) else 0
            fam["lines"].append(
                f"{name}_bucket"
                f"{_fmt_labels(labels + [('le', _fmt_value(b))])} {cum}"
            )
        fam["lines"].append(
            f"{name}_bucket{_fmt_labels(labels + [('le', '+Inf')])} "
            f"{int(h.get('count', 0))}"
        )
        fam["lines"].append(
            f"{name}_sum{_fmt_labels(labels)} "
            f"{_fmt_value(h.get('sum', 0.0))}"
        )
        fam["lines"].append(
            f"{name}_count{_fmt_labels(labels)} {int(h.get('count', 0))}"
        )
    out: list[str] = []
    for name in sorted(families):
        fam = families[name]
        out.append(f"# HELP {name} magiattention_tpu {fam['kind']}")
        out.append(f"# TYPE {name} {fam['kind']}")
        out.extend(sorted(fam["lines"]))
    return "\n".join(out) + ("\n" if out else "")


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Parse exposition-format text back to ``{series_key: value}``
    (labels re-sorted into the registry's canonical key form). Raises
    ``ValueError`` on a malformed sample line."""
    out: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
            r"(?:\{((?:[^{}\"]|\"(?:[^\"\\]|\\.)*\")*)\})?"
            r"\s+(\S+)$",
            line,
        )
        if m is None:
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        name, inner, val = m.group(1), m.group(2), m.group(3)
        labels = {}
        if inner:
            for lm in re.finditer(
                r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"', inner
            ):
                # single-pass unescape: sequential .replace calls would
                # corrupt a literal backslash followed by 'n' (r'\\n'
                # must decode to backslash+'n', not backslash+newline)
                labels[lm.group(1)] = re.sub(
                    r"\\(.)",
                    lambda em: {"n": "\n"}.get(em.group(1), em.group(1)),
                    lm.group(2),
                )
        key = name
        if labels:
            key += (
                "{"
                + ",".join(f"{k}={labels[k]}" for k in sorted(labels))
                + "}"
            )
        out[key] = float(val)
    return out


# ---------------------------------------------------------------------------
# snapshot differ: counters -> per-window increments / rates
# ---------------------------------------------------------------------------


def _delta_histogram(prev: dict | None, curr: dict) -> dict:
    bounds = curr.get("bounds") or []
    counts = list(curr.get("bucket_counts") or [])
    count = int(curr.get("count", 0))
    total = float(curr.get("sum", 0.0))
    if (
        prev is not None
        and (prev.get("bounds") or []) == bounds
        and int(prev.get("count", 0)) <= count
    ):
        pc = prev.get("bucket_counts") or []
        counts = [
            c - (int(pc[i]) if i < len(pc) else 0)
            for i, c in enumerate(counts)
        ]
        count -= int(prev.get("count", 0))
        total -= float(prev.get("sum", 0.0))
    # vmin/vmax of the *window* are unknowable from two snapshots; the
    # bucket edges bound them, which is what the percentile estimate
    # clamps to (documented approximate, like every histogram quantile)
    from .registry import estimate_percentiles

    vmin, vmax = None, None
    for i, c in enumerate(counts):
        if c > 0:
            if vmin is None:
                vmin = float(bounds[i - 1]) if i > 0 else float(
                    curr.get("min") or 0.0
                )
            vmax = (
                float(bounds[i])
                if i < len(bounds)
                else float(curr.get("max") or bounds[-1] if bounds else 0.0)
            )
    if count > 0 and vmin is not None:
        p50, p95, p99 = estimate_percentiles(
            bounds, counts, count, vmin, vmax
        )
    else:
        p50 = p95 = p99 = None
    return {
        "count": count,
        "sum": total,
        "mean": (total / count) if count else None,
        "min": None,  # unknowable for the window; see docstring
        "max": None,
        "p50": p50,
        "p95": p95,
        "p99": p99,
        "bounds": list(bounds),
        "bucket_counts": counts,
    }


def snapshot_delta(
    prev: dict | None, curr: dict, *, seconds: float | None = None
) -> dict:
    """Difference two registry snapshots taken ``seconds`` apart.

    - **counters**: per-window increments (``curr - prev``; a counter
      that went *backwards* — process restart / registry reset — reports
      its current value, the Prometheus reset convention). With
      ``seconds`` the ``counters_per_s`` section adds the rates — how
      "counters become rates between scrapes".
    - **gauges**: the current values (point-in-time by definition).
    - **histograms**: bucket-wise deltas with mean/percentiles
      re-estimated on the window's buckets (window min/max are
      unknowable from two snapshots and reported as None).
    - **derived**: ratio stats that only make sense over a window —
      today ``plan_cache_hit_rate`` (window hits / (hits + misses) of
      ``magi_plan_cache_hits/misses``), present whenever the window saw
      at least one plan-cache access.
    """
    prev = prev or {}
    pc = prev.get("counters") or {}
    out_counters: dict[str, float] = {}
    for k, v in (curr.get("counters") or {}).items():
        base = float(pc.get(k, 0.0))
        out_counters[k] = float(v) - base if float(v) >= base else float(v)
    ph = prev.get("histograms") or {}
    out_hists = {
        k: _delta_histogram(ph.get(k), h)
        for k, h in (curr.get("histograms") or {}).items()
    }
    out = {
        "counters": out_counters,
        "gauges": dict(curr.get("gauges") or {}),
        "histograms": out_hists,
    }
    if seconds is not None and seconds > 0:
        out["window_seconds"] = float(seconds)
        out["counters_per_s"] = {
            k: v / seconds for k, v in out_counters.items()
        }
    from .collectors import M_PLAN_CACHE_HITS, M_PLAN_CACHE_MISSES

    hits = float(out_counters.get(M_PLAN_CACHE_HITS, 0.0))
    misses = float(out_counters.get(M_PLAN_CACHE_MISSES, 0.0))
    if hits + misses > 0:
        out["derived"] = {
            "plan_cache_hit_rate": hits / (hits + misses),
        }
    return out


# ---------------------------------------------------------------------------
# the scrape server
# ---------------------------------------------------------------------------


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = render_prometheus().encode()
            self._send(
                200, body, "text/plain; version=0.0.4; charset=utf-8"
            )
        elif path == "/metrics.json":
            body = json.dumps(
                get_registry().snapshot(), sort_keys=True
            ).encode()
            self._send(200, body, "application/json")
        elif path == "/healthz":
            self._send(200, b"ok\n", "text/plain")
        else:
            self._send(404, b"not found\n", "text/plain")

    def log_message(self, fmt, *args):  # quiet: scrapes are periodic
        from .logger import get_logger

        get_logger("telemetry").debug("metrics server: " + fmt, *args)


class MetricsServer:
    """One stdlib HTTP thread exposing the live registry.

    ``port=0`` binds an ephemeral port (tests); the bound port is on
    ``.port`` after :meth:`start`. The serve thread is a daemon — it
    never blocks interpreter exit — and :meth:`stop` shuts it down
    deterministically.
    """

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self.requested_port = int(port)
        self.host = host
        self.port: int | None = None
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.requested_port), _MetricsHandler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="magi-metrics-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_server: MetricsServer | None = None
_server_lock = threading.Lock()


def start_metrics_server(
    port: int | None = None, host: str = "0.0.0.0"
) -> MetricsServer:
    """Start (or return) the process-global scrape server. ``port``
    defaults to ``MAGI_ATTENTION_METRICS_PORT`` (which must then be
    nonzero)."""
    global _server
    with _server_lock:
        if _server is not None:
            return _server
        if port is None:
            from .. import env

            port = env.metrics_port()
            if not port:
                raise ValueError(
                    "start_metrics_server: no port given and "
                    "MAGI_ATTENTION_METRICS_PORT is unset/0"
                )
        _server = MetricsServer(port, host=host).start()
        from .logger import get_logger

        get_logger("telemetry").info(
            "metrics server listening on %s:%d", host, _server.port
        )
        return _server


def ensure_metrics_server() -> MetricsServer | None:
    """Idempotent env-gated start: returns the running server, starts
    one when ``MAGI_ATTENTION_METRICS_PORT`` is set, or returns None
    (the default). A bind failure logs a warning and returns None —
    metrics must never take serving down."""
    from .. import env

    if _server is not None:
        return _server
    port = env.metrics_port()
    if not port:
        return None
    try:
        return start_metrics_server(port)
    except OSError:
        from .logger import get_logger

        get_logger("telemetry").warning(
            "could not start metrics server on port %d", port, exc_info=True
        )
        return None


def stop_metrics_server() -> None:
    """Stop the process-global server (tests / clean shutdown)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
