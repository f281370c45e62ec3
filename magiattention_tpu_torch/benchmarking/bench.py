"""do_bench / perf_report: the timing harness of the port, the twin of the
JAX package's ``benchmarking/bench.py``.

:func:`do_bench` is the port's one timer: ``telemetry/roofline.py::device_ms``
(and so the roofline, the measured timeline and the autotuner's ``measure``
mode) times through it. On the card each rep is timed by CUDA events on the
current stream, with a spin kernel holding the stream while the host
enqueues the rep's calls, so that a wrapper's host work does not time as
gaps between launches; on the CPU by the host clock. ``MemoryRecorder``
samples the caching allocator through ``telemetry/memory.py``'s sampler,
as JAX's shares its sampler with the memory layer; on the CPU it records
nothing.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Any, Callable, Sequence


def mesh_barrier(group=None) -> None:
    """Rendezvous every rank of a ``torch.distributed`` group (the JAX
    package's mesh) with the host waiting for its card first: the
    reference's ``maybe_dist_sync`` (``cuda.synchronize`` + ``barrier``).
    ``group=None`` is the default group."""
    import torch
    import torch.distributed as dist

    from ..utils.instrument import named_scope

    with named_scope("magi_bench_barrier"):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dist.barrier(group=group)


class MemoryRecorder:
    """Sample device memory while a region runs (the reference's NVML
    ``MemRecorder``): a background thread polls the caching allocator's
    bytes in use (``torch.cuda.memory_stats``, through
    ``telemetry.memory.sample_memory_stats``) of ``devices`` (default: every
    visible card) every ``interval_s``; ``peak_bytes`` holds the largest
    sample per device. On a machine without a card nothing is recorded and
    ``peak_bytes`` stays empty.

    The peaks are polled: an allocation shorter than ``interval_s`` can fall
    between two samples. The allocator's own high-water mark
    (``max_memory_allocated``) is not folded in: it spans the process since
    its last reset, not this region.

    Usage::

        with MemoryRecorder() as rec:
            run_step()
        print(rec.peak_bytes)     # {device: bytes}
    """

    def __init__(self, devices=None, interval_s: float = 0.01):
        self.devices = list(devices) if devices else None
        self.interval_s = interval_s
        self.peak_bytes: dict[Any, int] = {}
        self.samples: list[dict[Any, int]] = []
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None

    def _poll_once(self) -> dict[Any, int]:
        from ..telemetry.memory import sample_memory_stats

        return sample_memory_stats(self.devices)

    def record(self) -> None:
        """Take one sample now (for callers that sample at quiet points
        instead of running the thread). With telemetry on, the sample also
        lands on the ``magi_mem_hbm_bytes_in_use`` / ``_peak`` gauges."""
        sample = self._poll_once()
        if sample:
            self.samples.append(sample)
            for d, b in sample.items():
                if b > self.peak_bytes.get(d, 0):
                    self.peak_bytes[d] = b
            from ..telemetry import record_hbm_sample

            record_hbm_sample(sample)

    def __enter__(self):
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                self.record()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.record()  # one last sample at the region's end
        return False


@dataclasses.dataclass(frozen=True)
class BenchResult:
    mean_ms: float
    median_ms: float
    min_ms: float
    max_ms: float
    reps: int
    peak_bytes: int | None = None  # the largest over the devices
    peak_bytes_per_device: tuple[int, ...] = ()

    def tflops(self, flops: float) -> float:
        return flops / (self.median_ms * 1e-3) / 1e12


def chained_ms(step, carry, iters: int = 8, batches: int = 3) -> float:
    """Median ms per application of ``step`` applied ``iters`` times in a
    row to a carry (``step(carry) -> carry``, e.g. ``(q, k, v) -> (out, k,
    v)``), over ``batches`` batches after one to warm up. Each application
    depends on the last, as in the JAX package's one-dispatch
    ``fori_loop``; PyTorch launches eagerly, so the batch is the calls
    back to back, timed on CUDA events on a machine with a card (the host
    clock without one)."""
    import torch

    card = torch.cuda.is_available()

    def run():
        c = carry
        for _ in range(iters):
            c = step(c)
        return c

    run()
    if card:
        torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        if card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) / iters * 1e3)
    times.sort()
    return times[len(times) // 2]


def do_bench(
    fn: Callable,
    *args,
    warmup: int = 3,
    rep: int = 10,
    inner: int = 5,
    record_memory: bool = False,
    mesh=None,
    cuda: bool | None = None,
    **kwargs,
) -> BenchResult:
    """Time ``fn(*args, **kwargs)``: ``warmup`` calls (at least one), then
    ``rep`` timed reps of ``inner`` calls each, a rep's time being their
    mean (the JAX package's discipline).

    ``cuda`` (default: whether the machine has a card): time each rep by
    CUDA events on the current stream; else by the host clock. On the card
    without ``mesh``, a spin kernel holds the stream while the host enqueues
    the rep's calls, so that the events time the device's work and not the
    host's launch gaps. ``mesh``: a
    ``torch.distributed`` group whose ranks all call together; each rep
    starts after :func:`mesh_barrier` (no spin: what such a rep times waits
    on the other ranks). ``record_memory``: a :class:`MemoryRecorder`
    sample after each rep, outside its timed window."""
    import torch

    card = torch.cuda.is_available() if cuda is None else cuda
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    spin_s = None
    if card:
        torch.cuda.synchronize()
        if mesh is None:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            torch.cuda.synchronize()
            spin_s = 2 * (time.perf_counter() - t0) * inner + 2e-3
    rec = MemoryRecorder() if record_memory else None
    times = []
    for _ in range(rep):
        if mesh is not None:
            mesh_barrier(mesh)
        if card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if spin_s is not None:
                torch.cuda._sleep(int(2e9 * spin_s))  # cycles, at most ~2 GHz
            start.record()
            for _ in range(inner):
                fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args, **kwargs)
            times.append((time.perf_counter() - t0) / inner * 1e3)
        if rec is not None:
            rec.record()
    peaks = tuple(sorted(rec.peak_bytes.values())) if rec else ()
    return BenchResult(
        mean_ms=statistics.fmean(times),
        median_ms=statistics.median(times),
        min_ms=min(times),
        max_ms=max(times),
        reps=rep,
        peak_bytes=max(peaks) if peaks else None,
        peak_bytes_per_device=peaks,
    )


@dataclasses.dataclass(frozen=True)
class Benchmark:
    """A benchmark grid (the reference's ``Benchmark`` / ``Mark``): sweep
    ``x_vals`` along ``x_name``, one measured line per value of
    ``line_arg`` in ``line_vals``; the decorated function gets
    ``(x_name=..., line_arg=..., **args)`` per cell and returns a float (ms)
    or a dict of columns."""

    x_name: str
    x_vals: Sequence[Any]
    line_arg: str
    line_vals: Sequence[Any]
    line_names: Sequence[str] | None = None
    plot_name: str = "benchmark"
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    ylabel: str = "ms"


class Mark:
    """Runner of one :class:`Benchmark` grid, made by :func:`perf_grid`."""

    def __init__(self, fn: Callable, bench: Benchmark):
        self._fn = fn
        self.bench = bench

    def run(self, *, print_data: bool = True, save_path: str | None = None,
            show_plots: bool = False) -> list[dict[str, Any]]:
        b = self.bench
        names = list(b.line_names or [str(v) for v in b.line_vals])
        rows: list[dict[str, Any]] = []
        for x in b.x_vals:
            row: dict[str, Any] = {b.x_name: x}
            for lv, nm in zip(b.line_vals, names):
                res = self._fn(**{b.x_name: x, b.line_arg: lv}, **b.args)
                if isinstance(res, dict):
                    for key, val in res.items():
                        row[f"{nm}_{key}"] = val
                else:
                    row[nm] = res
            rows.append(row)
        if print_data:
            print(perf_report(rows))
        if save_path and rows:
            import csv
            import os

            os.makedirs(save_path, exist_ok=True)
            fields: list[str] = []  # the union over the rows (cells may differ)
            for r in rows:
                fields.extend(k for k in r if k not in fields)
            with open(os.path.join(save_path, f"{b.plot_name}.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields, restval="")
                w.writeheader()
                w.writerows(rows)
            self._plot(rows, names, save_path, show_plots)
        return rows

    def _plot(self, rows, names, save_path, show):
        import os

        from ..utils.vis import _figure

        fig = _figure((7, 4.5))
        if fig is None:
            return
        b = self.bench
        xs = [r[b.x_name] for r in rows]
        ax = fig.add_subplot()
        for nm in names:
            if nm in rows[0]:
                ax.plot(xs, [r[nm] for r in rows], marker="o", label=nm)
        ax.set_xlabel(b.x_name)
        ax.set_ylabel(b.ylabel)
        ax.set_title(b.plot_name)
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(os.path.join(save_path, f"{b.plot_name}.png"), dpi=120)
        if show:  # pragma: no cover
            import matplotlib.pyplot as plt

            plt.show()


def perf_grid(bench: Benchmark):
    """Decorator: ``@perf_grid(Benchmark(...))`` gives a :class:`Mark` whose
    ``.run(save_path=...)`` sweeps the grid, prints the table and writes
    CSV and PNG."""

    def wrap(fn: Callable) -> Mark:
        return Mark(fn, bench)

    return wrap


def perf_report(rows: Sequence[dict[str, Any]], *, sort_key: str | None = None) -> str:
    """Plain-text table of benchmark rows."""
    if not rows:
        return "(no results)"
    cols = list(rows[0].keys())
    if sort_key:
        rows = sorted(rows, key=lambda r: r[sort_key])
    widths = {c: max(len(str(c)), *(len(f"{r.get(c, '')}") for r in rows)) for c in cols}
    lines = ["  ".join(str(c).ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(f"{r.get(c, '')}".ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def enable_compile_cache(default_dir: str | None = None) -> str:
    """The port's counterpart of JAX's persistent compilation cache: the
    directory of the kernel builds (``csrc.BUILD_DIR``), whose libraries are
    named by a hash of their sources and flags, so that an unchanged kernel
    is built once. ``MAGI_TPU_COMPILE_CACHE`` (JAX's name), else
    ``default_dir``, moves it for this process (the ranks of a ``RankPool``
    keep theirs unless they call this too); with neither it stays
    ``csrc/build/``. Returns the directory."""
    import os

    from .. import csrc, env

    cache_dir = env.compile_cache_dir() or default_dir
    if cache_dir:
        csrc.BUILD_DIR = os.path.abspath(cache_dir)
    return csrc.BUILD_DIR


def image_grid(paths: Sequence[str], out_path: str, cols: int | None = None) -> str | None:
    """Tile saved benchmark plot PNGs into one image (the reference's
    ``image_grid.py``); ``cols=None`` picks a near-square layout. Returns
    ``out_path``, or None without matplotlib or without inputs: report
    tooling never takes a bench run down."""
    import math
    import os

    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        return None
    from ..utils.vis import _figure

    n = len(paths)
    cols = cols or max(1, int(math.ceil(math.sqrt(n))))
    nrows = -(-n // cols)
    fig = _figure((5.5 * cols, 4.0 * nrows))
    if fig is None:
        return None
    try:
        import matplotlib.image as mpimg

        for i in range(nrows * cols):
            ax = fig.add_subplot(nrows, cols, i + 1)
            ax.axis("off")
            if i < n:
                ax.imshow(mpimg.imread(paths[i]))
                ax.set_title(os.path.basename(paths[i]), fontsize=8)
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
    except Exception:  # a truncated PNG, an unwritable out_path: never fatal
        return None
    return out_path
