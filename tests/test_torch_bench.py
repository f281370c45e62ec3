"""``benchmarking/bench.py`` of the port: ``do_bench`` (the port's one
timer: ``telemetry.roofline.device_ms`` times through it), the memory
recorder on the CPU, the grid runner and its CSV / PNG artifacts, the
barrier over a ``torch.distributed`` group, the plot grid and the build
directory standing for the compile cache; the grid rows and the text table
against the JAX package's on the same cells."""

import os
import sys

import pytest
import torch

from magiattention_tpu import benchmarking as jax_bench
from magiattention_tpu_torch import benchmarking as bench
from magiattention_tpu_torch import csrc


def test_do_bench_times_and_memory():
    x = torch.ones((256, 256))
    calls = []

    def f(a):
        calls.append(1)
        return (a * a).sum()

    r = bench.do_bench(f, x, warmup=2, rep=3, inner=2, record_memory=True)
    assert r.min_ms <= r.median_ms <= r.max_ms and r.reps == 3
    assert r.tflops(1e9) > 0
    assert len(calls) == 2 + 3 * 2  # warm-up, then rep x inner on the host clock
    assert r.peak_bytes is None and r.peak_bytes_per_device == ()  # no card: nothing recorded


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_do_bench_warms_up_at_least_once(warmup):
    calls = []
    bench.do_bench(lambda: calls.append(1), warmup=warmup, rep=1, inner=1)
    assert len(calls) == max(warmup, 1) + 1


def test_device_ms_is_do_bench(monkeypatch):
    """The roofline's timer is ``do_bench``: one timer, not two."""
    from magiattention_tpu_torch.telemetry import roofline

    seen = []
    real = bench.bench.do_bench

    def spy(fn, *args, **kw):
        seen.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(bench.bench, "do_bench", spy)
    ms = roofline.device_ms(lambda: None, reps=3, warmup=1, inner=2, cuda=False)
    assert ms >= 0.0
    assert seen == [dict(warmup=1, rep=3, inner=2, mesh=None, cuda=False)]


def test_chained_ms_applies_step_in_a_row():
    seen = []

    def step(c):
        seen.append(c)
        return c + 1

    ms = bench.chained_ms(step, 0, iters=4, batches=2)
    assert ms >= 0.0
    assert seen == [0, 1, 2, 3] * 3  # the warm-up batch, then two timed ones


def _grid(pkg, calls):
    @pkg.perf_grid(pkg.Benchmark(x_name="seqlen", x_vals=[128, 256], line_arg="impl",
                                 line_vals=["a", "b"], plot_name="toy", args={"fixed": 7}))
    def bench_fn(seqlen, impl, fixed):
        calls.append((seqlen, impl, fixed))
        return float(seqlen) * (1.0 if impl == "a" else 2.0)

    return bench_fn


def test_perf_grid_runs_and_writes_artifacts(tmp_path):
    calls, jax_calls = [], []
    rows = _grid(bench, calls).run(print_data=False, save_path=str(tmp_path))
    assert calls == [(128, "a", 7), (128, "b", 7), (256, "a", 7), (256, "b", 7)]
    assert rows[0] == {"seqlen": 128, "a": 128.0, "b": 256.0}
    assert os.path.exists(tmp_path / "toy.csv") and os.path.exists(tmp_path / "toy.png")
    jax_rows = _grid(jax_bench, jax_calls).run(print_data=False)
    assert rows == jax_rows and calls == jax_calls
    assert bench.perf_report(rows) == jax_bench.perf_report(jax_rows)
    assert bench.perf_report(rows, sort_key="b") == jax_bench.perf_report(jax_rows, sort_key="b")
    assert bench.perf_report([]) == jax_bench.perf_report([]) == "(no results)"


def test_perf_grid_dict_results():
    @bench.perf_grid(bench.Benchmark(x_name="n", x_vals=[1], line_arg="impl", line_vals=["x"]))
    def bench_fn(n, impl):
        return {"ms": 1.5, "tflops": 2.0}

    assert bench_fn.run(print_data=False) == [{"n": 1, "x_ms": 1.5, "x_tflops": 2.0}]


def test_plots_are_a_no_op_without_matplotlib(tmp_path, monkeypatch):
    """The machine with the card has no matplotlib: the CSV is written, the
    plot and the grid are skipped with a warning."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = _grid(bench, []).run(print_data=False, save_path=str(tmp_path))
    assert rows and os.path.exists(tmp_path / "toy.csv")
    assert not os.path.exists(tmp_path / "toy.png")
    (tmp_path / "x.png").write_bytes(b"")
    assert bench.image_grid([str(tmp_path / "x.png")], str(tmp_path / "grid.png")) is None


def test_mesh_barrier_and_synced_bench(tmp_path):
    """The barrier over a one-rank gloo group, and ``do_bench(mesh=...)``
    timing through it."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", rank=0,
                                world_size=1)
    try:
        group = dist.new_group([0])
        bench.mesh_barrier(group)
        res = bench.do_bench(lambda: torch.ones(16, 8) * 2.0, warmup=1, rep=2, inner=2,
                             mesh=group)
        assert res.median_ms > 0 and res.reps == 2
    finally:
        if made:
            dist.destroy_process_group()


def test_memory_recorder_graceful_on_cpu():
    """On the CPU the recorder stays usable and records nothing, as the JAX
    package's does on a backend without memory stats."""
    with bench.MemoryRecorder(interval_s=0.001) as rec:
        _ = torch.ones((256, 256)) @ torch.ones((256, 256))
    assert rec.peak_bytes == {} and rec.samples == []
    with jax_bench.MemoryRecorder(interval_s=0.001) as jax_rec:
        pass
    assert isinstance(jax_rec.peak_bytes, dict)
    res = bench.do_bench(lambda: torch.ones((64, 64)) @ torch.ones((64, 64)), warmup=1, rep=2,
                         inner=1, record_memory=True)
    assert res.peak_bytes is None and res.peak_bytes_per_device == ()


def test_image_grid(tmp_path):
    """The plot PNGs tiled into one image; missing inputs skipped, none at
    all gives None."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    paths = []
    for i in range(3):
        fig = Figure(figsize=(2, 1.5))
        FigureCanvasAgg(fig)
        fig.add_subplot().plot([0, 1], [i, 1])
        p = str(tmp_path / f"plot{i}.png")
        fig.savefig(p)
        paths.append(p)
    out = bench.image_grid(paths + [str(tmp_path / "missing.png")], str(tmp_path / "grid.png"))
    assert out is not None and (tmp_path / "grid.png").exists()
    assert bench.image_grid([], str(tmp_path / "empty.png")) is None


@pytest.mark.parametrize("source", ["env", "argument", "default"])
def test_enable_compile_cache_moves_the_build_directory(source, monkeypatch, tmp_path):
    """The compile cache's counterpart: the kernels' build directory, moved
    by ``MAGI_TPU_COMPILE_CACHE`` over the argument, else left as it is."""
    monkeypatch.setattr(csrc, "BUILD_DIR", csrc.BUILD_DIR)
    before = csrc.BUILD_DIR
    monkeypatch.delenv("MAGI_TPU_COMPILE_CACHE", raising=False)
    if source == "env":
        monkeypatch.setenv("MAGI_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    got = bench.enable_compile_cache(None if source == "default" else str(tmp_path / "arg"))
    want = {"env": str(tmp_path / "env"), "argument": str(tmp_path / "arg"),
            "default": before}[source]
    assert got == csrc.BUILD_DIR == want
