"""The benchmark harness of the port (the JAX package's ``benchmarking/``)."""

from .bench import (
    Benchmark,
    BenchResult,
    Mark,
    MemoryRecorder,
    chained_ms,
    do_bench,
    enable_compile_cache,
    image_grid,
    mesh_barrier,
    perf_grid,
    perf_report,
)

__all__ = [
    "Benchmark",
    "BenchResult",
    "Mark",
    "MemoryRecorder",
    "chained_ms",
    "do_bench",
    "enable_compile_cache",
    "image_grid",
    "mesh_barrier",
    "perf_grid",
    "perf_report",
]
