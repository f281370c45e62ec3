"""The port's native entry emitter (``csrc/entry_table.cpp``, built with g++
on first use) against the port's Python loops and the JAX package's native
library, byte for byte.

The random slice / run and rectangle generators are the JAX package's own
(``tests/test_ops/test_cpp_ext.py``), their outputs handed to the port as
plain numbers. Held: the emitted entries, the exact area over runs, the
area left of a cut and the dynamic solver's cut position (each against the
Python loop and against JAX's native), the dynamic solver's whole solution
with the native probe and with ``MAGI_ATTENTION_CPP_BACKEND=0`` (and against
JAX's), ``build_block_meta_general`` under both flag values, a stale library
rebuilt and loaded after its source changes, a build failure raising with
g++'s output, and the protocols both emitters satisfy."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from magiattention_tpu import csrc as jax_csrc
from magiattention_tpu.meta.solver.dynamic_attn_solver import DynamicAttnSolver as JaxKD
from magiattention_tpu_torch import csrc
from magiattention_tpu_torch.common import (
    AttnMaskType,
    AttnRange,
    AttnRanges,
    AttnRectangle,
    AttnRectangles,
)
from magiattention_tpu_torch.common.protocols import (
    EntryEmitter,
    RangeProtocol,
    RangesProtocol,
    RectangleProtocol,
    RectanglesProtocol,
    SliceAreaFn,
)
from magiattention_tpu_torch.meta.solver.dynamic_attn_solver import DynamicAttnSolver
from magiattention_tpu_torch.ops.block_meta import (
    Run,
    _emit_entries,
    _slice_area_runs,
    build_block_meta_general,
)

from tests.test_ops.test_cpp_ext import _random_case, _random_rects


def _case(seed):
    slices, q_runs, k_runs = _random_case(np.random.default_rng(seed))
    runs = [[Run(r.local_start, r.global_start, r.length) for r in rs] for rs in (q_runs, k_runs)]
    return slices, runs[0], runs[1]


def _arr(runs):
    return np.asarray([(r.local_start, r.global_start, r.length) for r in runs], np.int64)


def _rects(seed, **kw):
    """The JAX generator's rectangles as (port, JAX) collections."""
    jax_rects = _random_rects(np.random.default_rng(seed), **kw)
    port = AttnRectangles()
    for qs, qe, ks, ke, mt in jax_rects.to_array().tolist():
        port.append(AttnRectangle(AttnRange(qs, qe), AttnRange(ks, ke), AttnMaskType(mt)))
    return port, jax_rects


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("seed", range(8))
def test_emit_entries_byte_identical(seed, block):
    slices, q_runs, k_runs = _case(seed)
    py = _emit_entries(slices, q_runs, k_runs, block, block)
    py = np.asarray(py, np.int64) if py else np.empty((0, 9), np.int64)
    got = csrc.emit_entries_native(slices, q_runs, k_runs, block, block)
    jax = jax_csrc.emit_entries_native(slices, _arr(q_runs), _arr(k_runs), block, block)
    assert got.dtype == np.int64 and got.tobytes() == py.tobytes() == jax.tobytes()
    # runs as [n, 3] arrays: the same entries
    assert csrc.emit_entries_native(slices, _arr(q_runs), _arr(k_runs), block,
                                    block).tobytes() == py.tobytes()


def test_emit_entries_grows_past_its_first_capacity(monkeypatch):
    """A count past the first allocation is emitted again at its size."""
    slices, q_runs, k_runs = _case(3)
    want = csrc.emit_entries_native(slices, q_runs, k_runs, 32, 32)
    monkeypatch.setattr(csrc, "_EMIT_FIRST_CAP", 1)
    assert csrc.emit_entries_native(slices, q_runs, k_runs, 32, 32).tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", range(8))
def test_slice_area_byte_identical(seed):
    slices, q_runs, k_runs = _case(100 + seed)
    py = _slice_area_runs(slices, q_runs, k_runs)
    assert csrc.slice_area_runs_native(slices, q_runs, k_runs) == py
    assert jax_csrc.slice_area_runs_native(slices, _arr(q_runs), _arr(k_runs)) == py


@pytest.mark.parametrize("seed", range(8))
def test_area_left_byte_identical(seed):
    rects, jax_rects = _rects(300 + seed)
    arr = rects.to_array()
    for pos in [0, 7, 100, 255, 256, 400, 512, 600]:
        for axis_q, py in ((True, rects.area_left_of_q), (False, rects.area_left_of_k)):
            got = csrc.area_left_native(arr, axis_q, pos)
            assert got == py(pos) == jax_csrc.area_left_native(arr, axis_q, pos)


def _python_cut_pos(rects, frac, axis_q):
    """The dynamic solver's probe loop, as its Python path runs it."""
    left, _ = DynamicAttnSolver()._cut_for_fraction(rects, frac, axis_q)
    return left


@pytest.mark.parametrize("axis_q", [True, False])
@pytest.mark.parametrize("seed", range(8))
def test_cut_pos_byte_identical(seed, axis_q, monkeypatch):
    rects, _ = _rects(400 + seed)
    arr = rects.to_array()
    for frac in [0.5, 0.25, 1 / 3, 0.125, 2 / 3]:
        pos = csrc.cut_pos_native(arr, frac, axis_q)
        assert pos == jax_csrc.cut_pos_native(arr, frac, axis_q), frac
        native_left = _python_cut_pos(rects, frac, axis_q)
        monkeypatch.setenv("MAGI_ATTENTION_CPP_BACKEND", "0")
        py_left = _python_cut_pos(rects, frac, axis_q)
        monkeypatch.delenv("MAGI_ATTENTION_CPP_BACKEND")
        cut = rects.cut_q(pos) if axis_q else rects.cut_k(pos)
        assert native_left.to_array().tobytes() == py_left.to_array().tobytes()
        assert cut[0].to_array().tobytes() == py_left.to_array().tobytes()


@pytest.mark.parametrize("cp", [2, 4, 8])
def test_dynamic_solution_native_python_and_jax(cp, monkeypatch):
    rects, jax_rects = _rects(42, n=12, span=1024)
    native = DynamicAttnSolver().solve(rects, cp_size=cp)
    monkeypatch.setenv("MAGI_ATTENTION_CPP_BACKEND", "0")
    pure = DynamicAttnSolver().solve(rects, cp_size=cp)
    jax = JaxKD().solve(jax_rects, cp_size=cp)
    for a, b, c in zip(native.rank_rects, pure.rank_rects, jax.rank_rects):
        assert a.to_array().tobytes() == b.to_array().tobytes() == c.to_array().tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_block_meta_same_under_both_flag_values(seed, monkeypatch):
    slices, q_runs, k_runs = _case(200 + seed)
    tq, tk = sum(r.length for r in q_runs), sum(r.length for r in k_runs)
    native = build_block_meta_general(slices, q_runs, k_runs, tq, tk, block_q=64, block_k=64)
    monkeypatch.setenv("MAGI_ATTENTION_CPP_BACKEND", "off")

    def refuse():
        raise AssertionError("the flag is off: the native library must not be loaded")

    monkeypatch.setattr(csrc, "load_host", refuse)
    py = build_block_meta_general(slices, q_runs, k_runs, tq, tk, block_q=64, block_k=64)
    for f in dataclasses.fields(native):
        a, b = getattr(native, f.name), getattr(py, f.name)
        assert (a.tobytes() == b.tobytes()) if isinstance(a, np.ndarray) else a == b, f.name


@pytest.fixture
def scratch_source(tmp_path, monkeypatch):
    """The host library built from a copy of its source in ``tmp_path``."""
    src = tmp_path / "entry_table.cpp"
    shutil.copy(csrc.HOST_SOURCE, src)
    monkeypatch.setattr(csrc, "HOST_SOURCE", str(src))
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path / "build"))
    return src


def test_stale_library_is_rebuilt(scratch_source):
    rects, _ = _rects(7)
    arr = rects.to_array()
    first = csrc.host_library_path()
    assert csrc.area_left_native(arr, True, 300) == rects.area_left_of_q(300)
    assert os.path.exists(first)
    # an edited source names another library, which is built and loaded
    text = scratch_source.read_text()
    scratch_source.write_text(text.replace("return area_left(rects, n, axis_q, pos);",
                                           "return area_left(rects, n, axis_q, pos) + 1;"))
    assert csrc.host_library_path() != first
    assert csrc.area_left_native(arr, True, 300) == rects.area_left_of_q(300) + 1
    scratch_source.write_text(text)  # and back: the first library is reused as it is
    assert csrc.host_library_path() == first
    assert csrc.area_left_native(arr, True, 300) == rects.area_left_of_q(300)


def test_build_failure_raises_with_the_compilers_output(scratch_source):
    scratch_source.write_text(scratch_source.read_text() + "\nthis is not C++;\n")
    with pytest.raises(csrc.HostBuildError, match="g\\+\\+ failed(.|\n)*error"):
        csrc.build_host()
    with pytest.raises(csrc.HostBuildError):  # and the planner does not fall back to Python
        build_block_meta_general(np.asarray([[0, 64, 0, 64, 1]]), [Run(0, 0, 64)],
                                 [Run(0, 0, 64)], 64, 64, block_q=64, block_k=64)


def test_missing_compiler_raises(scratch_source, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(csrc.HostBuildError, match="g\\+\\+ not found"):
        csrc.build_host()


@pytest.mark.parametrize("value,on", [(None, True), ("1", True), ("yes", True), ("0", False),
                                      ("false", False), ("OFF", False), ("no", False)])
def test_cpp_backend_flag_parses_as_jax(value, on, monkeypatch):
    from magiattention_tpu import env as jax_env
    from magiattention_tpu_torch import env

    if value is None:
        monkeypatch.delenv("MAGI_ATTENTION_CPP_BACKEND", raising=False)
    else:
        monkeypatch.setenv("MAGI_ATTENTION_CPP_BACKEND", value)
    assert env.is_cpp_backend_enabled() is on is jax_env.is_cpp_backend_enabled()


def test_protocols_are_satisfied():
    assert isinstance(_emit_entries, EntryEmitter)
    assert isinstance(csrc.emit_entries_native, EntryEmitter)
    assert isinstance(_slice_area_runs, SliceAreaFn)
    assert isinstance(csrc.slice_area_runs_native, SliceAreaFn)
    assert isinstance(AttnRange(0, 4), RangeProtocol)
    assert isinstance(AttnRanges.from_ranges([(0, 4)]), RangesProtocol)
    rect = AttnRectangle(AttnRange(0, 4), AttnRange(0, 4))
    assert isinstance(rect, RectangleProtocol)
    rects = AttnRectangles()
    rects.append(rect)
    assert isinstance(rects, RectanglesProtocol)


def test_symbols_carry_the_ports_prefix():
    """Both packages' libraries in one process: the port's entry points are
    its own names, the JAX library's are untouched."""
    lib = csrc.load_host()
    for name in csrc.HOST_ENTRY_POINTS:
        assert name.startswith("magi_torch_") and hasattr(lib, name)
    assert not hasattr(lib, "magi_emit_entries")
    assert hasattr(jax_csrc.get_lib(), "magi_emit_entries")
