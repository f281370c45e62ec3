"""The port's hand-written Hopper kernels: built with nvcc, loaded with ctypes.

Each ``.cu`` file in this directory is one kernel with a plain C entry point
(every pointer and the CUDA stream passed as ``void*``, every size as
``int``; the return value is the ``cudaError_t`` of the launch). The
headers they share: all eight flex-attention kernels ``flex_tile.cuh`` (the
tile, the per-entry mask, the per-logit core, AMLA's rescale) and the
Hopper primitives, block shape and item hand-over of ``flex_sm90.cuh`` —
the four forwards (the row-major ``flex_fwd``, ``flex_fwd_hb`` and the
persistent sparse-grid ``flex_fwd_sparse``, ``flex_fwd_sparse_hb``) the
TMA + wgmma walk of ``flex_fwd_sm90.cuh``, the four backward kernels (the
row-major ``flex_dq``, ``flex_dkv`` and the persistent sparse-grid
``flex_dq_sparse``, ``flex_dkv_sparse``) the per-item walks of
``flex_bwd_sm90.cuh``, all eight at head_dim 32, 64, 80, 96, 128 and 256 in
bf16 (80 and 96 in d 128's shared tiles, zeros past d, the products at the
true d). All eight take float32 q/k/v too (their ``in_f32`` argument), on
the CUDA-core walks of ``flex_simt.cuh``, at head_dim 32, 64, 80, 96 and
128.
``paged_decode`` (``decode.cu``) takes the tensor-core walk of
``decode_sm90.cuh`` for bf16 caches (head_dims 80, 96 and 256 too), in the flat mode
past 32 q heads a kv head the TMA and wgmma walk of ``decode_wide_sm90.cuh``
(which shares ``flex_sm90.cuh``'s primitives), and the CUDA-core walk of
``decode_simt.cuh`` for float32 ones. ``flex_fwd.cuh``,
``flex_fwd_sparse.cuh``, ``flex_bwd.cuh`` and ``decode_wide_mma.cuh``, the
previous forward, backward and wide decode walks, are no kernel's: they
are the sources of ``chip_smoke.py``'s yardsticks (``decode_simt.cuh`` at
bf16, the previous decode walk, is another).
On first use :func:`build`
compiles the sources for ``sm_90a``, all at once (one nvcc process per
source), into ``build/`` beside this file; the library name carries a hash
of its source and of the headers it includes, so an edited kernel is
rebuilt and an unchanged one is reused. Nothing here runs at import: the
CPU tests import every module of the package, and a machine without a card
may have no nvcc.

``entry_table.cpp`` is no kernel: it is the host planner's native library,
the port's copy of the JAX package's ``csrc/entry_table.cpp`` (its C entry
points carry the ``magi_torch_`` prefix, so both libraries load into one
process): the entry emitter of ``ops/block_meta.build_block_meta_general``,
its exact-area loop, and the dynamic solver's area-left and cut search
(``meta/solver/dynamic_attn_solver.py``). It runs on the host, so unlike the
kernels it builds wherever g++ is, the CPU tests' machine included:
:func:`build_host` runs ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/``, the library name carrying a hash of the source and the flags,
under the lock the kernels' build takes; :func:`load_host` loads it with
ctypes, its argtypes declared. Under ``MAGI_ATTENTION_CPP_BACKEND``
(default on) the planner calls it, and a build or load failure raises
:class:`HostBuildError` with g++'s output; unlike the JAX package's loader,
nothing falls back to Python quietly. With the flag off the planner runs its
Python loops, which give the same bytes (``tests/test_torch_entry_table.py``).

``launches`` counts the launches of each kernel. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (``chip_smoke.py`` zeroes the counts before each
main path and reads them after it).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")


class Kernel(NamedTuple):
    source: str  # the .cu file
    entry: str  # its C entry point
    argtypes: list
    headers: tuple[str, ...] = ()  # the headers of this directory it includes


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (every flex kernel also takes float32 q/k/v on the CUDA-core walks of
# flex_simt.cuh)
_FWD_HEADERS = ("flex_tile.cuh", "flex_sm90.cuh", "flex_fwd_sm90.cuh", "flex_simt.cuh")
_BWD_HEADERS = ("flex_tile.cuh", "flex_sm90.cuh", "flex_bwd_sm90.cuh", "flex_simt.cuh")
# the sparse-grid forwards: q k v sink | kblk sid runs bounds rs rc | work
# counter | out lse rowmax; hq hk tqp tkp head_dim nq block_q block_k n_items
# heads_per_item; scale softcap has_sink out_f32 in_f32 stream
_FWD_SPARSE_ARGS = [_P] * 4 + [_P] * 6 + [_P] * 2 + [_P] * 3 + [_I] * 10 + [_F, _F, _I, _I, _I, _P]
KERNELS: dict[str, Kernel] = {
    "flex_fwd": Kernel(
        "flex_fwd.cu",
        "magi_flex_fwd",
        # q k v sink | kblk sid runs bounds rs rc | order | out lse rowmax
        [_P] * 4 + [_P] * 6 + [_P] + [_P] * 3
        # hq hk tqp tkp head_dim nq block_q block_k
        + [_I] * 8
        # scale softcap has_sink out_f32 in_f32 stream
        + [_F, _F, _I, _I, _I, _P],
        _FWD_HEADERS,
    ),
    "flex_fwd_hb": Kernel(
        "flex_fwd_hb.cu",
        "magi_flex_fwd_hb",
        # q k v sink | kblk sid runs bounds rs rc | order | out lse rowmax
        [_P] * 4 + [_P] * 6 + [_P] + [_P] * 3
        # hq hk tqp tkp head_dim nq block_q block_k head_block
        + [_I] * 9
        # scale softcap has_sink out_f32 in_f32 stream
        + [_F, _F, _I, _I, _I, _P],
        _FWD_HEADERS,
    ),
    "flex_dq": Kernel(
        "flex_dq.cu",
        "magi_flex_dq",
        # q k v dout lse delta | kblk sid runs bounds rs rc | order | dq
        [_P] * 6 + [_P] * 6 + [_P] + [_P]
        # hq hk tqp tkp head_dim nq block_q block_k
        + [_I] * 8
        # scale softcap in_f32 stream
        + [_F, _F, _I, _P],
        _BWD_HEADERS,
    ),
    "flex_dkv": Kernel(
        "flex_dkv.cu",
        "magi_flex_dkv",
        # q k v dout lse delta | qblk sid runs bounds rs rc | order | dk dv
        [_P] * 6 + [_P] * 6 + [_P] + [_P] * 2
        # hq hk tqp tkp head_dim nk block_q block_k
        + [_I] * 8
        # scale softcap in_f32 stream
        + [_F, _F, _I, _P],
        _BWD_HEADERS,
    ),
    "flex_fwd_sparse": Kernel(
        "flex_fwd_sparse.cu", "magi_flex_fwd_sparse", _FWD_SPARSE_ARGS, _FWD_HEADERS,
    ),
    "flex_fwd_sparse_hb": Kernel(
        "flex_fwd_sparse_hb.cu", "magi_flex_fwd_sparse_hb", _FWD_SPARSE_ARGS, _FWD_HEADERS,
    ),
    "flex_dq_sparse": Kernel(
        "flex_dq_sparse.cu",
        "magi_flex_dq_sparse",
        # q k v dout lse delta | kblk sid runs bounds rs rc | work counter | dq
        [_P] * 6 + [_P] * 6 + [_P] * 2 + [_P]
        # hq hk tqp tkp head_dim nq block_q block_k n_items
        + [_I] * 9
        # scale softcap in_f32 stream
        + [_F, _F, _I, _P],
        _BWD_HEADERS,
    ),
    "flex_dkv_sparse": Kernel(
        "flex_dkv_sparse.cu",
        "magi_flex_dkv_sparse",
        # q k v dout lse delta | qblk sid runs bounds rs rc | work counter | dk dv
        [_P] * 6 + [_P] * 6 + [_P] * 2 + [_P] * 2
        # hq hk tqp tkp head_dim nk block_q block_k n_items
        + [_I] * 9
        # scale softcap in_f32 stream
        + [_F, _F, _I, _P],
        _BWD_HEADERS,
    ),
    "paged_decode": Kernel(
        "decode.cu",
        "magi_paged_decode",
        # q k_pages v_pages block_table seq_lens | out_parts lse_parts
        [_P] * 5 + [_P] * 2
        # b hq hk head_dim page_size mpp num_splits shared is_f32 cluster_heads
        # num_pages seg_chunks blocks
        + [_I] * 13
        # scale softcap | scratch counters | stream
        + [_F, _F, _P, _P, _P],
        ("decode_simt.cuh", "decode_sm90.cuh", "decode_wide_sm90.cuh", "flex_sm90.cuh",
         "flex_tile.cuh"),
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

launches: dict[str, int] = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its output."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (refused or failed)."""


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from .. import env

    path = shutil.which("nvcc")
    toolkit = os.path.join(env.cuda_home(), "bin", "nvcc")
    if path is None and os.path.exists(toolkit):
        path = toolkit
    if path is None:
        raise KernelBuildError(
            f"nvcc not found on PATH or at {toolkit}: the port's CUDA kernels "
            "are built from source on the machine with the card"
        )
    return path


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    kernel = KERNELS[name]
    for src in (kernel.source, *kernel.headers):
        with open(os.path.join(_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=None, *, ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile the named kernels (default: all) that have no up-to-date
    library yet, one nvcc process per source, all started together.

    Returns ``{name: {"path", "seconds", "log"}}`` (``seconds`` 0.0 and an
    empty log for a library that was already built). Raises
    :class:`KernelBuildError` with nvcc's output if any source fails.

    Processes that build at once (the ranks of a context-parallel run
    reaching their first launch together) take turns on a file lock in
    ``BUILD_DIR``: the first compiles, the others find its libraries.
    """
    names = list(KERNELS) if names is None else list(names)
    with build_lock():
        return _build_locked(names, ptxas_verbose)


@contextlib.contextmanager
def build_lock():
    """Hold the file lock of ``BUILD_DIR`` (made if missing) that every
    build of this directory's sources takes, the kernels' and the host
    library's (``host.py``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        yield


def _build_locked(names, ptxas_verbose: bool) -> dict[str, dict]:
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
    result: dict[str, dict] = {}
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            result[name] = {"path": out, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(_DIR, KERNELS[name].source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, proc, tmp, out, time.perf_counter(), cmd))
    failures = []
    for name, proc, tmp, out, t0, cmd in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        result[name] = {"path": out, "seconds": seconds, "log": log}
        _note_build(seconds)
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n\n".join(failures))
    return result


def _note_build(seconds: float) -> None:
    """One library built: a compile event for the compile tracker, under
    the program label live on this thread (a library already built and
    only loaded is none)."""
    from ..telemetry.compile import get_compile_tracker

    get_compile_tracker().note_compile(seconds)


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library (built first if needed), with the C
    entry point's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
            fn = getattr(lib, KERNELS[name].entry)
            fn.argtypes = KERNELS[name].argtypes
            fn.restype = ctypes.c_int
            lib.magi_error_string.argtypes = [ctypes.c_int]
            lib.magi_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise :class:`KernelLaunchError`
    on a non-zero CUDA error, else count the launch."""
    lib = load(name)
    code = getattr(lib, KERNELS[name].entry)(*args)
    if code != 0:
        msg = lib.magi_error_string(code).decode()
        raise KernelLaunchError(f"{name}: CUDA error {code} ({msg})")
    launches[name] += 1


# -- the host planner's native library (entry_table.cpp, g++) -------------------

HOST_SOURCE = os.path.join(_DIR, "entry_table.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
# the C entry points and their argtypes (all return int64)
HOST_ENTRY_POINTS: dict[str, list] = {
    # slices n | q_runs n | k_runs n | block_q block_k | out capacity
    "magi_torch_emit_entries": [_I64P, _I64] * 3 + [_I64, _I64, _I64P, _I64],
    # slices n | q_runs n | k_runs n
    "magi_torch_slice_area_runs": [_I64P, _I64] * 3,
    # rects n | axis_q pos
    "magi_torch_area_left": [_I64P, _I64, _I64, _I64],
    # rects n | axis_q frac
    "magi_torch_cut_pos": [_I64P, _I64, _I64, ctypes.c_double],
}

_host_libs: dict[str, ctypes.CDLL] = {}
# the first entry buffer holds at most 16 M rows (1.2 GB); a larger count is emitted again
_EMIT_FIRST_CAP = 1 << 24


class HostBuildError(RuntimeError):
    """g++ is missing or refused the source, or the library does not load;
    the message carries the compiler's (or the loader's) output."""


def host_library_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(HOST_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libentry_table-{digest.hexdigest()[:12]}.so")


def build_host() -> str:
    """Compile the library unless an up-to-date one exists; returns its
    path. Raises :class:`HostBuildError` with g++'s output."""
    out = host_library_path()
    with build_lock():
        if os.path.exists(out):
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise HostBuildError("g++ not found on PATH: the host planner's native library "
                                 "(csrc/entry_table.cpp) is built from source; set "
                                 "MAGI_ATTENTION_CPP_BACKEND=0 to plan with the Python loops")
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [gxx, *GXX_FLAGS, HOST_SOURCE, "-o", tmp]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise HostBuildError(f"g++ failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        _note_build(time.perf_counter() - t0)
    return out


def load_host() -> ctypes.CDLL:
    """The loaded library (built first if needed), argtypes declared."""
    path = host_library_path()
    with _lock:
        lib = _host_libs.get(path)
        if lib is None:
            build_host()
            try:
                lib = ctypes.CDLL(path)
                for name, argtypes in HOST_ENTRY_POINTS.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, _I64
            except (OSError, AttributeError) as exc:
                raise HostBuildError(f"{path} does not load: {exc}") from exc
            _host_libs[path] = lib
        return lib


def host_enabled() -> bool:
    """Whether the planner takes the native library
    (``MAGI_ATTENTION_CPP_BACKEND``)."""
    from .. import env

    return env.is_cpp_backend_enabled()


def _i64(arr, cols: int):
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int64).reshape(-1, cols))
    return a, a.ctypes.data_as(_I64P)


def _runs_array(runs) -> np.ndarray:
    """[n, 3] int64 (local_start, global_start, length) of a sequence of
    ``ops.block_meta.Run`` or of such an array."""
    if isinstance(runs, np.ndarray):
        return runs.reshape(-1, 3).astype(np.int64)
    return np.asarray([(r.local_start, r.global_start, r.length) for r in runs],
                      dtype=np.int64).reshape(-1, 3)


def emit_entries_native(slices, q_runs, k_runs, block_q: int, block_k: int) -> np.ndarray:
    """[E, 9] int64 entries, in the order of ``ops.block_meta._emit_entries``
    (an ``EntryEmitter``: runs as ``Run`` sequences or [n, 3] arrays)."""
    lib = load_host()
    s, sp = _i64(slices, 5)
    q, qp = _i64(_runs_array(q_runs), 3)
    k, kp = _i64(_runs_array(k_runs), 3)
    # capacity from the block grid: per slice at most every (q-block,
    # k-block) pair its runs touch; a count past it is retried at that size
    nq_blocks = sum(int(-(-(r[0] + r[2]) // block_q) - r[0] // block_q) for r in q)
    nk_blocks = sum(int(-(-(r[0] + r[2]) // block_k) - r[0] // block_k) for r in k)
    cap = min(max(64, s.shape[0] * max(nq_blocks, 1) * max(nk_blocks, 1)), _EMIT_FIRST_CAP)
    while True:
        out = np.empty((cap, 9), dtype=np.int64)
        n = lib.magi_torch_emit_entries(sp, s.shape[0], qp, q.shape[0], kp, k.shape[0],
                                        int(block_q), int(block_k), out.ctypes.data_as(_I64P), cap)
        if n <= cap:
            return out[:n]
        cap = int(n)


def slice_area_runs_native(slices, q_runs, k_runs) -> int:
    """Exact unmasked pairs of the slices restricted to (q_runs x k_runs)
    (a ``SliceAreaFn``)."""
    lib = load_host()
    s, sp = _i64(slices, 5)
    q, qp = _i64(_runs_array(q_runs), 3)
    k, kp = _i64(_runs_array(k_runs), 3)
    return int(lib.magi_torch_slice_area_runs(sp, s.shape[0], qp, q.shape[0], kp, k.shape[0]))


def area_left_native(rects, axis_q: bool, pos: int) -> int:
    """Area of [n, 5] rects left of the q=pos (``axis_q``) or k=pos line."""
    r, rp = _i64(rects, 5)
    return int(load_host().magi_torch_area_left(rp, r.shape[0], int(axis_q), int(pos)))


def cut_pos_native(rects, frac: float, axis_q: bool) -> int:
    """The dynamic solver's cut position for ``frac`` of the area, bit for
    bit its Python probe loop."""
    r, rp = _i64(rects, 5)
    return int(load_host().magi_torch_cut_pos(rp, r.shape[0], int(axis_q), float(frac)))
