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
``flex_bwd_sm90.cuh``. ``paged_decode`` (``decode.cu``) takes the
tensor-core walk of ``decode_sm90.cuh`` for bf16 caches and the CUDA-core
walk of ``decode_simt.cuh`` for float32 ones. ``flex_fwd.cuh``,
``flex_fwd_sparse.cuh`` and ``flex_bwd.cuh``, the previous forward and
backward walks, are no kernel's: they are the sources of ``chip_smoke.py``'s
yardsticks (``decode_simt.cuh`` at bf16, the previous decode walk, is
another).
On first use :func:`build`
compiles the sources for ``sm_90a``, all at once (one nvcc process per
source), into ``build/`` beside this file; the library name carries a hash
of its source and of the headers it includes, so an edited kernel is
rebuilt and an unchanged one is reused. Nothing here runs at import: the
CPU tests import every module of the package, and a machine without a card
may have no nvcc.

``launches`` counts the launches of each kernel. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (``chip_smoke.py`` zeroes the counts before each
main path and reads them after it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")


class Kernel(NamedTuple):
    source: str  # the .cu file
    entry: str  # its C entry point
    argtypes: list
    headers: tuple[str, ...] = ()  # the headers of this directory it includes


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_HEADERS = ("flex_tile.cuh", "flex_sm90.cuh", "flex_fwd_sm90.cuh")
_BWD_HEADERS = ("flex_tile.cuh", "flex_sm90.cuh", "flex_bwd_sm90.cuh")
# the sparse-grid forwards: q k v sink | kblk sid runs bounds rs rc | work
# counter | out lse rowmax; hq hk tqp tkp head_dim nq block_q block_k n_items
# heads_per_item; scale softcap has_sink out_f32 stream
_FWD_SPARSE_ARGS = [_P] * 4 + [_P] * 6 + [_P] * 2 + [_P] * 3 + [_I] * 10 + [_F, _F, _I, _I, _P]
KERNELS: dict[str, Kernel] = {
    "flex_fwd": Kernel(
        "flex_fwd.cu",
        "magi_flex_fwd",
        # q k v sink | kblk sid runs bounds rs rc | order | out lse rowmax
        [_P] * 4 + [_P] * 6 + [_P] + [_P] * 3
        # hq hk tqp tkp head_dim nq block_q block_k
        + [_I] * 8
        # scale softcap has_sink out_f32 stream
        + [_F, _F, _I, _I, _P],
        _FWD_HEADERS,
    ),
    "flex_fwd_hb": Kernel(
        "flex_fwd_hb.cu",
        "magi_flex_fwd_hb",
        # q k v sink | kblk sid runs bounds rs rc | order | out lse rowmax
        [_P] * 4 + [_P] * 6 + [_P] + [_P] * 3
        # hq hk tqp tkp head_dim nq block_q block_k head_block
        + [_I] * 9
        # scale softcap has_sink out_f32 stream
        + [_F, _F, _I, _I, _P],
        _FWD_HEADERS,
    ),
    "flex_dq": Kernel(
        "flex_dq.cu",
        "magi_flex_dq",
        # q k v dout lse delta | kblk sid runs bounds rs rc | order | dq
        [_P] * 6 + [_P] * 6 + [_P] + [_P]
        # hq hk tqp tkp head_dim nq block_q block_k
        + [_I] * 8
        # scale softcap stream
        + [_F, _F, _P],
        _BWD_HEADERS,
    ),
    "flex_dkv": Kernel(
        "flex_dkv.cu",
        "magi_flex_dkv",
        # q k v dout lse delta | qblk sid runs bounds rs rc | order | dk dv
        [_P] * 6 + [_P] * 6 + [_P] + [_P] * 2
        # hq hk tqp tkp head_dim nk block_q block_k
        + [_I] * 8
        # scale softcap stream
        + [_F, _F, _P],
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
        # scale softcap stream
        + [_F, _F, _P],
        _BWD_HEADERS,
    ),
    "flex_dkv_sparse": Kernel(
        "flex_dkv_sparse.cu",
        "magi_flex_dkv_sparse",
        # q k v dout lse delta | qblk sid runs bounds rs rc | work counter | dk dv
        [_P] * 6 + [_P] * 6 + [_P] * 2 + [_P] * 2
        # hq hk tqp tkp head_dim nk block_q block_k n_items
        + [_I] * 9
        # scale softcap stream
        + [_F, _F, _P],
        _BWD_HEADERS,
    ),
    "paged_decode": Kernel(
        "decode.cu",
        "magi_paged_decode",
        # q k_pages v_pages block_table seq_lens | out_parts lse_parts
        [_P] * 5 + [_P] * 2
        # b hq hk head_dim page_size mpp num_splits shared is_f32
        + [_I] * 9
        # scale softcap stream
        + [_F, _F, _P],
        ("decode_simt.cuh", "decode_sm90.cuh"),
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
    path = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
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
    """
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
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
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n\n".join(failures))
    return result


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
