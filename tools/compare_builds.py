#!/usr/bin/env python3
"""Hold this checkout's flex kernels against another checkout's, on one card.

    python3 tools/compare_builds.py --other DIR [--seed N]

DIR is the root of another checkout of the repository (an unpacked ``git
archive`` of the parent commit, say, in a git-ignored directory). Both
checkouts' ``flex_fwd``, ``flex_fwd_hb``, ``flex_dq``, ``flex_dkv``,
``flex_dq_sparse`` and ``flex_dkv_sparse`` are built with nvcc for sm_90a
(the other's into its own ``csrc/build/``) and called through this
checkout's wrappers, whose C signatures they must share. Prints one JSON
line per case: whether the two builds give the same bits, and, for the
forwards on the serving prefill (causal 4096, 32 q / 8 kv heads, d 128),
their CUDA-event times in turns (other, this, this, other). The card's name
and power limit come first, as ``nvidia-smi`` prints them."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv", "flex_dq_sparse", "flex_dkv_sparse")


def build_other(root: str) -> dict:
    """The other checkout's kernels, built in parallel and loaded with this
    checkout's argtypes."""
    from magiattention_tpu_torch import csrc

    src = os.path.join(root, "magiattention_tpu_torch", "csrc")
    out = os.path.join(src, "build")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in NAMES:
        lib = os.path.join(out, f"lib{name}_other.so")
        cmd = [csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", lib,
               os.path.join(src, csrc.KERNELS[name].source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} of {root} did not build:\n{log}")
        lib = ctypes.CDLL(path)
        fn = getattr(lib, csrc.KERNELS[name].entry)
        fn.argtypes, fn.restype = csrc.KERNELS[name].argtypes, ctypes.c_int
        lib.magi_error_string.argtypes, lib.magi_error_string.restype = [ctypes.c_int], \
            ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    other = build_other(os.path.abspath(args.other))
    csrc.build(list(NAMES))
    for name in NAMES:
        csrc.load(name)
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def same(name, fn):
        a, b = fn(), cs.with_library(name, other[name], fn)()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        return all(torch.equal(x, y) for x, y in zip(a, b))

    C = 1
    qr_h, kr_h, ty_h = split_slices(varlen_block_causal(4096))
    cases = [("causal_2048", 2048, [(0, 2048)], [(0, 2048)], [C], {}),
             ("varlen_softcap", 2000, [(0, 700), (700, 2000)], [(0, 700), (700, 2000)], [C, C],
              {"softcap": 30.0}),
             ("uncovered_sink", 1000, [(100, 600)], [(0, 500)], [C],
              {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
             ("varlen_block_causal", 4096, qr_h, kr_h, ty_h, {})]
    for name, t, qr, kr, ty, kw in cases:
        for g in (1, 2, 4):
            for d in (128, 64):
                p = cs.Flex(gen, t, t, 8, 8 // g, qr, kr, ty, d=d, **kw)
                rec = {"case": f"{name}_g{g}_d{d}", "flex_fwd": same("flex_fwd", p.kernel),
                       "flex_fwd_hb": same("flex_fwd_hb", lambda: p.hb_kernel(max(g, 2))),
                       "flex_dq": same("flex_dq", p.dq_kernel),
                       "flex_dkv": same("flex_dkv", p.dkv_kernel),
                       "flex_dq_sparse": same("flex_dq_sparse", p.dq_sparse_kernel),
                       "flex_dkv_sparse": same("flex_dkv_sparse", p.dkv_sparse_kernel)}
                print(json.dumps({"bitwise_equal": rec}), flush=True)
                if not all(v for k, v in rec.items() if k != "case"):
                    return 1
    p = cs.Flex(gen, 4096, 4096, cs.HQ, cs.HK, [(0, 4096)], [(0, 4096)], [C])
    g = cs.HQ // cs.HK
    runs = {"flex_fwd": ("flex_fwd", p.kernel), "flex_fwd_hb": ("flex_fwd_hb",
                                                                lambda: p.hb_kernel(g))}
    samples = {}
    for key, (name, fn) in runs.items():
        for which, f in (("other", cs.with_library(name, other[name], fn)), ("this", fn), ("this", fn),
                         ("other", cs.with_library(name, other[name], fn))):
            samples.setdefault(f"{which}:{key}", []).append(cs.cuda_ms(f, reps=20))
    print(json.dumps({"serving_prefill_causal_4096": {"hq": cs.HQ, "hk": cs.HK,
                                                      "head_block_hb": g, "ms_in_turns": samples,
                                                      "ms": {k: sum(v) / len(v)
                                                             for k, v in samples.items()}}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
