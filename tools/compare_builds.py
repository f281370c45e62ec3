#!/usr/bin/env python3
"""Hold this checkout's flex and decode kernels against another checkout's, on one card.

    python3 tools/compare_builds.py --other DIR [--seed N]

DIR is the root of another checkout of the repository (an unpacked ``git
archive`` of the parent commit, say, in a git-ignored directory). Both
checkouts' eight flex kernels are built with nvcc for sm_90a (the other's
into its own ``csrc/build/``) and called through this checkout's wrappers,
whose C signatures they must share. Prints one JSON line per case: whether
the two builds give the same bits, and their CUDA-event times in turns
(other, this, this, other): the row-major four on the serving prefill
(causal 4096, 32 q / 8 kv heads, d 128), the sparse-grid four on the
16,384-token varlen block-causal mask at 16 / 8 heads (head_block 1 and G).
The bits are compared at head_dim 128, 64, 32 and 256.
The card's name and power limit come first, as ``nvidia-smi`` prints them.

``paged_decode`` is built too and called with the other checkout's own C
signature (read from its ``decode.cu``): its walks that both checkouts
share (bf16 groups of up to 32 q heads a kv head at head_dim 32, 64, 128
and 256, the shared mode, the one-launch tick's per-row tables, the float32
walks at 32, 64 and 128) give the same bits or
the run fails; then its time on the serving batch (``chip_smoke.py``'s
decode batch at the serving widths, one split) in turns. The wide walk's
arguments (``num_pages``, ``seg_chunks``, ``blocks`` after
``cluster_heads``, ``scratch`` and ``counters`` before the stream) are
passed as the pool's pages, 0, 0 and null, which the walks both share do
not read."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv", "flex_fwd_sparse",
         "flex_fwd_sparse_hb", "flex_dq_sparse", "flex_dkv_sparse")


def build_other(root: str, names=NAMES) -> dict:
    """The other checkout's kernels (default: the eight flex kernels), built
    in parallel and loaded with this checkout's argtypes."""
    from magiattention_tpu_torch import csrc

    src = os.path.join(root, "magiattention_tpu_torch", "csrc")
    out = os.path.join(src, "build")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
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


def _entry_argtypes(source: str, entry: str) -> list:
    """The ctypes of a ``.cu`` file's ``extern "C"`` entry point's
    parameters, read from its text (a pointer or the stream: ``c_void_p``)."""
    import re

    text = open(source).read()
    m = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)\s*\{{", text[text.index('extern "C"'):])
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else kinds[p.replace("const ", "").split()[0]]
            for p in m.group(1).split(",")]


def build_other_decode(root: str):
    """The other checkout's ``paged_decode``, built and loaded with its own
    entry point's argtypes; returns (the entry point, its parameter count)."""
    from magiattention_tpu_torch import csrc

    src = os.path.join(root, "magiattention_tpu_torch", "csrc")
    lib_path = os.path.join(src, "build", "libpaged_decode_other.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    res = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", lib_path,
                          os.path.join(src, "decode.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"paged_decode of {root} did not build:\n{res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(lib_path), "magi_paged_decode")
    fn.argtypes = _entry_argtypes(os.path.join(src, "decode.cu"), "magi_paged_decode")
    fn.restype = ctypes.c_int
    return fn


def call_other_decode(fn, ptrs, ints, floats, num_pages, stream) -> int:
    """The other entry point on (q, k, v, bt, sl, out, lse), (b hq hk d ps
    mpp splits shared is_f32 cluster_heads), (scale, softcap), with the wide
    walk's arguments set to what the shared walks do not read."""
    return fn(*ptrs, *ints, num_pages, 0, 0, *floats, None, None, stream)


def decode_cases(other_fn, gen) -> bool:
    """This checkout's ``paged_decode`` (through its wrapper) against the
    other's entry point on the walks both share; one JSON line a case."""
    import math

    import torch

    import chip_smoke as cs

    def other(q, cache, bt, sl, splits, shared=False):
        b, hq, d = q.shape
        out = torch.empty((b, splits, hq, d), device="cuda")
        lse = torch.empty((b, splits, hq), device="cuda")
        bt, sl = bt.int().contiguous(), sl.int().contiguous()
        hk = cache.num_kv_heads
        code = call_other_decode(
            other_fn, (q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
                       bt.data_ptr(), sl.data_ptr(), out.data_ptr(), lse.data_ptr()),
            (b, hq, hk, d, cache.page_size, bt.shape[1], splits, int(shared),
             int(q.dtype == torch.float32), hk), (1.0 / math.sqrt(d), 0.0),
            cache.k_pages.shape[0], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the other paged_decode: CUDA error {code}")
        return out, lse

    ok = True
    for dtype, groups in ((torch.bfloat16, (1, 4, 8, 16, 32)), (torch.float32, (1, 4, 8, 48))):
        for d in ((32, 64, 128, 256) if dtype == torch.bfloat16 else (32, 64, 128)):
            for g in groups:
                for ps in (16, 128):
                    hk = 2 if g <= 16 else 1
                    lens = [0, 1, ps + 1, 700, 1500, 24 * ps]
                    cache, q = cs.decode_problem(gen, d, dtype, g * hk, hk, ps, lens, mpp=24)
                    bt, sl = cache.block_tables, cache.seq_lens
                    cases = {f"flat_s{s}": (q, bt, sl, s, False) for s in (1, 3)}
                    if g <= 8:
                        members = 8 // g if dtype == torch.bfloat16 else 3
                        qm = q[:1].expand(members, -1, -1).contiguous()
                        cases["shared"] = (qm, bt[5:6, :12], torch.full((1,), 12 * ps - 5,
                                           dtype=torch.int32, device="cuda"), 1, True)
                        rows = 5  # the one-launch tick: a chunk's rows on one table row
                        cases["tick"] = (q[:1].expand(rows, -1, -1).contiguous(),
                                         bt[4:5].expand(rows, -1).contiguous(),
                                         (sl[4] - rows + 1 + torch.arange(
                                             rows, device="cuda")).int(), 1, False)
                    for tag, (qq, bb, ss, s, shared) in cases.items():
                        this = cs.decode_parts(qq, cache, bb, ss, s, shared=shared)
                        same = cs.bitwise(this, other(qq, cache, bb, ss, s, shared))
                        ok &= same
                        print(json.dumps({"paged_decode_bitwise_equal": {
                            "case": f"{str(dtype)[6:]}_d{d}_g{g}_hk{hk}_ps{ps}_{tag}",
                            "equal": same}}), flush=True)
    return ok


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
    other_decode = build_other_decode(os.path.abspath(args.other))
    csrc.build(["paged_decode"])
    csrc.load("paged_decode")
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    if not decode_cases(other_decode, gen):
        return 1
    cache, q = cs.decode_problem(gen, cs.D, torch.bfloat16, cs.HQ, cs.HK, cs.PAGE,
                                 cs.WIDE_DECODE_LENS, mpp=64)
    bt, sl = cache.block_tables, cache.seq_lens
    out = (torch.empty((len(cs.WIDE_DECODE_LENS), 1, cs.HQ, cs.D), device="cuda"),
           torch.empty((len(cs.WIDE_DECODE_LENS), 1, cs.HQ), device="cuda"))
    bti, sli = bt.int().contiguous(), sl.int().contiguous()

    def other_serving():
        code = call_other_decode(
            other_decode, (q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
                           bti.data_ptr(), sli.data_ptr(), out[0].data_ptr(), out[1].data_ptr()),
            (len(cs.WIDE_DECODE_LENS), cs.HQ, cs.HK, cs.D, cs.PAGE, 64, 1, 0, 0, cs.HK),
            (cs.D ** -0.5, 0.0), cache.k_pages.shape[0], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the other paged_decode: CUDA error {code}")

    this_serving = lambda: cs.decode_parts(q, cache, bt, sl, 1)
    turns = {"other": [], "this": []}
    for which, f in (("other", other_serving), ("this", this_serving), ("this", this_serving),
                     ("other", other_serving)):
        turns[which].append(cs.cuda_ms(f, reps=50))
    print(json.dumps({"paged_decode_serving_batch": {
        "hq": cs.HQ, "hk": cs.HK, "head_dim": cs.D, "lengths": list(cs.WIDE_DECODE_LENS),
        "ms_in_turns": turns, "ms": {k: sum(v) / len(v) for k, v in turns.items()}}}),
          flush=True)
    other = build_other(os.path.abspath(args.other))
    csrc.build(list(NAMES))
    for name in NAMES:
        csrc.load(name)

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
            for d in (128, 64, 32, 256):
                p = cs.Flex(gen, t, t, 8, 8 // g, qr, kr, ty, d=d, **kw)
                rec = {"case": f"{name}_g{g}_d{d}", "flex_fwd": same("flex_fwd", p.kernel),
                       "flex_fwd_hb": same("flex_fwd_hb", lambda: p.hb_kernel(max(g, 2))),
                       "flex_dq": same("flex_dq", p.dq_kernel),
                       "flex_dkv": same("flex_dkv", p.dkv_kernel),
                       "flex_dq_sparse": same("flex_dq_sparse", p.dq_sparse_kernel),
                       "flex_dkv_sparse": same("flex_dkv_sparse", p.dkv_sparse_kernel)}
                for hb in (1, max(g, 2)):
                    p.set_head_block(hb)
                    rec[p.fwd_sparse_name] = same(p.fwd_sparse_name, p.sparse_kernel)
                print(json.dumps({"bitwise_equal": rec}), flush=True)
                if not all(v for k, v in rec.items() if k != "case"):
                    return 1
    def in_turns(runs, reps=20) -> dict:
        samples = {}
        for key, (name, fn) in runs.items():
            for which, f in (("other", cs.with_library(name, other[name], fn)), ("this", fn),
                             ("this", fn), ("other", cs.with_library(name, other[name], fn))):
                samples.setdefault(f"{which}:{key}", []).append(cs.cuda_ms(f, reps=reps))
        ms = {k: sum(v) / len(v) for k, v in samples.items()}
        return {"ms_in_turns": samples, "ms": ms,
                "this_over_other": {key: ms[f"this:{key}"] / ms[f"other:{key}"] for key in runs}}

    p = cs.Flex(gen, 4096, 4096, cs.HQ, cs.HK, [(0, 4096)], [(0, 4096)], [C])
    g = cs.HQ // cs.HK
    runs = {"flex_fwd": ("flex_fwd", p.kernel),
            "flex_fwd_hb": ("flex_fwd_hb", lambda: p.hb_kernel(g)),
            "flex_dq": ("flex_dq", p.dq_kernel), "flex_dkv": ("flex_dkv", p.dkv_kernel)}
    print(json.dumps({"serving_prefill_causal_4096": {"hq": cs.HQ, "hk": cs.HK,
                                                      "head_block_hb": g, **in_turns(runs)}}),
          flush=True)
    del p
    torch.cuda.empty_cache()
    t = cs.HETERO_T
    qr, kr, ty = split_slices(varlen_block_causal(t))
    hq, hk = cs.TRAIN_HQ, cs.TRAIN_HK
    p = cs.Flex(gen, t, t, hq, hk, qr, kr, ty, head_block=1)
    runs = {"flex_fwd_sparse": ("flex_fwd_sparse", p.sparse_kernel)}
    line = in_turns(runs)
    p.set_head_block(hq // hk)
    runs = {"flex_fwd_sparse_hb": ("flex_fwd_sparse_hb", p.sparse_kernel),
            "flex_dq_sparse": ("flex_dq_sparse", p.dq_sparse_kernel),
            "flex_dkv_sparse": ("flex_dkv_sparse", p.dkv_sparse_kernel)}
    more = in_turns(runs)
    for k in line:
        line[k].update(more[k])
    print(json.dumps({"hetero_varlen_16384": {"hq": hq, "hk": hk, **line}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
