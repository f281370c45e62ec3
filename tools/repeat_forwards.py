#!/usr/bin/env python3
"""Run the four flex forwards many times in a row and count the runs whose bits differ from the first.

    python3 tools/repeat_forwards.py [--other DIR] [--runs N] [--product P] [--seed N]

On one card, causal 2048 at 16 q / 2 kv heads (G 8) with random keys and
with keys scaled 1 -> 12 along the sequence (``chip_smoke.RISING_K``), at d
128 (the walk holds Q in registers) and d 64: ``flex_fwd_sparse_hb`` (head_block
8: four head pairs a work item, the work list's last items walks of one and
two k tiles) N times, ``flex_fwd_hb`` N / 2, ``flex_fwd`` and
``flex_fwd_sparse`` (head_block 1) N / 4 each, once alone and once with a
float32 product of two P x P matrices (``--product``, default 4096) queued
on a second stream before every other run, which keeps that stream busy
through the runs and the forwards' blocks starting at uneven times. A walk
that hands a shared-memory buffer back before all its reads are done
differs on some runs only, as a few rows of one head; the two runs of the
smoke's cases seldom catch that.

With ``--other DIR`` (the root of another checkout, e.g. an unpacked ``git
archive`` of the parent commit in a git-ignored directory) the other
checkout's four forwards are built into its own ``csrc/build/`` and counted
the same way after this checkout's. The card's name and power limit come
first, one JSON line per (build, case, kernel, mode) follows, then a
summary. Exits 1 if a run of this checkout's build differed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = ("flex_fwd", "flex_fwd_hb", "flex_fwd_sparse", "flex_fwd_sparse_hb")


def count_differing(fn, runs: int, side, a) -> int:
    """Runs of ``fn`` whose outputs are not bit for bit its first run's;
    with a stream ``side``, a product of ``a`` on it before every other run."""
    import torch

    first = fn()
    differing = 0
    for r in range(runs):
        if side is not None and r % 2:
            with torch.cuda.stream(side):
                torch.mm(a, a)
        differing += not all(torch.equal(x, y) for x, y in zip(first, fn()))
    torch.cuda.synchronize()
    return differing


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other")
    ap.add_argument("--runs", type=int, default=4000)
    ap.add_argument("--product", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from magiattention_tpu_torch import csrc

    if not torch.cuda.is_available():
        print("repeat_forwards: needs a CUDA card", file=sys.stderr)
        return 1
    builds = {"this": None}
    if args.other:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from compare_builds import build_other

        builds["other"] = build_other(os.path.abspath(args.other), NAMES)
    csrc.build(list(NAMES))
    for name in NAMES:
        csrc.load(name)
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    a = torch.randn((args.product, args.product), generator=gen, device="cuda")
    side = torch.cuda.Stream()
    problems = {f"{label}_g8_d{d}": cs.Flex(gen, 2048, 2048, 16, 2, [(0, 2048)], [(0, 2048)],
                                            [1], d=d, **kw)
                for d in (128, 64) for label, kw in (("causal", {}),
                                                     ("rising", {"k_ramp": cs.RISING_K}))}
    summary = {}
    for build, libs in builds.items():
        for case, p in problems.items():
            for name, hb, runs in (("flex_fwd_sparse_hb", 8, args.runs),
                                   ("flex_fwd_hb", 8, args.runs // 2),
                                   ("flex_fwd", 8, args.runs // 4),
                                   ("flex_fwd_sparse", 1, args.runs // 4)):
                p.set_head_block(hb)
                fn = {"flex_fwd_sparse_hb": p.sparse_kernel, "flex_fwd_sparse": p.sparse_kernel,
                      "flex_fwd_hb": lambda: p.hb_kernel(8), "flex_fwd": p.kernel}[name]
                if libs is not None:
                    fn = cs.with_library(name, libs[name], fn)
                for mode in ("alone", "beside_a_product"):
                    t0 = time.perf_counter()
                    n = count_differing(fn, runs, side if mode != "alone" else None, a)
                    key = f"{build}|{case}|{name}|{mode}"
                    summary[key] = [n, runs]
                    print(json.dumps({"build": build, "case": case, "kernel": name, "mode": mode,
                                      "runs": runs, "differing": n,
                                      "s": round(time.perf_counter() - t0, 2)}), flush=True)
    totals = {b: [sum(v[0] for k, v in summary.items() if k.startswith(b + "|")),
                  sum(v[1] for k, v in summary.items() if k.startswith(b + "|"))] for b in builds}
    print(json.dumps({"repeat_forwards": {"differing_of_runs": totals}}), flush=True)
    return 1 if totals["this"][0] else 0


if __name__ == "__main__":
    sys.exit(main())
