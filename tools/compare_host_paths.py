#!/usr/bin/env python3
"""Time two host paths of this checkout against another checkout's, on one card.

    python3 tools/compare_host_paths.py --other DIR [--reps N] [--calls N]

DIR is the root of another checkout of the repository (an unpacked ``git
archive`` of the parent commit, say, in a git-ignored directory). Each
checkout runs in processes of its own, in turns (other, this, this, other,
other, this), and the two are compared within this one call:

- ``flex``: the host microseconds of one ``flex_flash_attn_func`` call
  (forward, no autograd; the card synchronised before each call, outside
  the timed span), with the blocking left to the package (its kernel
  choice included) and with it given (``block_q``, ``block_k``,
  ``head_block``, ``grid``: no choice made), ``--calls`` pairs of the two
  after a warm-up, the first of each pair alternating; the choice's cost
  is the median of the pairs' differences. On the serving prefill (causal
  4096, 32 q / 8 kv heads, d 128, bf16) and on
  ``testing.workloads.varlen_block_causal(16384)`` at 16 / 8;
- ``keys``: the host milliseconds of ``magi_attn_varlen_key`` under
  ``MAGI_ATTENTION_PLAN_REUSE=bucket`` at cp 2 (two ranks over gloo, both
  on ``cuda:0``, a barrier before each call, outside the timed span) on a
  stream of six requests that resolves through every tier: cold (the
  solver), bucket (a fingerprint hit) and exact (a cached key). The
  stream runs ``--reps`` times from cleared caches (the runtime's and, where
  the checkout has one, the tuning cache); the first pass is a warm-up.

Prints the card's name and power limit as ``nvidia-smi`` gives them, one
JSON line per process, and last one JSON line of medians by checkout."""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (request, document lengths, the tier it resolves through)
STREAM = (("A", (3000, 5000, 1500, 6000), "cold"), ("B", (2900, 4700, 1400, 5900), "bucket"),
          ("C", (2900, 4700, 1400, 5900), "exact"), ("D", (2900, 4700, 1400, 6000), "bucket"),
          ("E", (3072, 5120, 1536, 6144), "exact"), ("F", (7000, 7000, 2000), "cold"))
HEADS, HEAD_DIM, CHUNK = (16, 8), 128, 512


def measure_flex(calls: int) -> dict:
    import torch
    from magiattention_tpu_torch.ops import flex_attn
    from magiattention_tpu_torch.ops.flex_attn import flex_flash_attn_func
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {"prefill_4096_32x8": (4096, 32, 8, ([(0, 4096)], [(0, 4096)], [1])),
             "hetero_16x8": (16384, 16, 8, split_slices(varlen_block_causal(16384)))}
    out = {}
    for name, (t, hq, hk, mask) in cases.items():
        q, k, v = (torch.randn((t, h, HEAD_DIM), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for h in (hq, hk, hk))
        with torch.no_grad():
            # the package's choice, then the same blocking given
            flex_flash_attn_func(q, k, v, *mask)
            bq, bk, hb, grid = flex_attn.auto_kernel_config(
                mask[0], mask[1], hq, hk, attn_type_map=mask[2], head_dim=HEAD_DIM,
                dtype=str(q.dtype), **({"device": q.device} if _takes_device() else {}))
            given = dict(block_q=bq, block_k=bk, head_block=hb, grid=grid)
            times = {"chosen": [], "given": []}
            for i in range(calls + 5):  # in pairs, the first of each pair alternating
                order = (("chosen", {}), ("given", given))
                for label, kw in order if i % 2 else order[::-1]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    flex_flash_attn_func(q, k, v, *mask, **kw)
                    if i >= 5:
                        times[label].append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            row = {"blocking": [bq, bk, hb, grid],
                   **{f"{label}_host_us": statistics.median(t) for label, t in times.items()},
                   "choice_host_us": statistics.median(
                       c - g for c, g in zip(times["chosen"], times["given"]))}
        out[name] = row
        del q, k, v
    return out


def _takes_device() -> bool:
    import inspect

    from magiattention_tpu_torch.ops import flex_attn

    return "device" in inspect.signature(flex_attn.auto_kernel_config).parameters


def measure_keys(rank: int, world: int, port: int, reps: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    os.environ["MAGI_ATTENTION_PLAN_REUSE"] = "bucket"
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        from magiattention_tpu_torch import api
        from magiattention_tpu_torch.api import interface

        try:
            from magiattention_tpu_torch.tuning import reset_tuning_cache
        except ImportError:  # a checkout without the tuner
            def reset_tuning_cache():
                pass

        group = dist.new_group(list(range(world)))
        by_tier = {tier: [] for _, _, tier in STREAM}
        seen = []
        for rep in range(reps):
            api.clear_cache()
            reset_tuning_cache()
            for name, docs, tier in STREAM:
                cu = np.concatenate([[0], np.cumsum(docs)]).astype(int).tolist()
                cache = interface._plan_reuse_cache
                hits, misses, n = cache.hits, cache.misses, len(interface._runtime_dict)
                dist.barrier(group=group)
                t0 = time.perf_counter()
                api.magi_attn_varlen_key(cu, cu[-1], group, num_heads=HEADS, head_dim=HEAD_DIM,
                                         chunk_size=CHUNK, out_dtype=torch.bfloat16,
                                         device=device)
                ms = (time.perf_counter() - t0) * 1e3
                got = ("bucket" if cache.hits > hits else "cold"
                       if cache.misses > misses or len(interface._runtime_dict) > n else "exact")
                if rep == 0:
                    seen.append(got)
                else:
                    by_tier[tier].append(ms)
        return {"rank": rank, "tiers": seen, "expected": [t for _, _, t in STREAM],
                "median_ms": {t: statistics.median(v) for t, v in by_tier.items()},
                "ms": by_tier}
    finally:
        dist.destroy_process_group()


def child(args) -> int:
    sys.path.insert(0, args.root)
    if args.measure == "flex":
        res = measure_flex(args.calls)
    else:
        res = measure_keys(args.rank, args.world, args.port, args.reps)
    print(json.dumps(res))
    return 0


def _run(cmd: list, env: dict | None = None) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _result(proc: subprocess.Popen, what: str) -> dict:
    out, err = proc.communicate(timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def prebuild(roots: list) -> None:
    """Both checkouts' kernels for these shapes and their host planners,
    built side by side before any timing."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from magiattention_tpu_torch import csrc; "
            "csrc.build(['flex_fwd_hb', 'flex_fwd_sparse_hb', 'flex_fwd_sparse', 'flex_fwd']); "
            "csrc.build_host()")
    procs = [(_run([sys.executable, "-c", code, r]), r) for r in roots]
    for p, r in procs:
        _, err = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"the build of {r} failed:\n{err[-4000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--measure", choices=("flex", "keys"))
    ap.add_argument("--root")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    if args.measure:
        return child(args)
    if not args.other:
        ap.error("--other DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    other = os.path.abspath(args.other)
    prebuild([other, HERE])
    me = [sys.executable, os.path.abspath(__file__)]
    env = {k: v for k, v in os.environ.items() if not k.startswith("MAGI_ATTENTION_")}
    runs = {"other": [], "this": []}
    for label in ("other", "this", "this", "other", "other", "this"):
        root = other if label == "other" else HERE
        flex = _result(_run([*me, "--measure", "flex", "--root", root,
                             "--calls", str(args.calls)], env), f"flex on {root}")
        port = _free_port()
        ranks = [_run([*me, "--measure", "keys", "--root", root, "--rank", str(r),
                       "--world", "2", "--port", str(port), "--reps", str(args.reps)], env)
                 for r in range(2)]
        keys = [_result(p, f"keys rank {r} on {root}") for r, p in enumerate(ranks)]
        line = {"checkout": label, "root": root, "flex": flex, "keys": keys}
        print(json.dumps(line), flush=True)
        runs[label].append(line)
    summary = {}
    for label, lines in runs.items():
        flex = {case: {m: statistics.median(ln["flex"][case][m] for ln in lines)
                       for m in ("chosen_host_us", "given_host_us", "choice_host_us")}
                for case in lines[0]["flex"]}
        keys = {tier: [statistics.median(v for ln in lines for v in ln["keys"][r]["ms"][tier])
                       for r in range(2)]
                for tier in lines[0]["keys"][0]["ms"]}
        summary[label] = {"flex": flex, "key_host_ms_by_tier_per_rank": keys,
                          "tiers_ok": all(k["tiers"] == k["expected"]
                                          for ln in lines for k in ln["keys"])}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
