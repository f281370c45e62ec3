#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors on this machine.

    python3 tools/gloo_cuda_probe.py [--with-p2p]

Two processes share ``cuda:0`` over a gloo group (as the smoke's cp ranks
do) and run each collective the port's comm layer uses on CUDA tensors,
checking the result. The port stages through pinned host buffers exactly
the ops gloo does not take (``comm.group_collective.GLOO_CUDA_OPS``).
``--with-p2p`` also tries ``batch_isend_irecv`` on CUDA tensors last: gloo's
send/recv read a host pointer, and on an H100 with torch 2.11 the ranks
die in it ("writev ... Bad address"), so the probe reports nothing after it.
Needs one card.
"""

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magiattention_tpu_torch.testing.dist import run_ranks  # noqa: E402


def _probe(group, with_p2p: bool) -> dict:
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    rank, peer = dist.get_rank(group), 1 - dist.get_rank(group)
    res = {}

    def a2a(dtype):
        x = (torch.arange(4, device=dev, dtype=torch.float32) + 10 * rank).to(dtype)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        want = [0, 1, 10, 11] if rank == 0 else [2, 3, 12, 13]
        return y.float().tolist() == want

    def all_gather():
        x = torch.full((3,), float(rank), device=dev)
        ys = [torch.empty(3, device=dev) for _ in range(2)]
        dist.all_gather(ys, x, group=group)
        return all(bool((ys[r] == r).all()) for r in range(2))

    def all_reduce():
        x = torch.full((5,), float(rank + 1), device=dev)
        dist.all_reduce(x, group=group)
        return bool((x == 3).all())

    def broadcast():
        x = torch.full((5,), float(rank + 1), device=dev)
        dist.broadcast(x, 0, group=group)
        return bool((x == 1).all())

    def p2p():
        x = torch.full((4,), float(rank + 7), device=dev)
        y = torch.empty(4, device=dev)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer, group),
                                         dist.P2POp(dist.irecv, y, peer, group)]):
            w.wait()
        return bool((y == peer + 7).all())

    ops = [("all_to_all_single", lambda: a2a(torch.float32)),
           ("all_to_all_single_bf16", lambda: a2a(torch.bfloat16)),
           ("all_gather", all_gather), ("all_reduce", all_reduce), ("broadcast", broadcast)]
    if with_p2p:
        ops.append(("batch_isend_irecv", p2p))
    for name, fn in ops:
        try:
            res[name] = "ok" if fn() else "wrong result"
        except Exception as exc:  # report what gloo refuses, op by op
            res[name] = f"{type(exc).__name__}: {str(exc)[:160]}"
        torch.cuda.synchronize()
        dist.barrier(group)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--with-p2p", action="store_true")
    args = ap.parse_args()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "rank0": run_ranks(_probe, 2, args.with_p2p)[0]}, indent=1))
