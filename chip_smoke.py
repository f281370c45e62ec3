#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``magiattention_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. build — compile the nine Hopper kernels (the row-major ``flex_fwd``,
   ``flex_fwd_hb``, ``flex_dq``, ``flex_dkv``, the sparse-grid
   ``flex_fwd_sparse``, ``flex_fwd_sparse_hb``, ``flex_dq_sparse``,
   ``flex_dkv_sparse``, and ``paged_decode``) from the sources in
   ``magiattention_tpu_torch/csrc/`` with nvcc for sm_90a, all at once
   (with mutated copies for the planted faults and the sparse forwards'
   every-rise AMLA variant, and the previous, pre-TMA row-major forward and
   backward walks, the previous sparse-grid forward and backward walks and
   the previous CUDA-core decode walk as yardstick libraries), print
   ptxas's registers and spills and, for the eight flex kernels, the count
   of ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA load) instructions in ``cuobjdump -sass``, for
   ``paged_decode`` its ``HMMA`` (mma.sync), ``LDGSTS`` (cp.async) and
   ``LDSM`` (ldmatrix), and print the card's name and power limit as
   nvidia-smi reports them;
2. kernels — each kernel against its plain PyTorch version on the card, in
   bf16 at head_dim 128 (and 64 for the head-batched and sparse-grid
   forwards), on the mask families and ragged lengths below (``flex_fwd``
   and the backward at head_dim 128 and 64 with 4, 2 and 1 q heads per kv
   head, the backward with a random lse cotangent; the
   head-batched row-major forward at 1, 2 and 4 q heads per kv head and G
   and 2G heads per block, and whether it equals ``flex_fwd`` bit for bit;
   the sparse grid at 1, 2 and 4 q heads per kv head and one, G and 2G
   heads per work item; softcap and sink on one case each; the sparse-grid
   backward again at d 128 and 64 and 1, 2, 3, 4 and 8 q heads per kv head
   on the heterogeneous masks and one of short walks, with softcap on one
   case and uncovered rows on another, bit for bit equal to ``flex_dq`` /
   ``flex_dkv`` on the same tables; the sparse-grid forwards at the same
   widths on the same masks and one whose keys grow along the sequence, so
   that AMLA's reference moves, at head_block 1 and G), each kernel run
   twice for the same bits, each with its stated tolerance; faults
   planted in the kernels (the backward walks cut short, the AMLA rescale
   of O skipped once per row in mutated copies of both sparse forwards, on
   rising logits, every head
   of a head-batched item reading the first head's kv head in a mutated
   copy of ``flex_fwd_hb``, the second consumer warpgroup's partial dropped
   from the odd-G merge in a mutated copy of ``flex_fwd``, the second
   consumer warpgroup's dK partial dropped before the final sum in a
   mutated copy of ``flex_dkv``, and in mutated copies of the persistent
   sparse backward each dq item after a block's first reusing the previous
   item's resident Q and dO, and the dK/dV partials not zeroed between a
   block's items), which the checks must catch; then the
   row-major kernels' times at their main path's shapes, each in turns with
   the previous walk (``flex_fwd`` and ``flex_fwd_hb`` at head_block G and
   2G on the serving prefill and on causal 8192 at the training widths;
   ``flex_dq`` and ``flex_dkv`` on the latter) beside the plain version's,
   a PyTorch ``scaled_dot_product_attention`` yardstick and the card's
   bound; ``paged_decode`` at d 128 / 64, bf16 / f32, 1-16 q heads per kv
   head, pages of 16, 64 and 128 tokens and 1, 3, 4 and 16 splits, each
   launch twice for the same bits, NaN past the lengths changing no bit,
   and its shared mode (the cascade's level 1) at 1, 3 and 8 members, with
   two planted faults (each split's last chunk dropped; every member on
   member 0's q);
3. serving — the port's serving path at Llama-3.1-8B attention widths
   (32 q heads, 8 kv heads, head_dim 128, bf16, page size 128): admit 8
   requests, prefill them (one chunked, so the continuation path runs) with
   the automatic kernel choice (row-major, head_block 4: ``flex_fwd_hb``),
   run 64 decode steps over the batch, and hold prefill outputs (prompts up
   to 4096 tokens) and every 8th decode step against the plain versions;
   on the final batch ``paged_decode``'s time in turns with the previous
   walk, the split sweep (kernel alone, and with the merge in device time)
   there and on one 32K-token sequence, the plain version, SDPA and the
   bound (``decode_timing``);
   then the same at multi-head widths (32 q / 32 kv heads), where the
   choice is head_block 1 and the prefill runs ``flex_fwd``;
4. prefix — shared-prefix serving at the same widths: a 4000-token prompt
   (31 full pages and a 32-token tail), then 7 requests that begin with it
   (``admit(tokens=)`` forks onto its pages; the first write of each splits
   the shared tail page) and add 300-2000 tokens each, one prefilled in
   512-token chunks; each suffix's rows held against the plain causal
   attention over its whole prompt; 32 decode steps of the 8 with cascade
   decode (one group on the 31 shared pages, its level 1 in the kernel's
   shared mode, counted), the first step's cascade ``auto`` and ``on`` held
   against the flat path and the plain decode; the pages in use against a
   flat engine's; cascade against flat decode attention on the final state,
   on the host clock and in device time;
5. training — the port's Llama trainer at the widths of the repo's
   ``LlamaConfig`` (vocab 32000, dim 2048, 16 q / 8 kv heads, head_dim 128,
   ffn 5632, bf16 compute, fp32 masters), cut from 16 to 4 layers, on one
   8192-token stream packed as documents [4096, 2048, 2048]: 6 AdamW steps
   on a fixed batch from ``--seed`` with the harness's blocking (row-major,
   head_block 2: ``flex_fwd_hb``), one layer's attention call of the first
   step held against the plain forward and backward;
6. hetero — ``flex_flash_attn_func`` with its default arguments, forward and
   backward, on the 16384-token varlen block-causal mask (12 documents),
   once at the ``LlamaConfig`` attention widths (16 q / 8 kv heads) and
   once at 8 / 8: the automatic choice must take the sparse grid (head_block
   2, then 1) and launch only the sparse-grid kernels; out, lse and the
   gradients held against the plain versions; each kernel's time beside its
   own with the work list in index order (not longest walk first), the
   row-major kernel's on the same problem, the plain version's, a PyTorch
   varlen (or SDPA) yardstick and the card's bound, each kernel in turns
   with the previous sparse walk, the forward also in turns with its
   variant that moves AMLA's reference on every rise, and the slice's
   forward + backward in device time.

The line before the last lists the nine kernels with their launches on the
main paths (and which paths launched them), errors and times; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; nothing falls back to a plain version. Needs one card and no network.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HQ, HK, D = 32, 8, 128  # Llama-3.1-8B attention widths
TRAIN_HQ, TRAIN_HK = 16, 8  # the repo's LlamaConfig
PAGE = 128
BLOCK = 64  # the flex kernels' tile (ops/flex_attn.py HOPPER_TILES)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# bf16 outputs vs the plain f32 computation rounded to bf16: the kernels
# round P to bf16 before P.V and round the output once; lse and the row max
# come from f32 accumulations in another summation order
OUT_ATOL, OUT_RTOL = 1e-2, 1e-2
LSE_ATOL = 2e-4
# the backward kernels' dq/dk/dv vs the plain f32 backward: the kernels
# round P and dS to bf16 before their products (as the TPU kernels do), so
# an entry's error scales with the terms that make it up. Three checks per
# tensor: the largest error within GRAD_RTOL of the largest entry (plus
# GRAD_ATOL); the relative L2 error within GRAD_L2 (bf16 rounding of P and
# dS alone gives a few 1e-3); and, since on a long causal walk the first
# rows and keys of a document are far larger than the rest and would hide a
# wrong tail from the first two, each 64-row (or 64-key) block of each head
# within GRAD_RTOL of that block's own largest entry, plus GRAD_BLOCK_ATOL
# of the tensor's largest entry (f32 summation-order noise)
GRAD_RTOL, GRAD_ATOL, GRAD_L2, GRAD_BLOCK_ATOL = 2e-2, 1e-3, 1e-2, 1e-5
GRAD_BLOCK = 64
ROW_MAJOR = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv")
SPARSE = ("flex_fwd_sparse", "flex_fwd_sparse_hb", "flex_dq_sparse", "flex_dkv_sparse")
FLEX_KERNELS = ROW_MAJOR + SPARSE
# the largest out (or gradient) error of each kernel over every comparison
MAX_ERR = {name: 0.0 for name in (*FLEX_KERNELS, "paged_decode")}
TRAINING_KERNELS = ("flex_fwd_hb", "flex_dq", "flex_dkv")


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def with_library(kernel, lib, fn):
    """``fn`` (launches of ``kernel`` through its wrapper) on the library
    ``lib`` in place of the kernel's own: a mutated build, a variant or
    another checkout's build. Its launches are not counted."""
    from magiattention_tpu_torch import csrc

    def run():
        real, launched = csrc._libs[kernel], csrc.launches[kernel]
        csrc._libs[kernel] = lib
        try:
            return fn()
        finally:
            csrc._libs[kernel], csrc.launches[kernel] = real, launched

    return run


def out_errors(out, ref_out, pairs) -> tuple[dict, list[str]]:
    """The forward checks: out within OUT_ATOL + OUT_RTOL*|ref|, and each
    (key, got, ref) of ``pairs`` (lse, rowmax) within LSE_ATOL with -inf
    exactly where the plain version has it. Returns the errors measured and
    the checks that failed."""
    import torch

    out, ref_out = out.float(), ref_out.float()
    if not bool(torch.isfinite(out).all()):
        return {}, ["finite"]
    err = (out - ref_out).abs()
    errs = {"out_max_abs_err": float(err.max()) if err.numel() else 0.0}
    failed = ["out"] if bool((err > OUT_ATOL + OUT_RTOL * ref_out.abs()).any()) else []
    for key, got, ref in pairs:
        got, ref = got.float(), ref.float()
        if not bool((torch.isneginf(got) == torch.isneginf(ref)).all()):
            failed.append(f"{key}_neginf")
            continue
        fin = torch.isfinite(ref)
        e = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
        errs[f"{key}_max_abs_err"] = e
        if e > LSE_ATOL:
            failed.append(key)
    return errs, failed


def compare(kernel, name, out, ref_out, lse=None, ref_lse=None, extra=None):
    """Out within OUT_ATOL + OUT_RTOL*|ref|, lse (and ``extra`` pairs)
    within LSE_ATOL with -inf exactly where the plain version has it."""
    pairs = [("lse", lse, ref_lse)] + [(k, g, r) for k, (g, r) in (extra or {}).items()]
    errs, failed = out_errors(out, ref_out, [p for p in pairs if p[1] is not None])
    check(not failed, f"{name}: {kernel} fails the {failed} check(s): {errs}")
    emit({"phase": "kernels", "kernel": kernel, "case": name, **errs})
    MAX_ERR[kernel] = max(MAX_ERR[kernel], errs["out_max_abs_err"])


def grad_errors(got, ref) -> tuple[dict, list[str]]:
    """The three gradient checks of one head-major [h, t, d] tensor against
    its plain version: the errors measured, and the checks that failed."""
    import torch
    import torch.nn.functional as Fn

    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return {}, ["finite"]
    diff = (got - ref).abs()
    ref_max = float(ref.abs().max())
    ref_l2 = float(ref.norm())
    pad = (0, 0, 0, (-ref.shape[1]) % GRAD_BLOCK)

    def block_max(x):  # [h, t, d] -> [h, t / GRAD_BLOCK], the max of each block
        x = Fn.pad(x, pad)
        return x.reshape(x.shape[0], -1, GRAD_BLOCK * x.shape[2]).amax(-1)

    blk_err, blk_ref = block_max(diff), block_max(ref.abs())
    blk_tol = GRAD_RTOL * blk_ref + GRAD_BLOCK_ATOL * ref_max
    errs = {
        "max_abs_err": float(diff.max()),
        "max_tol": GRAD_RTOL * ref_max + GRAD_ATOL,
        "rel_l2": float((got - ref).norm()) / ref_l2 if ref_l2 else float(diff.max()),
        # the largest block error as a share of its tolerance (<= 1 passes)
        "block_err_over_tol": float((blk_err / blk_tol.clamp_min(1e-30)).max()),
    }
    failed = [c for c, ok in (("max", errs["max_abs_err"] <= errs["max_tol"]),
                              ("rel_l2", errs["rel_l2"] <= GRAD_L2),
                              ("blocks", bool((blk_err <= blk_tol).all()))) if not ok]
    return errs, failed


def compare_grads(kernel, name, pairs) -> None:
    """Each (what, got, ref), head-major [h, t, d], passes the three checks
    of :func:`grad_errors`."""
    rec = {"case": name}
    for what, got, ref in pairs:
        errs, failed = grad_errors(got, ref)
        rec.update({f"{what}_{k}": x for k, x in errs.items()})
        check(not failed, f"{name}: {what} fails the {failed} check(s): {errs}")
        MAX_ERR[kernel] = max(MAX_ERR[kernel], errs["max_abs_err"])
    emit({"phase": "kernels", "kernel": kernel, **rec})


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup``, with a spin kernel holding the stream while the host
    enqueues them (as :func:`queued_ms`), so that a wrapper whose host work
    outlasts its kernels is not timed by the host's launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * one_s * reps + 2e-3)))  # cycles, at most ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# the flex kernels' wgmma (HGMMA), TMA loads (UTMALDG) and 1-D bulk
# copies (UBLKCP); paged_decode's mma.sync (HMMA), cp.async (LDGSTS) and
# ldmatrix (LDSM)
FLEX_SASS = ("HGMMA", "UTMALDG", "UBLKCP")
DECODE_SASS = ("HMMA", "LDGSTS", "LDSM")


def sass_counts(path: str, ops=FLEX_SASS) -> dict | None:
    """The count of each instruction of ``ops`` in a library's SASS, from
    the toolkit's ``cuobjdump``; None where the toolkit has none."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {op: sass.count(op) for op in ops}


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# -- flex forward: kernel vs plain ------------------------------------------


class Flex:
    """One flex-attention problem, head-major and padded as
    ``flex_attn_with_meta`` lays it out, callable through the kernel or the
    plain version."""

    def __init__(self, gen, tq, tk, hq, hk, q_ranges, k_ranges, types, *,
                 softcap=0.0, sink=None, d=D, head_block=None, out_dtype=None, k_ramp=None):
        import torch
        from magiattention_tpu_torch.ops import flex_attn as fa

        self.tq, self.tk = tq, tk
        bq, bk = fa.resolve_tile(d, None, None)
        self.meta = fa.build_block_meta(q_ranges, k_ranges, types, tq, tk,
                                        block_q=bq, block_k=bk)
        tqp = self.meta.num_q_blocks * bq
        tkp = self.meta.num_k_blocks * bk

        def rand(t, h, tp):
            x = torch.randn((h, t, d), generator=gen, device="cuda")
            return fa._pad_tokens(x.to(torch.bfloat16), tp)

        self.q, self.k, self.v = rand(tq, hq, tqp), rand(tk, hk, tkp), rand(tk, hk, tkp)
        if k_ramp is not None:  # keys scaled from 1 to k_ramp along the sequence
            ramp = torch.linspace(1.0, k_ramp, tk, device="cuda")[None, :, None]
            self.k[:, :tk] = (self.k[:, :tk].float() * ramp).to(torch.bfloat16)
        self.sink = (
            torch.full((hq,), 0.0, device="cuda") if sink is None
            else torch.as_tensor(sink, dtype=torch.float32, device="cuda")
        )
        self.params = fa.FlexAttnParams(
            block_q=bq, block_k=bk, scale=1.0 / math.sqrt(d), softcap=softcap,
            has_sink=sink is not None, out_dtype=out_dtype or torch.bfloat16,
        )
        self.tables = fa.fwd_tables(self.meta, "cuda:0")
        self.btables = fa.bwd_tables(self.meta, "cuda:0")
        self.do = rand(tq, hq, tqp)
        self.dlse = torch.randn((hq, tqp), generator=gen, device="cuda")
        self._bwd = None
        # the sparse grid, head_block q heads per forward work item (default G)
        self.sparse_params = dataclasses.replace(self.params, grid="sparse")
        self.set_head_block(hq // hk if head_block is None else head_block)

    def bwd_inputs(self):
        """(q, k, v, dout, lse, delta_eff) as the autograd Function hands
        them to the backward: lse from the forward kernel, delta_eff = sum
        dout * out - dlse with a random lse cotangent."""
        if self._bwd is None:
            out, lse, _ = self.kernel()
            delta = (self.do.float() * out.float()).sum(-1) - self.dlse
            self._bwd = (self.q, self.k, self.v, self.do, lse, delta)
        return self._bwd

    def dq_kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dq_kernel(*self.bwd_inputs(), self.tables, self.params)

    def dkv_kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dkv_kernel(*self.bwd_inputs(), self.btables, self.params)

    def dq_plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dq_torch(*self.bwd_inputs(), self.tables, self.params)

    def dkv_plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dkv_torch(*self.bwd_inputs(), self.btables, self.params)

    def check_bwd(self, name) -> None:
        """Both backward kernels against the plain backward, and against
        themselves: a second run gives the same bits (no atomics)."""
        import torch

        dq, (dk, dv) = self.dq_kernel(), self.dkv_kernel()
        torch.cuda.synchronize()
        dq2, (dk2, dv2) = self.dq_kernel(), self.dkv_kernel()
        check(torch.equal(dq, dq2), f"{name}: flex_dq differs between two runs")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{name}: flex_dkv differs between two runs")
        tq, tk = self.tq, self.tk
        compare_grads("flex_dq", name, [("dq", dq[:, :tq], self.dq_plain()[:, :tq])])
        ref_dk, ref_dv = self.dkv_plain()
        compare_grads("flex_dkv", name, [("dk", dk[:, :tk], ref_dk[:, :tk]),
                                         ("dv", dv[:, :tk], ref_dv[:, :tk])])

    def planted_faults(self, planted) -> dict:
        """The gradient checks on four faults planted in the kernels'
        work: the last entry of each q-major walk skipped (dq), the last
        entry of each k-major walk skipped (dk, dv), the last k block's
        dk and dv zeroed, and ``flex_dkv`` built with its second consumer
        warpgroup's dK partial dropped (dk). Returns, per fault and tensor,
        which checks catch it; a fault that the three checks together let
        through fails the smoke. Nothing here is counted as a main-path
        launch."""
        import torch
        from magiattention_tpu_torch.ops import flex_attn as fa

        def skip_last(tab):
            return (*tab[:6], (tab[6] - 1).clamp_min(0).contiguous())

        tq, tk = self.tq, self.tk
        ref_dq = self.dq_plain()[:, :tq]
        ref_dk, ref_dv = (x[:, :tk] for x in self.dkv_plain())
        dq_skip = fa._dq_kernel(*self.bwd_inputs(), skip_last(self.tables), self.params)
        dk_skip, dv_skip = fa._dkv_kernel(*self.bwd_inputs(), skip_last(self.btables),
                                          self.params)
        dk, dv = (x[:, :tk].clone() for x in self.dkv_kernel())
        last = (tk - 1) // GRAD_BLOCK * GRAD_BLOCK
        dk[:, last:], dv[:, last:] = 0.0, 0.0
        dk_drop = with_library("flex_dkv", planted["flex_dkv"], self.dkv_kernel)()[0]
        torch.cuda.synchronize()
        plants = {
            "skip_last_q_walk_entry": [("dq", dq_skip[:, :tq], ref_dq)],
            "skip_last_k_walk_entry": [("dk", dk_skip[:, :tk], ref_dk),
                                       ("dv", dv_skip[:, :tk], ref_dv)],
            "zero_last_k_block": [("dk", dk, ref_dk), ("dv", dv, ref_dv)],
            "drop_second_warpgroup_dk_partial:flex_dkv": [("dk", dk_drop[:, :tk], ref_dk)],
        }
        caught = {}
        for plant, pairs in plants.items():
            for what, got, ref in pairs:
                errs, failed = grad_errors(got, ref)
                caught[f"{plant}:{what}"] = {"failed_checks": failed, **errs}
                check(bool(failed), f"planted fault {plant} passes the {what} checks: {errs}")
        return caught

    def kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_kernel(self.q, self.k, self.v, self.sink, self.tables, self.params)

    def plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_torch(self.q, self.k, self.v, self.sink, self.tables, self.params)

    def check(self, name) -> None:
        """``flex_fwd`` against the plain forward, twice for the same bits."""
        import torch

        out, lse, rowmax = self.kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), self.kernel())),
              f"{name}: flex_fwd differs between two runs")
        ref_out, ref_lse, ref_rowmax = self.plain()
        tq = self.tq
        compare("flex_fwd", name, out[:, :tq], ref_out[:, :tq], lse[:, :tq],
                       ref_lse[:, :tq], {"rowmax": (rowmax[:, :tq], ref_rowmax[:, :tq])})

    # -- the head-batched row-major forward -------------------------------------

    def hb_kernel(self, hb):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_hb_kernel(self.q, self.k, self.v, self.sink, self.tables,
                                 dataclasses.replace(self.params, head_block=hb))

    def hb_errors(self, got):
        """(errors, failed checks) of a head-batched forward's results
        against the plain forward, cut to the real rows."""
        out, lse, rowmax = got
        ref_out, ref_lse, ref_rowmax = self.plain()
        tq = self.tq
        return out_errors(out[:, :tq], ref_out[:, :tq],
                          [("lse", lse[:, :tq], ref_lse[:, :tq]),
                           ("rowmax", rowmax[:, :tq], ref_rowmax[:, :tq])])

    def check_hb(self, name, hb) -> bool:
        """``flex_fwd_hb`` at head_block ``hb`` against the plain forward,
        twice for the same bits. Returns whether it equals ``flex_fwd`` on
        the same inputs bit for bit."""
        import torch

        got = self.hb_kernel(hb)
        torch.cuda.synchronize()
        again = self.hb_kernel(hb)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: flex_fwd_hb differs between two runs")
        errs, failed = self.hb_errors(got)
        check(not failed, f"{name}: flex_fwd_hb fails the {failed} check(s): {errs}")
        emit({"phase": "kernels", "kernel": "flex_fwd_hb", "case": name, "head_block": hb, **errs})
        MAX_ERR["flex_fwd_hb"] = max(MAX_ERR["flex_fwd_hb"], errs["out_max_abs_err"])
        return all(torch.equal(a, b) for a, b in zip(got, self.kernel()))

    # -- the sparse grid ------------------------------------------------------

    def set_head_block(self, hb) -> None:
        """The sparse grid at ``hb`` q heads per forward work item."""
        from magiattention_tpu_torch.ops import flex_attn as fa

        hq, hk = self.q.shape[0], self.k.shape[0]
        self.hb = hb
        self.sparse_params = dataclasses.replace(self.sparse_params, head_block=hb)
        self.work = fa.sparse_work(self.meta, "cuda:0", hq, hk, hb)
        self.fwd_sparse_name = "flex_fwd_sparse_hb" if hb > 1 else "flex_fwd_sparse"

    def sparse_kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        fwd = fa._fwd_sparse_hb_kernel if self.hb > 1 else fa._fwd_sparse_kernel
        return fwd(self.q, self.k, self.v, self.sink, self.tables, self.work, self.sparse_params)

    def sparse_plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_torch_sparse(self.q, self.k, self.v, self.sink, self.tables,
                                    self.sparse_params)

    def dq_sparse_kernel(self, tables=None):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dq_sparse_kernel(*self.bwd_inputs(), tables or self.tables, self.work,
                                    self.sparse_params)

    def dkv_sparse_kernel(self, tables=None):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dkv_sparse_kernel(*self.bwd_inputs(), tables or self.btables, self.work,
                                     self.sparse_params)

    def sparse_fwd_pairs(self, got):
        """(out, [(lse...), (rowmax...)]) of a sparse forward against the
        plain sparse forward, cut to the real rows."""
        out, lse, rowmax = got
        ref_out, ref_lse, ref_rowmax = self.sparse_plain()
        tq = self.tq
        return (out[:, :tq], ref_out[:, :tq],
                [("lse", lse[:, :tq], ref_lse[:, :tq]),
                 ("rowmax", rowmax[:, :tq], ref_rowmax[:, :tq])])

    def check_sparse(self, name) -> None:
        """The sparse forward of this head_block against its plain version,
        and the sparse dq/dkv against the plain backward; each kernel twice,
        for the same bits."""
        import torch

        got = self.sparse_kernel()
        torch.cuda.synchronize()
        again = self.sparse_kernel()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: {self.fwd_sparse_name} differs between two runs")
        out, ref_out, pairs = self.sparse_fwd_pairs(got)
        compare(self.fwd_sparse_name, name, out, ref_out, extra={k: (g, r) for k, g, r in pairs})
        dq, (dk, dv) = self.dq_sparse_kernel(), self.dkv_sparse_kernel()
        torch.cuda.synchronize()
        dq2, (dk2, dv2) = self.dq_sparse_kernel(), self.dkv_sparse_kernel()
        check(torch.equal(dq, dq2), f"{name}: flex_dq_sparse differs between two runs")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{name}: flex_dkv_sparse differs between two runs")
        tq, tk = self.tq, self.tk
        compare_grads("flex_dq_sparse", name, [("dq", dq[:, :tq], self.dq_plain()[:, :tq])])
        ref_dk, ref_dv = self.dkv_plain()
        compare_grads("flex_dkv_sparse", name, [("dk", dk[:, :tk], ref_dk[:, :tk]),
                                                ("dv", dv[:, :tk], ref_dv[:, :tk])])


# -- planted faults in mutated copies of the forward kernels ----------------------

# The AMLA forward with its rescale of O skipped once per row: at the first
# tile where a row's integer base-2 reference rises, the accumulator keeps
# its old scale while l takes the new one. Planted into a copy of
# flex_fwd_sm90.cuh's AMLA mode, built as each sparse-grid forward; the
# checks of ``check_sparse`` must catch it.
PLANT_SKIP_RESCALE = [
    ("    float m[2] = {-INFINITY, -INFINITY}, ref[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n",
     "    float m[2] = {-INFINITY, -INFINITY}, ref[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n"
     "    bool planted[2] = {false, false};\n"),
    ("        if (__any_sync(0xffffffffu, delta[0] != 0 || delta[1] != 0)) {\n",
     "        for (int rr = 0; rr < 2; ++rr)\n"
     "          if (delta[rr] != 0 && !planted[rr]) { planted[rr] = true; delta[rr] = 0; }\n"
     "        if (__any_sync(0xffffffffu, delta[0] != 0 || delta[1] != 0)) {\n"),
]


# The head-batched row-major forward with the head-mapping bug that head
# batching invites: every head of a work item reads the kv head of the
# item's first head. Planted into a copy of flex_fwd_sm90.cuh's producer,
# built as flex_fwd_hb; the checks of ``check_hb`` must catch it where an
# item spans two kv heads.
PLANT_FIRST_KV_HEAD = [
    ("    const int kvh = h0 / group;\n", "    const int kvh = h_item / group;\n"),
]

# The warp-specialised forward with the second consumer warpgroup's
# (reference, l, O) partial dropped from the merge that ends an odd-G walk
# (the two warpgroups split a head's walk by k block). Planted into a copy of
# flex_fwd_sm90.cuh, built as flex_fwd; the forward checks must catch it.
PLANT_DROP_WG1_PARTIAL = [
    ("    const float w1 = ref1 == -INFINITY ? 0.f : expf(ref1 - rs);\n",
     "    const float w1 = 0.f;\n"),
]


# The warp-specialised dk/dv with the second consumer warpgroup's dK partial
# dropped before the final sum (each warpgroup takes every other (entry, q
# head) step of the walk). Planted into a copy of flex_bwd_sm90.cuh; the
# backward checks must catch it.
PLANT_DROP_WG1_DK = [
    ("      add_stashed<0, J>(dka, sib_k, tid);\n", ""),
]

# The persistent dq with the next item reusing the previous item's resident
# tiles: after a block's first item the producer loads no Q and dO and only
# arrives on the resident buffer's barrier. Planted into a copy of
# flex_bwd_sm90.cuh, built as flex_dq_sparse; the gradient checks must catch
# it.
PLANT_STALE_RESIDENT = [
    ("  mbar_expect_tx(bars.res_full(r), L::RESIDENT);\n",
     "  if (n > 0) {  // planted: the previous item's Q and dO stay\n"
     "    mbar_arrive(bars.res_full(r));\n"
     "    return;\n"
     "  }\n"
     "  mbar_expect_tx(bars.res_full(r), L::RESIDENT);\n"),
]

# The persistent dk/dv with the dK and dV partials zeroed only before a
# block's first item, so that each later item adds to the last one's.
# Planted into a copy of flex_dkv_sparse.cu; the gradient checks must catch
# it.
PLANT_KEEP_PARTIALS = [
    ("      zero(dka);\n      zero(dva);\n",
     "      if (n == 0) {  // planted: the partials carried from item to item\n"
     "        zero(dka);\n"
     "        zero(dva);\n"
     "      }\n"),
]

# Each split's last chunk dropped from the tensor-core walk; and, in the
# shared mode, every member reading member 0's q. Planted into copies of
# decode_sm90.cuh; the checks of ``decode_planted_faults`` must catch both.
PLANT_DROP_LAST_CHUNK = [
    ("  const int nchunks = (n + CH - 1) / CH;\n",
     "  const int nchunks = max(0, (n + CH - 1) / CH - 1);\n"),
]
PLANT_MEMBER0_Q = [
    ("      const int qm = i / group;  // the member whose q this row is\n",
     "      const int qm = shared ? 0 : i / group;\n"),
]


# Each mutated build: (the kernel source compiled, the source mutated, its
# plants), in a directory of its own beside the kernels.
PLANTED = {
    "flex_fwd_sparse": ("flex_fwd_sparse.cu", "flex_fwd_sm90.cuh", PLANT_SKIP_RESCALE),
    "flex_fwd_sparse_hb": ("flex_fwd_sparse_hb.cu", "flex_fwd_sm90.cuh", PLANT_SKIP_RESCALE),
    "flex_fwd_hb": ("flex_fwd_hb.cu", "flex_fwd_sm90.cuh", PLANT_FIRST_KV_HEAD),
    "flex_fwd_drop_partial": ("flex_fwd.cu", "flex_fwd_sm90.cuh", PLANT_DROP_WG1_PARTIAL),
    "flex_dkv": ("flex_dkv.cu", "flex_bwd_sm90.cuh", PLANT_DROP_WG1_DK),
    "flex_dq_sparse_stale_resident": ("flex_dq_sparse.cu", "flex_bwd_sm90.cuh",
                                      PLANT_STALE_RESIDENT),
    "flex_dkv_sparse_unzeroed": ("flex_dkv_sparse.cu", "flex_dkv_sparse.cu",
                                 PLANT_KEEP_PARTIALS),
    "paged_decode_drop_last_chunk": ("decode.cu", "decode_sm90.cuh", PLANT_DROP_LAST_CHUNK),
    "paged_decode_member0_q": ("decode.cu", "decode_sm90.cuh", PLANT_MEMBER0_Q),
}

# Variants of the kernels, timed beside them and never launched on a main
# path: the sparse-grid forwards with AMLA's integer reference moved on every
# rise of a row's max (the TPU kernel's rule) instead of only past
# AMLA_MOVE_AT, in mutated copies of flex_fwd_sm90.cuh.
AMLA_EVERY_RISE = [
    ("top > ref[rr] + AMLA_MOVE_AT;", "top > ref[rr];"),
]
VARIANTS = {
    "flex_fwd_sparse_every_rise": ("flex_fwd_sparse.cu", "flex_fwd_sm90.cuh", AMLA_EVERY_RISE),
    "flex_fwd_sparse_hb_every_rise": ("flex_fwd_sparse_hb.cu", "flex_fwd_sm90.cuh",
                                      AMLA_EVERY_RISE),
}

# The row-major backward walk before TMA and wgmma (flex_bwd.cuh's per-item
# bodies, mma.sync, one warpgroup, one (head, block) item per thread block
# on the (blocks, heads) grid), built beside the kernels as the yardstick of
# ``bwd_timing``. Never launched on a main path.
MMA_SYNC_WALK_SOURCE = r"""
#include "flex_bwd.cuh"
using namespace flex;
#define ARGS const bf16 *q, const bf16 *k, const bf16 *v, const bf16 *dout, const float *lse, \
    const float *delta, const int *blk, const int *sid, const int *runs, const int *bounds, \
    const int *rs, const int *rc
#define PASS q, k, v, dout, lse, delta, blk, sid, runs, bounds, rs, rc
template <int D> __global__ void __launch_bounds__(NTHREADS)
dq_walk(ARGS, float *dq, int group, int tqp, int tkp, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  dq_item<D>(PASS, dq, group, tqp, tkp, scale, softcap, blockIdx.y, blockIdx.x, smem);
}
template <int D> __global__ void __launch_bounds__(NTHREADS)
dkv_walk(ARGS, float *dk, float *dv, int group, int tqp, int tkp, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  dkv_item<D>(PASS, dk, dv, group, tqp, tkp, scale, softcap, blockIdx.y, blockIdx.x, smem);
}
template <typename K> cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_dq(ARGS, float *dq, int hq, int hk, int tqp, int tkp, int d, int nq,
                     float scale, float softcap, cudaStream_t st) {
  const dim3 grid(nq, hq);
  cudaError_t err = d == 64 ? prepare(dq_walk<64>, dq_smem<64>())
                            : prepare(dq_walk<128>, dq_smem<128>());
  if (err != cudaSuccess) return err;
  if (d == 64)
    dq_walk<64><<<grid, NTHREADS, dq_smem<64>(), st>>>(PASS, dq, hq / hk, tqp, tkp, scale,
                                                       softcap);
  else
    dq_walk<128><<<grid, NTHREADS, dq_smem<128>(), st>>>(PASS, dq, hq / hk, tqp, tkp, scale,
                                                         softcap);
  return cudaGetLastError();
}
int mma_sync_flex_dkv(ARGS, float *dk, float *dv, int hq, int hk, int tqp, int tkp, int d,
                      int nk, float scale, float softcap, cudaStream_t st) {
  const dim3 grid(nk, hk);
  cudaError_t err = d == 64 ? prepare(dkv_walk<64>, dkv_smem<64>())
                            : prepare(dkv_walk<128>, dkv_smem<128>());
  if (err != cudaSuccess) return err;
  if (d == 64)
    dkv_walk<64><<<grid, NTHREADS, dkv_smem<64>(), st>>>(PASS, dk, dv, hq / hk, tqp, tkp, scale,
                                                         softcap);
  else
    dkv_walk<128><<<grid, NTHREADS, dkv_smem<128>(), st>>>(PASS, dk, dv, hq / hk, tqp, tkp,
                                                           scale, softcap);
  return cudaGetLastError();
}
}
"""

# The row-major forward walk before TMA and wgmma (flex_fwd.cuh's fwd_rows:
# mma.sync, synchronous tile loads), in both launch shapes it had: one q
# head per thread block on the (q blocks, q heads) grid, and head_block q
# heads (a kv head's heads two at a time where G is even) on the (head
# groups, q blocks) grid with the q blocks last first. bf16 out. Built
# beside the kernels as the forward's yardstick; never launched on a main
# path.
MMA_SYNC_FWD_SOURCE = r"""
#include "flex_fwd.cuh"
using namespace flex;
#define ARGS const bf16 *q, const bf16 *k, const bf16 *v, const float *sink, const int *kblk, \
    const int *sid, const int *runs, const int *bounds, const int *rs, const int *rc, bf16 *out, \
    float *lse, float *rowmax
#define PASS q, k, v, sink, kblk, sid, runs, bounds, rs, rc, out, lse, rowmax
template <int D> __global__ void __launch_bounds__(NTHREADS)
fwd_walk(ARGS, int group, int tqp, int tkp, float scale, float softcap, int has_sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  fwd_rows<D, 1, bf16>(PASS, h, h / group, blockIdx.x, tqp, tkp, scale, softcap, has_sink, smem);
}
template <int D, int NH> __global__ void __launch_bounds__(NH * NTHREADS)
fwd_hb_walk(ARGS, int group, int tqp, int tkp, int nq, int head_block, float scale,
            float softcap, int has_sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h_item = blockIdx.x * head_block;
  const int i = nq - 1 - blockIdx.y;
  for (int c = 0; c < head_block; c += NH) {
    if (c > 0) __syncthreads();
    fwd_rows<D, NH, bf16>(PASS, h_item + c, (h_item + c) / group, i, tqp, tkp, scale, softcap,
                          has_sink, smem);
  }
}
template <typename K> cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
#define LAUNCH(KERNEL, SMEM, THREADS, ...)                          \
  do {                                                              \
    cudaError_t err = prepare(KERNEL, SMEM);                        \
    if (err != cudaSuccess) return err;                             \
    KERNEL<<<grid, THREADS, SMEM, st>>>(PASS, __VA_ARGS__);         \
    return cudaGetLastError();                                      \
  } while (0)
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_fwd(ARGS, int hq, int hk, int tqp, int tkp, int d, int nq, float scale,
                      float softcap, int has_sink, cudaStream_t st) {
  const dim3 grid(nq, hq);
  if (d == 64) {
    auto kernel = fwd_walk<64>;
    LAUNCH(kernel, (fwd_smem_bytes<64, 1>()), NTHREADS, hq / hk, tqp, tkp, scale, softcap,
           has_sink);
  }
  auto kernel = fwd_walk<128>;
  LAUNCH(kernel, (fwd_smem_bytes<128, 1>()), NTHREADS, hq / hk, tqp, tkp, scale, softcap,
         has_sink);
}
#define LAUNCH_HB(DIM, NH)                                                                      \
  do {                                                                                         \
    auto kernel = fwd_hb_walk<DIM, NH>;                                                        \
    LAUNCH(kernel, (fwd_smem_bytes<DIM, NH>()), NH * NTHREADS, hq / hk, tqp, tkp, nq,          \
           head_block, scale, softcap, has_sink);                                              \
  } while (0)
int mma_sync_flex_fwd_hb(ARGS, int hq, int hk, int tqp, int tkp, int d, int nq, int head_block,
                         float scale, float softcap, int has_sink, cudaStream_t st) {
  const dim3 grid(hq / head_block, nq);
  const bool pairs = (hq / hk) % 2 == 0;
  if (d == 64 && pairs) LAUNCH_HB(64, 2);
  if (d == 64) LAUNCH_HB(64, 1);
  if (pairs) LAUNCH_HB(128, 2);
  LAUNCH_HB(128, 1);
}
}
"""

# The previous decode walk (decode_simt.cuh at bf16: CUDA cores, one page at
# a time, nothing in flight while the block computes), built beside the
# kernels as the yardstick of ``decode_timing``. Never launched on a main path.
DECODE_SIMT_SOURCE = r"""
#include "decode_simt.cuh"
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int simt_paged_decode(const void *q, const void *kp, const void *vp, const void *bt,
                      const void *sl, void *out, void *lse, int b, int hq, int hk, int d,
                      int ps, int mpp, int splits, float scale, float softcap, cudaStream_t st) {
  if (d == 64)
    return decode_simt::launch<__nv_bfloat16, 64>(q, kp, vp, bt, sl, out, lse, b, hq, hk, ps,
                                                  mpp, splits, 0, scale, softcap, st);
  return decode_simt::launch<__nv_bfloat16, 128>(q, kp, vp, bt, sl, out, lse, b, hq, hk, ps,
                                                 mpp, splits, 0, scale, softcap, st);
}
}
"""


# The sparse-grid backward before TMA and wgmma (flex_bwd.cuh's per-item
# bodies, mma.sync, one warpgroup, in persistent blocks that take one (q
# head, q block) or (kv head, k block) item after another from a work list
# through flex_tile.cuh::next_item's __syncthreads), built beside the
# kernels as the yardstick of the ``hetero`` phase. Never launched on a main
# path.
MMA_SYNC_SPARSE_SOURCE = r"""
#include "flex_bwd.cuh"
using namespace flex;
#define ARGS const bf16 *q, const bf16 *k, const bf16 *v, const bf16 *dout, const float *lse, \
    const float *delta, const int *blk, const int *sid, const int *runs, const int *bounds, \
    const int *rs, const int *rc, const int *work, int *counter
#define PASS q, k, v, dout, lse, delta, blk, sid, runs, bounds, rs, rc
template <int D> __global__ void __launch_bounds__(NTHREADS)
dq_sparse_walk(ARGS, float *dq, int group, int tqp, int tkp, int nq, int n_items, float scale,
               float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  for (int item = next_item(counter, &s_item); item < n_items; item = next_item(counter, &s_item))
    dq_item<D>(PASS, dq, group, tqp, tkp, scale, softcap, work[item] / nq, work[item] % nq, smem);
}
template <int D> __global__ void __launch_bounds__(NTHREADS)
dkv_sparse_walk(ARGS, float *dk, float *dv, int group, int tqp, int tkp, int nk, int n_items,
                float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  for (int item = next_item(counter, &s_item); item < n_items; item = next_item(counter, &s_item))
    dkv_item<D>(PASS, dk, dv, group, tqp, tkp, scale, softcap, work[item] / nk, work[item] % nk,
                smem);
}
#define LAUNCH(KERNEL, SMEM, ...)                                                        \
  do {                                                                                   \
    auto kernel = KERNEL;                                                                \
    int grid = 0;                                                                        \
    cudaError_t err = persistent_launch_dims(kernel, NTHREADS, SMEM, n_items, counter, st, \
                                             grid);                                      \
    if (err != cudaSuccess) return err;                                                  \
    kernel<<<grid, NTHREADS, SMEM, st>>>(PASS, work, counter, __VA_ARGS__);              \
    return cudaGetLastError();                                                           \
  } while (0)
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_dq_sparse(ARGS, float *dq, int hq, int hk, int tqp, int tkp, int d, int nq,
                            int n_items, float scale, float softcap, cudaStream_t st) {
  if (d == 64)
    LAUNCH(dq_sparse_walk<64>, dq_smem<64>(), dq, hq / hk, tqp, tkp, nq, n_items, scale, softcap);
  LAUNCH(dq_sparse_walk<128>, dq_smem<128>(), dq, hq / hk, tqp, tkp, nq, n_items, scale, softcap);
}
int mma_sync_flex_dkv_sparse(ARGS, float *dk, float *dv, int hq, int hk, int tqp, int tkp, int d,
                             int nk, int n_items, float scale, float softcap, cudaStream_t st) {
  if (d == 64)
    LAUNCH(dkv_sparse_walk<64>, dkv_smem<64>(), dk, dv, hq / hk, tqp, tkp, nk, n_items, scale,
           softcap);
  LAUNCH(dkv_sparse_walk<128>, dkv_smem<128>(), dk, dv, hq / hk, tqp, tkp, nk, n_items, scale,
         softcap);
}
}
"""

# The sparse-grid forward before TMA and wgmma (flex_fwd_sparse.cuh:
# mma.sync, synchronous tile loads, persistent blocks of NH x 4 warps taking
# items through flex_tile.cuh::next_item), with the kernels' C signature,
# built beside them as the yardstick of the ``hetero`` phase. Never launched
# on a main path.
MMA_SYNC_FWD_SPARSE_SOURCE = r"""
#include "flex_fwd_sparse.cuh"
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_fwd_sparse(const void *q, const void *k, const void *v, const void *sink,
                             const void *kblk, const void *sid, const void *runs,
                             const void *bounds, const void *rs, const void *rc,
                             const void *work, void *counter, void *out, void *lse, void *rowmax,
                             int hq, int hk, int tqp, int tkp, int head_dim, int nq, int block_q,
                             int block_k, int n_items, int heads_per_item, float scale,
                             float softcap, int has_sink, int out_f32, void *stream) {
  if (hk <= 0 || hq % hk != 0) return cudaErrorInvalidValue;
  if (heads_per_item > 1 && (hq / hk) % 2 == 0)  // a head pair of one kv head at a time
    return flex::dispatch_fwd_sparse<2>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work,
                                        counter, out, lse, rowmax, hq, hk, tqp, tkp, head_dim, nq,
                                        block_q, block_k, n_items, heads_per_item, scale, softcap,
                                        has_sink, out_f32, stream);
  return flex::dispatch_fwd_sparse<1>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work,
                                      counter, out, lse, rowmax, hq, hk, tqp, tkp, head_dim, nq,
                                      block_q, block_k, n_items, heads_per_item, scale, softcap,
                                      has_sink, out_f32, stream);
}
}
"""

# the previous walks, yardsticks built beside the kernels
YARDSTICKS = {"mma_sync_walk": MMA_SYNC_WALK_SOURCE, "mma_sync_fwd": MMA_SYNC_FWD_SOURCE,
              "mma_sync_sparse": MMA_SYNC_SPARSE_SOURCE,
              "mma_sync_fwd_sparse": MMA_SYNC_FWD_SPARSE_SOURCE,
              "decode_simt": DECODE_SIMT_SOURCE}


def start_planted_build(names=None):
    """nvcc of each mutated build of ``PLANTED`` and ``VARIANTS`` and each
    yardstick of ``YARDSTICKS`` (default: all), each in a directory of its
    own under ``csrc/build/planted/``, started now and collected by
    :func:`planted_libraries`. Nothing of it is counted as a main-path
    launch."""
    import shutil as sh

    from magiattention_tpu_torch import csrc

    names = [*PLANTED, *VARIANTS, *YARDSTICKS] if names is None else list(names)
    procs = {}
    for name in names:
        out_dir = os.path.join(csrc.BUILD_DIR, "planted", name)
        os.makedirs(out_dir, exist_ok=True)
        for f in os.listdir(csrc._DIR):
            if f.endswith((".cu", ".cuh")):
                sh.copyfile(os.path.join(csrc._DIR, f), os.path.join(out_dir, f))
        if name in YARDSTICKS:
            source = f"{name}.cu"
            with open(os.path.join(out_dir, source), "w") as f:
                f.write(YARDSTICKS[name])
        else:
            source, mutated, plants = {**PLANTED, **VARIANTS}[name]
            with open(os.path.join(csrc._DIR, mutated)) as f:
                src = f.read()
            for old, new in plants:
                check(src.count(old) == 1,
                      f"planted fault: {old.strip()!r} is not in {mutated} once")
                src = src.replace(old, new)
            with open(os.path.join(out_dir, mutated), "w") as f:
                f.write(src)
        lib = os.path.join(out_dir, f"lib{name}_planted.so")
        cmd = [csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", lib, os.path.join(out_dir, source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    return procs


def planted_libraries(procs) -> dict:
    import ctypes

    from magiattention_tpu_torch import csrc

    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"planted {name} did not build:\n{log}")
        lib = ctypes.CDLL(path)
        if name == "mma_sync_walk":
            # q k v dout lse delta | 6 tables | outputs | 6 ints | scale softcap stream
            for fn, outs in ((lib.mma_sync_flex_dq, 1), (lib.mma_sync_flex_dkv, 2)):
                fn.argtypes, fn.restype = [P] * 12 + [P] * outs + [I] * 6 + [F, F, P], ctypes.c_int
        elif name == "mma_sync_sparse":
            # q k v dout lse delta | 6 tables | work counter | outputs | 7 ints | scale softcap stream
            for fn, outs in ((lib.mma_sync_flex_dq_sparse, 1), (lib.mma_sync_flex_dkv_sparse, 2)):
                fn.argtypes = [P] * 12 + [P] * 2 + [P] * outs + [I] * 7 + [F, F, P]
                fn.restype = ctypes.c_int
        elif name == "decode_simt":
            # q k v bt sl | out lse | b hq hk d ps mpp splits | scale softcap stream
            fn = lib.simt_paged_decode
            fn.argtypes, fn.restype = [P] * 7 + [I] * 7 + [F, F, P], ctypes.c_int
        elif name == "mma_sync_fwd_sparse":  # the sparse forwards' C signature
            fn = lib.mma_sync_flex_fwd_sparse
            fn.argtypes, fn.restype = csrc.KERNELS["flex_fwd_sparse"].argtypes, ctypes.c_int
        elif name == "mma_sync_fwd":
            # q k v sink | 6 tables | out lse rowmax | 6 (7) ints | scale softcap has_sink stream
            for fn, ints in ((lib.mma_sync_flex_fwd, 6), (lib.mma_sync_flex_fwd_hb, 7)):
                fn.argtypes, fn.restype = [P] * 13 + [I] * ints + [F, F, I, P], ctypes.c_int
        else:
            source = {**PLANTED, **VARIANTS}[name][0]
            kernel = next(k for k in csrc.KERNELS.values() if k.source == source)
            fn = getattr(lib, kernel.entry)
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        lib.magi_error_string.argtypes = [ctypes.c_int]
        lib.magi_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sparse_planted_faults(gen, p, planted) -> dict:
    """The checks on faults planted in each sparse-grid kernel: the AMLA
    rescale of O skipped once per row (both forwards, through the mutated
    builds, at p's widths on causal 4096 with rising logits, so that the
    reference moves), and on problem ``p`` the last entry of each q-major
    walk skipped
    (``flex_dq_sparse``), the last entry of each k-major walk skipped
    (``flex_dkv_sparse``), and two faults of the persistent pipeline in
    mutated builds: each dq item after a block's first reusing the previous
    item's resident Q and dO, and the dK/dV partials not zeroed between a
    block's items. Returns which checks catch each; a fault that passes them
    all fails the smoke."""
    import torch

    def skip_last(tab):
        return (*tab[:6], (tab[6] - 1).clamp_min(0).contiguous())

    caught = {}
    hq, hk = p.q.shape[0], p.k.shape[0]
    rising = Flex(gen, 4096, 4096, hq, hk, [(0, 4096)], [(0, 4096)], [1], k_ramp=RISING_K)
    for name in ("flex_fwd_sparse", "flex_fwd_sparse_hb"):
        rising.set_head_block(hq // hk if name.endswith("_hb") else 1)
        got = with_library(name, planted[name], rising.sparse_kernel)()
        torch.cuda.synchronize()
        out, ref_out, pairs = rising.sparse_fwd_pairs(got)
        errs, failed = out_errors(out, ref_out, pairs)
        caught[f"skip_rescale_once_per_row:{name}"] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault in {name} passes the forward checks: {errs}")
    tq, tk = p.tq, p.tk
    ref_dq = p.dq_plain()[:, :tq]
    ref_dk, ref_dv = (x[:, :tk] for x in p.dkv_plain())
    dq = p.dq_sparse_kernel(skip_last(p.tables))
    dk, dv = p.dkv_sparse_kernel(skip_last(p.btables))
    dq_stale = with_library("flex_dq_sparse", planted["flex_dq_sparse_stale_resident"],
                            p.dq_sparse_kernel)()
    dk_kept, dv_kept = with_library("flex_dkv_sparse", planted["flex_dkv_sparse_unzeroed"],
                                    p.dkv_sparse_kernel)()
    torch.cuda.synchronize()
    for plant, what, got, ref in (("skip_last_q_walk_entry:flex_dq_sparse", "dq", dq[:, :tq], ref_dq),
                                  ("skip_last_k_walk_entry:flex_dkv_sparse", "dk", dk[:, :tk], ref_dk),
                                  ("skip_last_k_walk_entry:flex_dkv_sparse", "dv", dv[:, :tk], ref_dv),
                                  ("previous_item_resident_tiles:flex_dq_sparse", "dq",
                                   dq_stale[:, :tq], ref_dq),
                                  ("partials_not_zeroed_between_items:flex_dkv_sparse", "dk",
                                   dk_kept[:, :tk], ref_dk),
                                  ("partials_not_zeroed_between_items:flex_dkv_sparse", "dv",
                                   dv_kept[:, :tk], ref_dv)):
        errs, failed = grad_errors(got, ref)
        caught[f"{plant}:{what}"] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {plant} passes the {what} checks: {errs}")
    return caught


def flex_cases(gen) -> None:
    """``flex_fwd`` and the backward at head_dim 128 and 64 with 4, 2 and 1
    q heads per kv head (a head pair per block at G 4 and 2, one head with
    its walk split between the two consumer warpgroups at G 1), and
    ``flex_fwd`` with its out in float32."""
    C, F, I, B = 1, 0, 2, 3
    hq = 8
    cases = [
        ("flex_causal_whole", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("flex_varlen_causal", 2000, 2000, [(0, 700), (700, 1500), (1500, 2000)],
         [(0, 700), (700, 1500), (1500, 2000)], [C, C, C], {"softcap": 30.0}),
        ("flex_full", 512, 768, [(0, 512)], [(0, 768)], [F], {}),
        ("flex_invcausal", 768, 768, [(0, 768)], [(0, 768)], [I], {}),
        ("flex_bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
        ("flex_continuation", 512, 2560, [(0, 512)], [(0, 2560)], [C], {}),
        ("flex_uncovered_rows_sink", 1000, 1000, [(0, 600)], [(0, 600)], [C],
         {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("flex_uncovered_rows", 1000, 1000, [(100, 600)], [(0, 500)], [F], {}),
    ]
    import torch

    for name, tq, tk, qr, kr, ty, kw in cases:
        p = Flex(gen, tq, tk, hq, 2, qr, kr, ty, **kw)
        p.check(name)
        p.check_bwd(f"{name}_bwd_g4")
        for d, g in ((128, 4), (64, 1)):  # out in float32
            Flex(gen, tq, tk, hq, hq // g, qr, kr, ty, d=d, out_dtype=torch.float32,
                 **kw).check(f"{name}_g{g}_d{d}_f32_out")
        for d, g in ((128, 2), (128, 1), (64, 4), (64, 2), (64, 1)):
            pg = Flex(gen, tq, tk, hq, hq // g, qr, kr, ty, d=d, **kw)
            pg.check(f"{name}_g{g}_d{d}")
            pg.check_bwd(f"{name}_bwd_g{g}_d{d}")


def fwd_planted_faults(gen, planted) -> dict:
    """The forward checks on two faults planted in mutated builds of the
    forward walk: every head of a ``flex_fwd_hb`` item on the first head's
    kv head (a causal 2048 case at G = 2 whose head_block 4 spans two kv
    heads), and, at G = 1, the second consumer warpgroup's partial dropped
    from the merge of ``flex_fwd`` (causal 2048 at 8 / 8 heads). Returns
    which checks catch each; a fault that passes them fails the smoke."""
    import torch

    caught = {}
    p = Flex(gen, 2048, 2048, 8, 4, [(0, 2048)], [(0, 2048)], [1])
    p1 = Flex(gen, 2048, 2048, 8, 8, [(0, 2048)], [(0, 2048)], [1])
    for plant, q, got in (
        ("first_kv_head_for_every_head:flex_fwd_hb", p,
         with_library("flex_fwd_hb", planted["flex_fwd_hb"], lambda: p.hb_kernel(4))()),
        ("drop_second_warpgroup_partial:flex_fwd", p1,
         with_library("flex_fwd", planted["flex_fwd_drop_partial"], p1.kernel)()),
    ):
        torch.cuda.synchronize()
        errs, failed = q.hb_errors(got)
        caught[plant] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {plant} passes the forward checks: {errs}")
    return caught


def hb_cases(gen) -> dict:
    """``flex_fwd_hb`` against the plain forward on the mask families of
    ``flex_cases`` (softcap on one, sink on another) at 8 q heads with G
    q heads per kv head, G in {1, 2, 4}, head_block G and 2G (2 at G = 1:
    an item of two kv heads), d 128 and 64. Returns how many cases equal
    ``flex_fwd`` bit for bit."""
    C, F, I, B = 1, 0, 2, 3
    cases = [
        ("hb_causal_whole", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("hb_varlen_causal_softcap", 2000, 2000, [(0, 700), (700, 1500), (1500, 2000)],
         [(0, 700), (700, 1500), (1500, 2000)], [C, C, C], {"softcap": 30.0}),
        ("hb_full", 512, 768, [(0, 512)], [(0, 768)], [F], {}),
        ("hb_invcausal", 768, 768, [(0, 768)], [(0, 768)], [I], {}),
        ("hb_bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
        ("hb_continuation", 512, 2560, [(0, 512)], [(0, 2560)], [C], {}),
        ("hb_uncovered_rows_sink", 1000, 1000, [(0, 600)], [(0, 600)], [C],
         {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("hb_uncovered_rows", 1000, 1000, [(100, 600)], [(0, 500)], [F], {}),
    ]
    equal, differ = 0, []
    for name, tq, tk, qr, kr, ty, kw in cases:
        for g in (1, 2, 4):
            for d in (128, 64):
                p = Flex(gen, tq, tk, 8, 8 // g, qr, kr, ty, d=d, **kw)
                for hb in ((2,) if g == 1 else (g, 2 * g)):
                    case = f"{name}_g{g}_d{d}"
                    if p.check_hb(case, hb):
                        equal += 1
                    else:
                        differ.append(f"{case}_hb{hb}")
    return {"cases": equal + len(differ), "bitwise_equal_to_flex_fwd": equal,
            "differ_from_flex_fwd": differ}


def sparse_cases(gen) -> None:
    """The sparse-grid kernels against their plain versions: every mask
    family with 4 q heads per kv head at d 128 (a work item of G heads,
    packed two at a time, and of one head), and the heterogeneous masks
    also at G 2 / d 64 and G 1 / d 128 (a work item of two kv heads)."""
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    C, F, I, B = 1, 0, 2, 3
    hetero = [
        ("sparse_varlen_block_causal", 4096, 4096, *split_slices(varlen_block_causal(4096)), {}),
        ("sparse_shared_question", 4096, 4096, *split_slices(shared_question_q_overlap(4096)),
         {}),
    ]
    cases = [
        ("sparse_causal_whole", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("sparse_varlen_causal_softcap_sink", 2000, 2000,
         [(0, 700), (700, 1500), (1500, 2000)], [(0, 700), (700, 1500), (1500, 2000)],
         [C, C, C], {"softcap": 30.0, "sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("sparse_full", 512, 768, [(0, 512)], [(0, 768)], [F], {}),
        ("sparse_invcausal", 768, 768, [(0, 768)], [(0, 768)], [I], {}),
        ("sparse_bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
        ("sparse_uncovered_rows", 1000, 1000, [(100, 600)], [(0, 500)], [F], {}),
        *hetero,
    ]
    for name, tq, tk, qr, kr, ty, kw in cases:
        for hb in (4, 1):
            Flex(gen, tq, tk, 8, 2, qr, kr, ty, head_block=hb, **kw).check_sparse(
                f"{name}_g4_hb{hb}")
    for name, tq, tk, qr, kr, ty, kw in hetero:
        Flex(gen, tq, tk, 4, 2, qr, kr, ty, d=64, **kw).check_sparse(f"{name}_g2_d64_hb2")
        Flex(gen, tq, tk, 4, 4, qr, kr, ty, head_block=2, **kw).check_sparse(
            f"{name}_g1_hb2")


SPARSE_BWD_GROUPS = (1, 2, 3, 4, 8)  # q heads per kv head of the sparse backward cases
SHORT_DOCS = (64, 128, 64, 192, 128, 64, 64, 128)  # the short-walk mask's document lengths


def short_walk_docs(t):
    """Documents of ``SHORT_DOCS`` tokens in turn (whole tiles), packed back
    to back over t tokens, each causal over itself: each q (and k) block
    walks one to three tiles, most one or two, so a work list of many short
    items."""
    bounds, a, j = [], 0, 0
    while a < t:
        b = min(t, a + SHORT_DOCS[j % len(SHORT_DOCS)])
        bounds.append((a, b))
        a, j = b, j + 1
    return bounds, bounds, [1] * len(bounds)


def sparse_bwd_cases(gen) -> dict:
    """``flex_dq_sparse`` and ``flex_dkv_sparse`` against the plain backward
    at d 128 and 64 and G 1, 2, 3, 4 and 8 (2 kv heads) on the two
    heterogeneous masks and the short-walk one, plus softcap on one case
    and uncovered rows on another: each kernel twice for the same bits, and
    against ``flex_dq`` / ``flex_dkv`` on the same inputs and tables, which
    they must equal bit for bit (the same per-item walk in the same order).
    Returns the line's summary, with the short-walk mask's walk lengths."""
    import numpy as np
    import torch
    from magiattention_tpu_torch.ops.block_sparse import row_tables
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    masks = [
        ("varlen_block_causal", 4096, *split_slices(varlen_block_causal(4096))),
        ("shared_question", 4096, *split_slices(shared_question_q_overlap(4096))),
        ("short_walks", 4096, *short_walk_docs(4096)),
    ]
    cases = [(f"{m}_g{g}_d{d}", t, qr, kr, ty, g, d, {})
             for m, t, qr, kr, ty in masks for d in (128, 64) for g in SPARSE_BWD_GROUPS]
    cases += [("varlen_block_causal_softcap_g4_d128", *masks[0][1:], 4, 128, {"softcap": 30.0}),
              ("uncovered_rows_g3_d64", 1000, [(100, 600)], [(0, 500)], [0], 3, 64, {})]
    walks = {}
    for name, t, qr, kr, ty, g, d, kw in cases:
        p = Flex(gen, t, t, 2 * g, 2, qr, kr, ty, d=d, **kw)
        if name.startswith("short_walks") and not walks:
            for side, major, nb in (("q", p.meta.fwd_q_block, p.meta.num_q_blocks),
                                    ("k", p.meta.bwd_k_block, p.meta.num_k_blocks)):
                rc = row_tables(major, nb)[1]
                walks[side] = {"blocks": int(nb), "median": float(np.median(rc)),
                               "max": int(rc.max()), "share_one_or_two": float((rc <= 2).mean())}
        dq, (dk, dv) = p.dq_sparse_kernel(), p.dkv_sparse_kernel()
        torch.cuda.synchronize()
        dq2, (dk2, dv2) = p.dq_sparse_kernel(), p.dkv_sparse_kernel()
        check(torch.equal(dq, dq2), f"{name}: flex_dq_sparse differs between two runs")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{name}: flex_dkv_sparse differs between two runs")
        rm_dq, (rm_dk, rm_dv) = p.dq_kernel(), p.dkv_kernel()
        check(torch.equal(dq, rm_dq), f"{name}: flex_dq_sparse differs from flex_dq")
        check(torch.equal(dk, rm_dk) and torch.equal(dv, rm_dv),
              f"{name}: flex_dkv_sparse differs from flex_dkv")
        compare_grads("flex_dq_sparse", f"sparse_bwd_{name}",
                      [("dq", dq[:, :t], p.dq_plain()[:, :t])])
        ref_dk, ref_dv = p.dkv_plain()
        compare_grads("flex_dkv_sparse", f"sparse_bwd_{name}",
                      [("dk", dk[:, :t], ref_dk[:, :t]), ("dv", dv[:, :t], ref_dv[:, :t])])
    return {"phase": "kernels", "kernel": "flex_dq_sparse+flex_dkv_sparse", "cases": len(cases),
            "twice_bitwise_equal": len(cases), "bitwise_equal_to_row_major": len(cases),
            "short_walks": walks}


RISING_K = 12.0  # the rising-logits cases' last key scale: late tiles pass a row's reference


def sparse_fwd_cases(gen) -> dict:
    """``flex_fwd_sparse`` (head_block 1) and ``flex_fwd_sparse_hb``
    (head_block G; 2 at G = 1, an item of two kv heads) against the plain
    sparse forward at d 128 and 64 and G 1, 2, 3, 4 and 8 (2 kv heads) on
    the two heterogeneous masks, the short-walk one and a causal one whose
    keys grow along the sequence (so that AMLA's reference moves and O's
    exponent-add rescale runs), plus softcap and sink on one case and
    uncovered rows on another: each kernel twice for the same bits. Returns
    the line's summary."""
    import torch
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    vbc = split_slices(varlen_block_causal(4096))
    masks = [
        ("varlen_block_causal", 4096, *vbc, {}),
        ("shared_question", 4096, *split_slices(shared_question_q_overlap(4096)), {}),
        ("short_walks", 4096, *short_walk_docs(4096), {}),
        ("rising_logits_causal", 2048, [(0, 2048)], [(0, 2048)], [1], {"k_ramp": RISING_K}),
    ]
    cases = [(f"{m}_g{g}_d{d}", t, qr, kr, ty, g, d, kw)
             for m, t, qr, kr, ty, kw in masks for d in (128, 64) for g in SPARSE_BWD_GROUPS]
    cases += [("varlen_block_causal_softcap_sink_g4_d128", 4096, *vbc, 4, 128,
               {"softcap": 30.0, "sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
              ("uncovered_rows_g3_d64", 1000, [(100, 600)], [(0, 500)], [0], 3, 64, {})]
    n = 0
    for name, t, qr, kr, ty, g, d, kw in cases:
        p = Flex(gen, t, t, 2 * g, 2, qr, kr, ty, d=d, **kw)
        for hb in (1, max(g, 2)):
            p.set_head_block(hb)
            got = p.sparse_kernel()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, p.sparse_kernel())),
                  f"{name}: {p.fwd_sparse_name} differs between two runs")
            out, ref_out, pairs = p.sparse_fwd_pairs(got)
            compare(p.fwd_sparse_name, f"sparse_fwd_{name}_hb{hb}", out, ref_out,
                    extra={k: (x, y) for k, x, y in pairs})
            n += 1
    return {"phase": "kernels", "kernel": "flex_fwd_sparse+flex_fwd_sparse_hb", "cases": n,
            "twice_bitwise_equal": n}


def mma_sync_fwd(lib, p, head_block=None):
    """A launcher of the previous forward walk (the ``mma_sync_fwd`` side
    library) on ``p``'s inputs, in ``flex_fwd``'s launch shape or, with a
    ``head_block``, ``flex_fwd_hb``'s; checked once against the plain
    forward. A yardstick only: nothing here is counted as a launch."""
    import torch

    q, k, v = p.q, p.k, p.v
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    out = torch.empty((hq, tqp, d), dtype=torch.bfloat16, device="cuda")
    lse, rowmax = (torch.empty((hq, tqp), device="cuda") for _ in range(2))
    ptrs = [x.data_ptr() for x in (q, k, v, p.sink, *p.tables[1:7], out, lse, rowmax)]
    shape = [hq, hk, tqp, tkp, d, tqp // BLOCK] + ([] if head_block is None else [head_block])
    fn = lib.mma_sync_flex_fwd if head_block is None else lib.mma_sync_flex_fwd_hb
    prm = p.params

    def run():
        code = fn(*ptrs, *shape, prm.scale, prm.softcap, int(prm.has_sink),
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous forward walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    _, failed = p.hb_errors((out, lse, rowmax))
    check(not failed, f"the previous forward walk fails the {failed} check(s)")
    return run


def fwd_in_turns(p, planted, g, reps) -> dict:
    """``flex_fwd`` and ``flex_fwd_hb`` at head_block ``g`` (and 2g where
    given) on problem ``p``, each timed in turns with the previous walk in
    the same launch shape (new, old, old, new). Returns the samples and the
    means under ``name`` and ``previous:name``."""
    old = planted["mma_sync_fwd"]
    runs = {"flex_fwd": (p.kernel, mma_sync_fwd(old, p))}
    for hb in g:
        runs[f"hb{hb}"] = (lambda hb=hb: p.hb_kernel(hb), mma_sync_fwd(old, p, hb))
    samples = {}
    for name, (new, prev) in runs.items():
        for which, fn in (("", new), ("previous:", prev), ("previous:", prev), ("", new)):
            samples.setdefault(which + name, []).append(cuda_ms(fn, reps=reps))
    return {"samples": samples, "ms": {n: sum(x) / len(x) for n, x in samples.items()}}


def fwd_bound(p, t, hq, hk) -> tuple[float, str]:
    """The forward's bound on a t-token problem: 4 d FLOPs per unmasked
    pair and q head; q, k, v read and out, lse written once."""
    flops = 4.0 * p.meta.total_area * D * hq
    nbytes = 2 * (2 * t * hq * D + 2 * t * hk * D) + 4 * 2 * t * hq
    return bound(flops, nbytes)


def flex_timing(gen, t: int, planted) -> dict:
    """The serving prefill's forward on one causal prompt at the serving
    widths: ``flex_fwd`` (head_block 1) and ``flex_fwd_hb`` at head_block G
    and 2G, each checked at this shape first and timed in turns with the
    previous walk in its launch shape; the plain version, SDPA and the
    card's bound for that work. Returns one timing record per kernel
    (``flex_fwd_hb`` at G, the automatic choice) and the 2G times."""
    import torch.nn.functional as Fn

    p = Flex(gen, t, t, HQ, HK, [(0, t)], [(0, t)], [1])
    g = HQ // HK
    p.check(f"flex_causal_{t}_serving_widths")
    bitwise = {hb: p.check_hb(f"flex_causal_{t}_serving_widths", hb) for hb in (g, 2 * g)}
    turns = fwd_in_turns(p, planted, (g, 2 * g), reps=20)
    ms = turns["ms"]
    plain_ms = cuda_ms(p.plain, reps=3, warmup=1)
    q = p.q[:, :t].unsqueeze(0)
    k = p.k[:, :t].unsqueeze(0)
    v = p.v[:, :t].unsqueeze(0)
    lib_ms = cuda_ms(
        lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        reps=20,
    )
    bound_ms, bound_by = fwd_bound(p, t, HQ, HK)
    names = {"flex_fwd": "flex_fwd", "flex_fwd_hb": f"hb{g}", "flex_fwd_hb_2g": f"hb{2 * g}"}

    def record(kernel_ms):
        return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms}

    emit({"phase": "fwd_timing", "tokens": t, "hq": HQ, "hk": HK, "card": nvidia_smi_line(),
          "ms_in_turns": turns["samples"], "ms": ms, "plain_ms": plain_ms, "sdpa_ms": lib_ms,
          "bound_ms": bound_ms, "bitwise_equal_to_flex_fwd": bitwise,
          "previous_walk_ms": {k: ms[f"previous:{n}"] for k, n in names.items()},
          "speedup_over_previous_walk": {k: ms[f"previous:{n}"] / ms[n]
                                         for k, n in names.items()},
          "share_of_bound": {k: bound_ms / ms[n] for k, n in names.items()}})
    return {"flex_fwd": record(ms["flex_fwd"]), "flex_fwd_hb": record(ms[f"hb{g}"]),
            "flex_fwd_hb_2g_ms": ms[f"hb{2 * g}"]}


def mma_sync_walk(lib, p):
    """Launchers of the previous backward walk (the ``mma_sync_walk`` side
    library) on ``p``'s backward inputs, checked once against the plain
    backward. A yardstick only: nothing here is counted as a launch."""
    import torch

    q, k, v, do, lse, delta = p.bwd_inputs()
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    f32 = dict(dtype=torch.float32, device="cuda")
    dq, dk, dv = torch.empty((hq, tqp, d), **f32), *(torch.empty((hk, tkp, d), **f32)
                                                     for _ in range(2))
    head = [x.data_ptr() for x in (q, k, v, do, lse, delta)]

    def run(fn, tables, outs, blocks):
        code = fn(*head, *(x.data_ptr() for x in tables[1:7]), *(o.data_ptr() for o in outs),
                  hq, hk, tqp, tkp, d, blocks, p.params.scale, p.params.softcap,
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous backward walk: CUDA error {code}")

    def run_dq():
        run(lib.mma_sync_flex_dq, p.tables, (dq,), tqp // BLOCK)

    def run_dkv():
        run(lib.mma_sync_flex_dkv, p.btables, (dk, dv), tkp // BLOCK)

    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    ref_dk, ref_dv = p.dkv_plain()
    for what, got, ref, t in (("dq", dq, p.dq_plain(), p.tq), ("dk", dk, ref_dk, p.tk),
                              ("dv", dv, ref_dv, p.tk)):
        _, failed = grad_errors(got[:, :t], ref[:, :t])
        check(not failed, f"the previous backward walk's {what} fails the {failed} check(s)")
    return run_dq, run_dkv


def bwd_timing(gen, t: int, planted) -> dict:
    """Both backward kernels and their plain versions on one causal
    sequence at the training widths, each kernel's bound from its own work,
    each kernel timed in turns with the previous walk on the same problem
    (new, old, old, new), and the backward of PyTorch's
    ``scaled_dot_product_attention`` on the same problem (fwd+bwd minus fwd)
    as a yardstick for the pair."""
    import torch
    import torch.nn.functional as Fn

    hq, hk = TRAIN_HQ, TRAIN_HK
    p = Flex(gen, t, t, hq, hk, [(0, t)], [(0, t)], [1])
    p.check_bwd(f"flex_bwd_causal_{t}_training_widths")
    p.check(f"flex_causal_{t}_training_widths")
    p.check_hb(f"flex_causal_{t}_training_widths", hq // hk)
    emit({"phase": "planted_faults", "case": f"flex_bwd_causal_{t}_training_widths",
          "caught": p.planted_faults(planted)})
    emit({"phase": "planted_faults", "case": f"sparse_grid_causal_{t}_training_widths",
          "caught": sparse_planted_faults(gen, p, planted)})
    old_dq, old_dkv = mma_sync_walk(planted["mma_sync_walk"], p)
    runs = {"flex_dq": p.dq_kernel, "mma_sync_dq": old_dq,
            "flex_dkv": p.dkv_kernel, "mma_sync_dkv": old_dkv}
    samples = {name: [] for name in runs}
    for new, old in (("flex_dq", "mma_sync_dq"), ("flex_dkv", "mma_sync_dkv")):
        for name in (new, old, old, new):
            samples[name].append(cuda_ms(runs[name], reps=10))
    ms = {name: sum(x) / len(x) for name, x in samples.items()}
    dq_ms, dkv_ms = ms["flex_dq"], ms["flex_dkv"]
    dq_plain_ms = cuda_ms(p.dq_plain, reps=2, warmup=1)
    dkv_plain_ms = cuda_ms(p.dkv_plain, reps=2, warmup=1)
    q, k, v = (x[:, :t].unsqueeze(0).detach().requires_grad_() for x in (p.q, p.k, p.v))
    do = p.do[:, :t].unsqueeze(0)

    def fwd():
        return Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), do)

    g = hq // hk
    # the trainer's forward is flex_fwd_hb at head_block G
    turns = fwd_in_turns(p, planted, (g,), reps=10)
    fwd_ms, hb_ms = turns["ms"]["flex_fwd"], turns["ms"][f"hb{g}"]
    fwd_b = fwd_bound(p, t, hq, hk)[0]
    sdpa_fwd_ms = cuda_ms(fwd, reps=10)
    sdpa_bwd_ms = cuda_ms(fwd_bwd, reps=10) - sdpa_fwd_ms
    area = p.meta.total_area
    in_bytes = 2 * (2 * t * hq * D + 2 * t * hk * D) + 4 * 2 * t * hq  # q, do, k, v; lse, delta
    dq_bound = bound(6.0 * area * D * hq, in_bytes + 4 * t * hq * D)
    dkv_bound = bound(8.0 * area * D * hq, in_bytes + 4 * 2 * t * hk * D)
    return {
        "tokens": t, "hq": hq, "hk": hk, "area": area, "card": nvidia_smi_line(),
        "ms_in_turns": samples,
        "previous_walk_ms": {"flex_dq": ms["mma_sync_dq"], "flex_dkv": ms["mma_sync_dkv"]},
        "speedup_over_previous_walk": {"flex_dq": ms["mma_sync_dq"] / dq_ms,
                                       "flex_dkv": ms["mma_sync_dkv"] / dkv_ms},
        "share_of_bound": {"flex_dq": dq_bound[0] / dq_ms, "flex_dkv": dkv_bound[0] / dkv_ms},
        "flex_dq": {"ms": dq_ms, "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
                    "bound_by": dq_bound[1], "library_ms": sdpa_bwd_ms},
        "flex_dkv": {"ms": dkv_ms, "plain_ms": dkv_plain_ms, "bound_ms": dkv_bound[0],
                     "bound_by": dkv_bound[1], "library_ms": None},
        "sdpa_bwd_ms_for_the_pair": sdpa_bwd_ms,
        "flex_fwd_ms_same_problem": fwd_ms,
        f"flex_fwd_hb_head_block_{g}_ms_same_problem": hb_ms,
        "sdpa_fwd_ms_same_problem": sdpa_fwd_ms,
        "fwd_ms_in_turns": turns["samples"],
        "fwd_bound_ms": fwd_b,
        "fwd_previous_walk_ms": {"flex_fwd": turns["ms"]["previous:flex_fwd"],
                                 "flex_fwd_hb": turns["ms"][f"previous:hb{g}"]},
        "fwd_speedup_over_previous_walk": {
            "flex_fwd": turns["ms"]["previous:flex_fwd"] / fwd_ms,
            "flex_fwd_hb": turns["ms"][f"previous:hb{g}"] / hb_ms},
        "fwd_share_of_bound": {"flex_fwd": fwd_b / fwd_ms, "flex_fwd_hb": fwd_b / hb_ms},
    }


# -- paged decode: kernel vs plain ------------------------------------------

DECODE_MPP = 48  # the kernel cases' table width: divisible by every split count below
DECODE_SPLITS = (1, 3, 4, 16)
DECODE_SHARED_PAGES = 12  # the shared-mode cases' prefix pages: divisible by 1, 3 and 4
DECODE_SWEEP = (1, 2, 4, 8, 16)


def decode_cache(gen, lengths, mpp=64):
    """A bf16 cache at the serving widths holding one random sequence per
    slot, every slot owning max_pages_per_seq pages (page 0 unused)."""
    import torch
    from magiattention_tpu_torch.serving import (
        assign_block_table, make_paged_kv_cache, write_prefill_kv,
    )

    cache = make_paged_kv_cache(len(lengths) * mpp + 1, PAGE, HK, D,
                                max_seqs=len(lengths), max_pages_per_seq=mpp)
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, list(range(1 + slot * mpp, 1 + (slot + 1) * mpp)))
        kv = torch.randn((2, n, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    return cache


def decode_problem(gen, d, dtype, hq, hk, ps, lengths):
    """A ``dtype`` cache holding one random sequence per slot on a random
    permutation of the pool's pages (page 0 unused), DECODE_MPP pages a
    slot, and a random query per slot."""
    import torch
    from magiattention_tpu_torch.serving import (
        assign_block_table, make_paged_kv_cache, write_prefill_kv,
    )

    b = len(lengths)
    cache = make_paged_kv_cache(b * DECODE_MPP + 1, ps, hk, d, max_seqs=b,
                                max_pages_per_seq=DECODE_MPP, dtype=dtype)
    pages = (torch.randperm(b * DECODE_MPP, generator=gen, device="cuda") + 1).tolist()
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, pages[slot * DECODE_MPP:(slot + 1) * DECODE_MPP])
        kv = torch.randn((2, n, hk, d), generator=gen, device="cuda").to(dtype)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    return cache, q


def decode_parts(q, cache, bt, sl, splits, softcap=0.0, shared=False):
    """The kernel's per-split partials (out_parts, lse_parts), one launch."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da

    params = da.DecodeParams(1.0 / math.sqrt(q.shape[2]), softcap, splits, torch.float32)
    return da._decode_partials_kernel(q, cache, bt, sl, params, shared=shared)


def bitwise(a, b) -> bool:
    """Each tensor of ``a`` equal, bit for bit, to its partner in ``b``."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def nan_past_lengths(cache, lengths):
    """A copy of ``cache`` whose every position past a slot's length in the
    slot's own pages (the rest of its last page, and the pages after it)
    holds NaN in K and V."""
    import torch

    dirty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                v_pages=cache.v_pages.clone())
    ps = cache.page_size
    for slot, n in enumerate(lengths):
        pos = torch.arange(n, cache.max_pages_per_seq * ps, device="cuda")
        page = cache.block_tables[slot].long()[pos // ps]
        dirty.k_pages[page, pos % ps] = float("nan")
        dirty.v_pages[page, pos % ps] = float("nan")
    return dirty


def decode_cases(gen) -> dict:
    """``paged_decode`` against its plain version (``decode_reference``, one
    f32 split) on the card. The serving widths on ragged lengths through the
    public entry; then d 128 / 64, bf16 / f32, G 1, 2, 4, 8 (and 16 at
    bf16), pages of 16, 64 and 128 tokens, 1, 3, 4 and 16 splits, softcap on
    one case, ragged and zero lengths on shuffled pages, each launch run
    twice for the same bits; positions past each length set to NaN in a
    copy of the cache (same bits as on the clean cache); and the shared mode
    (the cascade's level 1) at 1, 3 and 8 members, against the plain
    version and the flat mode over the broadcast table. Returns the summary
    line."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_attn_paged, decode_reference

    lengths = [0, 1, PAGE, PAGE + 1, 1000, 4096, 4097, 8000]
    cache = decode_cache(gen, lengths)
    b = len(lengths)
    slots = torch.arange(b, device="cuda")
    q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    ref_out, ref_lse = decode_reference(q, cache, cache.block_tables, cache.seq_lens)
    for splits in (1, 4):
        out, lse = decode_attn_paged(q, cache, slots, num_splits=splits, out_dtype=torch.float32)
        torch.cuda.synchronize()
        check(bool((out[0] == 0).all()), "decode: zero-length slot out is not 0")
        compare("paged_decode", f"decode_ragged_splits{splits}", out, ref_out, lse, ref_lse)

    worst = {"out_max_abs_err": 0.0, "lse_max_abs_err": 0.0}
    shared_vs_flat = dict(worst)
    counts = {"flat": 0, "shared": 0, "nan_tail": 0}

    def held(name, parts, ref):
        out, lse = da._merge_splits(*parts)
        errs, failed = out_errors(out, ref[0], [("lse", lse, ref[1])])
        check(not failed, f"{name}: paged_decode fails the {failed} check(s): {errs}")
        for k in worst:
            worst[k] = max(worst[k], errs.get(k, 0.0))
        MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"], errs["out_max_abs_err"])

    def twice(name, *args, **kw):
        first = decode_parts(*args, **kw)
        again = decode_parts(*args, **kw)
        torch.cuda.synchronize()
        check(bitwise(first, again), f"{name}: two runs of paged_decode differ")
        return first

    bf16, f32 = torch.bfloat16, torch.float32
    hk = 2
    for d in (128, 64):
        for dtype in (bf16, f32):
            for g in (1, 2, 4, 8) + ((16,) if dtype == bf16 else ()):
                for ps in (16, 64, 128):
                    full = DECODE_MPP * ps
                    lens = [0, 1, ps - 1, ps + 1, 5 * ps + 3, full // 2 + 7, full - 1, full]
                    cache, q = decode_problem(gen, d, dtype, g * hk, hk, ps, lens)
                    bt, sl = cache.block_tables, cache.seq_lens
                    softcap = 4.0 if (d, dtype, g, ps) == (128, bf16, 4, 64) else 0.0
                    ref = decode_reference(q, cache, bt, sl, softcap=softcap)
                    tag = f"d{d}_{str(dtype)[6:]}_g{g}_ps{ps}" + ("_softcap" if softcap else "")
                    for splits in DECODE_SPLITS:
                        parts = twice(f"{tag}_splits{splits}", q, cache, bt, sl, splits, softcap)
                        held(f"{tag}_splits{splits}", parts, ref)
                        counts["flat"] += 1
                    if g == 4 and ps == 64:
                        dirty = nan_past_lengths(cache, lens)
                        for splits in (1, 4):
                            check(bitwise(decode_parts(q, cache, bt, sl, splits, softcap),
                                          decode_parts(q, dirty, bt, sl, splits, softcap)),
                                  f"{tag}_splits{splits}: NaN past the lengths changes the output")
                            counts["nan_tail"] += 1

    # the shared mode: every member reads one table row and one length
    w = DECODE_SHARED_PAGES
    for d in (128, 64):
        for dtype in (bf16, f32):
            for ps in (16, 128):
                cache = da.PagedKVCache(
                    *(torch.randn((4 * w + 1, ps, hk, d), generator=gen, device="cuda").to(dtype)
                      for _ in range(2)),
                    torch.zeros((1, w), dtype=torch.int32, device="cuda"),
                    torch.zeros((1,), dtype=torch.int32, device="cuda"))
                pages = (torch.randperm(4 * w, generator=gen, device="cuda")[:w] + 1).int()
                for g in (1, 2, 4, 8):
                    for members in (1, 3, 8):
                        # a partial last page at 3 members: the mask and the NaN tail
                        plen = w * ps - (5 if members == 3 else 0)
                        q = torch.randn((members, g * hk, d), generator=gen,
                                        device="cuda").to(dtype)
                        bt_b = pages[None].expand(members, w).contiguous()
                        sl_b = torch.full((members,), plen, dtype=torch.int32, device="cuda")
                        sl_1 = sl_b[:1]
                        ref = decode_reference(q, cache, bt_b, sl_b)
                        tag = f"shared_d{d}_{str(dtype)[6:]}_ps{ps}_g{g}_m{members}"
                        for splits in (1, 3, 4):
                            parts = twice(f"{tag}_splits{splits}", q, cache, pages[None], sl_1,
                                          splits, shared=True)
                            held(f"{tag}_splits{splits}", parts, ref)
                            flat = da._merge_splits(*decode_parts(q, cache, bt_b, sl_b, splits))
                            out, lse = da._merge_splits(*parts)
                            errs, failed = out_errors(out, flat[0], [("lse", lse, flat[1])])
                            check(not failed, f"{tag}_splits{splits}: the shared mode fails the "
                                  f"{failed} check(s) against the flat mode: {errs}")
                            for k in shared_vs_flat:
                                shared_vs_flat[k] = max(shared_vs_flat[k], errs.get(k, 0.0))
                            entry = da._decode_shared_prefix(q, cache, pages, plen,
                                                             num_splits=splits)
                            check(bitwise(entry, da._merge_splits(*parts)),
                                  f"{tag}_splits{splits}: _decode_shared_prefix differs from "
                                  "its kernel's merged partials")
                            counts["shared"] += 1
                        if members == 3:
                            dirty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                                        v_pages=cache.v_pages.clone())
                            last = pages[-1].long()
                            dirty.k_pages[last, ps - 5:] = float("nan")
                            dirty.v_pages[last, ps - 5:] = float("nan")
                            clean = decode_parts(q, cache, pages[None], sl_1, 4, shared=True)
                            check(bitwise(clean, decode_parts(q, dirty, pages[None], sl_1, 4,
                                                              shared=True)),
                                  f"{tag}: NaN past the prefix length changes the output")
                            counts["nan_tail"] += 1
    return {"phase": "kernels", "kernel": "paged_decode", "cases": counts,
            "two_runs_bitwise_equal": True, **worst, "shared_vs_flat": shared_vs_flat}


def decode_planted_faults(gen, planted) -> dict:
    """The checks on the two faults planted in ``paged_decode``: each split's
    last chunk dropped (a flat batch at the serving widths, 4 splits), and
    every member on member 0's q (the shared mode, 3 members). Returns which
    checks catch each; a fault that passes them all fails the smoke."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    lens = [1, 100, PAGE + 1, 1000, 3000, 6000]
    cache, q = decode_problem(gen, D, torch.bfloat16, HQ, HK, PAGE, lens)
    bt, sl = cache.block_tables, cache.seq_lens
    pages, plen = bt[5, :DECODE_SHARED_PAGES], DECODE_SHARED_PAGES * PAGE
    qs = q[:3]
    runs = {
        "paged_decode_drop_last_chunk": (
            lambda: decode_parts(q, cache, bt, sl, 4), decode_reference(q, cache, bt, sl)),
        "paged_decode_member0_q": (
            lambda: decode_parts(qs, cache, pages[None], sl[5:6].clamp_max(plen), 4, shared=True),
            decode_reference(qs, cache, pages[None].expand(3, -1),
                             sl[5:6].clamp_max(plen).expand(3))),
    }
    caught = {}
    for name, (run, (ref_out, ref_lse)) in runs.items():
        out, lse = da._merge_splits(*with_library("paged_decode", planted[name], run)())
        torch.cuda.synchronize()
        errs, failed = out_errors(out, ref_out, [("lse", lse, ref_lse)])
        caught[name] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {name} passes the decode checks: {errs}")
    return caught


def simt_decode(lib, q, cache, bt, sl, splits):
    """A launcher of the previous decode walk (the ``decode_simt`` side
    library) on these inputs, checked once against the plain version. A
    yardstick only: nothing here is counted as a launch."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    b, hq, d = q.shape
    out = torch.empty((b, splits, hq, d), device="cuda")
    lse = torch.empty((b, splits, hq), device="cuda")
    bt, sl = bt.int().contiguous(), sl.int().contiguous()

    def run():
        code = lib.simt_paged_decode(
            q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(), bt.data_ptr(),
            sl.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hq, cache.num_kv_heads, d,
            cache.page_size, bt.shape[1], splits, 1.0 / math.sqrt(d), 0.0,
            torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous decode walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    ref_out, ref_lse = decode_reference(q, cache, bt, sl)
    got_out, got_lse = da._merge_splits(out, lse)
    _, failed = out_errors(got_out, ref_out, [("lse", got_lse, ref_lse)])
    check(not failed, f"the previous decode walk fails the {failed} check(s)")
    return run


def queued_ms(fn, reps: int = 1, repeats: int = 3) -> dict:
    """Device time of ``fn`` with the host kept ahead of the card: a spin
    kernel holds the stream while the host enqueues ``reps`` calls, so the
    CUDA events around them time the device's work back to back, without
    the host's launch gaps (a host-bound call timed with plain events times
    the host). The median of ``repeats`` such windows. ``queue_prefilled``
    says the spin outlasted the enqueueing in every window; where it is
    False the time includes host gaps. Keep ``reps`` times the call's
    kernels well under the launch queue's depth (about a thousand)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    times, enqueue, prefilled = [], [], True
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * one_s * reps + 2e-3)))  # cycles, at most ~2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue.append((time.perf_counter() - t0) * 1e3 / reps)
        prefilled = prefilled and not start.query()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return {"ms": sorted(times)[len(times) // 2],
            "host_enqueue_ms": sorted(enqueue)[len(enqueue) // 2], "queue_prefilled": prefilled}


def decode_bound(tokens: int, b: int, splits: int, table_entries: int) -> tuple[float, str]:
    """The card's bound on one decode launch at the serving widths: 4 d
    FLOPs per cached token and q head; each cached K/V row and q read once,
    each partial written once."""
    flops = 4.0 * tokens * HQ * D
    nbytes = (2 * 2 * tokens * HK * D + 2 * b * HQ * D
              + 4 * b * splits * HQ * (D + 1) + 4 * (table_entries + b))
    return bound(flops, nbytes)


def split_sweep(q, cache, bt, seq_lens) -> dict:
    """The kernel alone (CUDA events) and the kernel with ``merge_partials``
    as a decode step runs them (device time, queue pre-filled), at each
    split count of DECODE_SWEEP that divides the table width."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da

    sweep = {}
    for s in DECODE_SWEEP:
        if bt.shape[1] % s:
            continue
        prm = da.DecodeParams(1.0 / math.sqrt(D), 0.0, s, torch.bfloat16)
        sweep[s] = {
            "kernel_ms": cuda_ms(lambda: da._decode_partials_kernel(q, cache, bt, seq_lens, prm),
                                 reps=50),
            "kernel_and_merge": queued_ms(lambda: da._decode(q, cache, bt, seq_lens, prm)),
        }
    return sweep


def decode_timing(engine, slots, gen, planted) -> dict:
    """On the serving path's final batch state: the kernel at the resolved
    split count in turns with the previous walk at the split count its rule
    gave (new, old, old, new), and both at that count; the split sweep on
    this batch and on one 32K-token sequence; the plain version, SDPA over
    the gathered KV, and the card's bound for that work."""
    import torch
    import torch.nn.functional as Fn
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import gather_kv

    cache = engine.cache
    b = len(slots)
    idx = torch.as_tensor(slots, device="cuda")
    bt, seq_lens = cache.block_tables[idx], cache.seq_lens[idx]
    splits = da.resolve_num_splits(None, cache, b)
    # the previous rule: enough splits for two thread blocks an SM
    prev_splits = da._clamp_splits(-(-2 * 132 // (b * HK)), bt.shape[1])

    def kernel(s):
        prm = da.DecodeParams(1.0 / math.sqrt(D), 0.0, s, torch.bfloat16)
        return lambda: da._decode_partials_kernel(q, cache, bt, seq_lens, prm)

    q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    old = simt_decode(planted["decode_simt"], q, cache, bt, seq_lens, prev_splits)
    samples = {"new": [], "previous": [], f"new_at_{prev_splits}_splits": []}
    for which, fn in (("new", kernel(splits)), ("previous", old),
                      (f"new_at_{prev_splits}_splits", kernel(prev_splits)),
                      (f"new_at_{prev_splits}_splits", kernel(prev_splits)),
                      ("previous", old), ("new", kernel(splits))):
        samples[which].append(cuda_ms(fn, reps=50))
    mean = {k: sum(v) / len(v) for k, v in samples.items()}
    ms, prev_ms = mean["new"], mean["previous"]
    sweep = split_sweep(q, cache, bt, seq_lens)
    long_cache = decode_cache(gen, [32 * 1024 - 64], mpp=256)
    q1 = q[:1].contiguous()
    long_sweep = split_sweep(q1, long_cache, long_cache.block_tables[:1], long_cache.seq_lens[:1])
    plain_ms = cuda_ms(lambda: da._decode_torch(
        q, cache, bt, seq_lens, da.DecodeParams(1.0 / math.sqrt(D), 0.0, splits, torch.bfloat16)),
        reps=5, warmup=1)
    lens = [engine.length(s) for s in slots]
    lmax = max(lens)
    kv = [gather_kv(cache, s, max_len=lmax) for s in slots]
    k = torch.stack([x[0] for x in kv]).transpose(1, 2)  # [b, hk, L, d]
    v = torch.stack([x[1] for x in kv]).transpose(1, 2)
    mask = (torch.arange(lmax, device="cuda")[None] < seq_lens[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = cuda_ms(
        lambda: Fn.scaled_dot_product_attention(qs, k, v, attn_mask=mask, enable_gqa=True),
        reps=50,
    )
    tokens = sum(lens)
    bound_ms, bound_by = decode_bound(tokens, b, splits, bt.numel())
    return {"card": nvidia_smi_line(), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "splits": splits,
            "cached_tokens": tokens, "ms_in_turns": samples,
            "previous_walk": {"splits": prev_splits, "ms": prev_ms},
            f"new_at_{prev_splits}_splits_ms": mean[f"new_at_{prev_splits}_splits"],
            "speedup_over_previous_walk": prev_ms / ms, "share_of_bound": bound_ms / ms,
            "split_sweep": sweep,
            "split_sweep_one_sequence": {
                "cached_tokens": int(long_cache.seq_lens[0]),
                "bound_ms": decode_bound(int(long_cache.seq_lens[0]), 1, 1, 256)[0],
                "sweep": long_sweep}}


# -- the serving path ----------------------------------------------------------


def plain_causal_prefill(q, k, v):
    """The plain version of a causal prefill ([t, h, d] layout): the rows of
    ``q`` are the last ``len(q)`` positions of the prompt whose keys are
    ``k`` (bottom-right aligned causal, as a continued prefill attends)."""
    from magiattention_tpu_torch.ops import flex_attn as fa

    t, tk = q.shape[0], k.shape[0]
    bq, bk = fa.resolve_tile(D, None, None)
    meta = fa.build_block_meta([(0, t)], [(0, tk)], [1], t, tk, block_q=bq, block_k=bk)
    params = fa.FlexAttnParams(bq, bk, 1.0 / math.sqrt(D), 0.0, False, q.dtype)
    sink = q.new_zeros((q.shape[1],), dtype=q.dtype).float()
    out, lse, _ = fa._fwd_torch(
        fa._pad_tokens(q.transpose(0, 1), meta.num_q_blocks * bq),
        fa._pad_tokens(k.transpose(0, 1), meta.num_k_blocks * bk),
        fa._pad_tokens(v.transpose(0, 1), meta.num_k_blocks * bk), sink,
        fa.fwd_tables(meta, str(q.device)), params,
    )
    return out.transpose(0, 1)[:t], lse.transpose(0, 1)[:t]


def serving(gen, hq=None, hk=None, prompts=(1000, 1733, 2048, 2900, 4096, 5120, 6500, 8000),
            chunked=3, steps=64, phase="serving") -> tuple[dict, object, list[int]]:
    """The serving path at ``hq`` / ``hk`` heads: admit the prompts, prefill
    them (prompt ``chunked`` in 2048-token chunks) with the automatic kernel
    choice, run ``steps`` decode steps over the batch; every forward must
    launch the chosen kernel (``flex_fwd_hb`` at head_block G > 1,
    ``flex_fwd`` at G = 1) and no other flex kernel."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.serving import ServingEngine, decode_reference

    hq, hk = hq or HQ, hk or HK
    g = hq // hk
    choice = fa.auto_kernel_config([(0, prompts[0])], [(0, prompts[0])], hq, hk,
                                   attn_type_map=[1], head_dim=D)
    check(choice == (64, 64, g, "row_major"),
          f"{phase}: the causal prefill's choice is {choice}, not (64, 64, {g}, 'row_major')")
    fwd = "flex_fwd_hb" if g > 1 else "flex_fwd"
    engine = ServingEngine(num_pages=1024, num_kv_heads=hk, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    csrc.reset_launch_counts()
    slots, prefill_ms, checked = [], [], []
    for i, t in enumerate(prompts):
        res = engine.admit(t)
        check(res.admitted, f"admission of a {t}-token prompt refused: {res.reason}")
        q = torch.randn((t, hq, D), generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn((2, t, hk, D), generator=gen, device="cuda").to(torch.bfloat16)
        if i == chunked:
            os.environ["MAGI_ATTENTION_PREFILL_CHUNK"] = "2048"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, lse = engine.prefill(q, kv[0], kv[1], res.slot)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            os.environ.pop("MAGI_ATTENTION_PREFILL_CHUNK", None)
        check(out.shape == (t, hq, D) and bool(torch.isfinite(out).all()),
              f"prefill {t}: bad output")
        if t <= 4096:
            ref_out, ref_lse = plain_causal_prefill(q, kv[0], kv[1])
            compare(fwd, f"{phase}_prefill_{t}" + ("_chunked" if i == chunked else ""),
                    out, ref_out, lse, ref_lse)
            checked.append(t)
        slots.append(res.slot)

    step_ms = []
    for step in range(steps):
        q = torch.randn((len(slots), hq, D), generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn((2, len(slots), hk, D), generator=gen, device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = engine.decode_step(q, kv[0], kv[1], slots)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(out).all()), f"decode step {step}: non-finite out")
        if step % 8 == 0:
            idx = torch.as_tensor(slots, device="cuda")
            ref_out, ref_lse = decode_reference(
                q, engine.cache, engine.cache.block_tables[idx], engine.cache.seq_lens[idx])
            compare("paged_decode", f"{phase}_decode_step{step}", out, ref_out, lse, ref_lse)
    lengths = [engine.length(s) for s in slots]
    check(lengths == [t + steps for t in prompts], f"final lengths {lengths}")
    launches = {n: csrc.launches[n] for n in (*FLEX_KERNELS, "paged_decode") if csrc.launches[n]}
    forwards = len(prompts) + math.ceil(prompts[chunked] / 2048) - 1
    check(launches.get("paged_decode", 0) > 0 and launches.get(fwd) == forwards
          and set(launches) == {fwd, "paged_decode"},
          f"{phase} launches {launches}: expected {forwards} of {fwd} (one per forward), "
          "paged_decode, and no other kernel")
    decode_s = sum(step_ms) / 1e3
    summary = {
        "phase": phase,
        "heads": {"hq": hq, "hk": hk, "head_dim": D},
        "choice": dict(zip(("block_q", "block_k", "head_block", "grid"), choice)),
        "prompts": list(prompts),
        "prefill_ms": prefill_ms,
        "prefill_checked_tokens": checked,
        "decode_steps": steps,
        "decode_batch": len(slots),
        "decode_ms_per_step": sum(step_ms) / steps,
        "decode_ms_per_step_after_first": sum(step_ms[1:]) / (steps - 1),
        "decode_tokens_per_s": len(slots) * steps / decode_s,
        "launches": launches,
        "pages_in_use": engine.allocator.pages_in_use,
    }
    return summary, engine, slots


# -- shared-prefix serving ----------------------------------------------------------

PREFIX_LEN = 4000  # 31 full pages of 128 tokens and a 32-token tail
PREFIX_SUFFIXES = (300, 512, 777, 1024, 1500, 1800, 2000)
PREFIX_CHUNKED = 4  # the 1500-token suffix is prefilled in 512-token chunks
PREFIX_CHUNK = 512
PREFIX_STEPS = 32
VOCAB = 128256  # Llama-3.1-8B's vocabulary: the token ids the trie hashes


def prefix(gen) -> dict:
    """Shared-prefix serving through ``ServingEngine``'s defaults: one
    registrant prompt, 7 requests forking onto its pages, cascade decode.
    Every prefill row is held against the plain causal attention over its
    whole prompt, the first decode step's cascade ``auto`` and ``on``
    against the flat path and the plain decode."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import ServingEngine, plan_cascade_groups
    from magiattention_tpu_torch.serving import decode_attn as da

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    full = PREFIX_LEN // PAGE
    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    ids = torch.randint(0, VOCAB, (PREFIX_LEN + sum(PREFIX_SUFFIXES),), generator=gen,
                        device="cuda").tolist()
    system, rest = ids[:PREFIX_LEN], ids[PREFIX_LEN:]
    k_sys, v_sys = rand(PREFIX_LEN, HK, D), rand(PREFIX_LEN, HK, D)
    csrc.reset_launch_counts()

    def timed_prefill(q, k, v, slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = engine.prefill(q, k, v, slot)
        torch.cuda.synchronize()
        return out, lse, (time.perf_counter() - t0) * 1e3

    res = engine.admit(PREFIX_LEN, tokens=system)
    check(res.admitted and res.prefix_len == 0, f"prefix: registrant admission {res}")
    q = rand(PREFIX_LEN, HQ, D)
    out, lse, registrant_ms = timed_prefill(q, k_sys, v_sys, res.slot)
    ref_out, ref_lse = plain_causal_prefill(q, k_sys, v_sys)
    compare("flex_fwd_hb", f"prefix_registrant_{PREFIX_LEN}", out, ref_out, lse, ref_lse)
    slots, suffix_ms = [res.slot], []
    tail_page = engine.allocator.slot_pages(res.slot)[full]
    for i, n in enumerate(PREFIX_SUFFIXES):
        toks, rest = system + rest[:n], rest[n:]
        res = engine.admit(len(toks), tokens=toks)
        check(res.admitted and res.prefix_len == PREFIX_LEN,
              f"prefix: request {i} admitted as {res}, not with prefix_len {PREFIX_LEN}")
        q, k, v = rand(n, HQ, D), rand(n, HK, D), rand(n, HK, D)
        if i == PREFIX_CHUNKED:
            os.environ["MAGI_ATTENTION_PREFILL_CHUNK"] = str(PREFIX_CHUNK)
        try:
            out, lse, ms = timed_prefill(q, k, v, res.slot)
        finally:
            os.environ.pop("MAGI_ATTENTION_PREFILL_CHUNK", None)
        suffix_ms.append(ms)
        ref_out, ref_lse = plain_causal_prefill(q, torch.cat([k_sys, k]), torch.cat([v_sys, v]))
        compare("flex_fwd_hb", f"prefix_suffix_{n}" + ("_chunked" if i == PREFIX_CHUNKED else ""),
                out, ref_out, lse, ref_lse)
        pages = engine.allocator.slot_pages(res.slot)
        check(pages[:full] == engine.allocator.slot_pages(slots[0])[:full]
              and pages[full] != tail_page,
              f"prefix: request {i} does not share the 31 full pages or kept the shared tail")
        slots.append(res.slot)
    # the copy-on-write splits left the registrant's tail page as it wrote it
    tail = PREFIX_LEN - full * PAGE
    check(torch.equal(engine.cache.k_pages[tail_page, :tail], k_sys[full * PAGE:])
          and torch.equal(engine.cache.v_pages[tail_page, :tail], v_sys[full * PAGE:]),
          "prefix: a fork's write changed the registrant's tail page")
    pages_after_prefill = engine.allocator.pages_in_use
    lengths = [PREFIX_LEN + n for n in (0, *PREFIX_SUFFIXES)]
    flat_pages = sum(engine.allocator.pages_needed(t) for t in lengths)
    check(flat_pages - pages_after_prefill >= len(PREFIX_SUFFIXES) * full,
          f"prefix: {pages_after_prefill} pages in use, a flat engine's {flat_pages}: "
          f"fewer than {len(PREFIX_SUFFIXES) * full} saved")
    groups = plan_cascade_groups(engine._slot_prefix, slots)
    check(len(groups) == 1 and len(groups[0].members) == len(slots)
          and len(groups[0].shared_pages) == full,
          f"prefix: cascade groups {[(len(g.shared_pages), g.members) for g in groups]}")

    # the kernel's shared-mode launches (the cascade's level 1), counted on
    # their own beside csrc.launches
    real_partials, shared_launches = da._decode_partials_kernel, [0]

    def counting_partials(*args, shared=False, **kw):
        shared_launches[0] += int(shared)
        return real_partials(*args, shared=shared, **kw)

    da._decode_partials_kernel = counting_partials
    try:
        return prefix_decode(gen, engine, slots, groups, lengths, rand, shared_launches, {
            "registrant_prefill_ms": registrant_ms,
            "suffix_prefill_ms": suffix_ms,
            "pages_in_use_after_prefill": pages_after_prefill,
            "flat_engine_pages": flat_pages,
            "pages_saved": flat_pages - pages_after_prefill,
        })
    finally:
        da._decode_partials_kernel = real_partials


def prefix_decode(gen, engine, slots, groups, lengths, rand, shared_launches, line) -> dict:
    """The prefix phase's decode: the first step three ways on one state
    (cascade ``auto``, ``on`` and flat, each against the plain decode, the
    cascade against the flat path), then the rest of the steps with cascade
    ``auto``; the decode attention alone on the final state, cascade
    against flat, on the host clock and in device time."""
    import torch
    from magiattention_tpu_torch import csrc, env
    from magiattention_tpu_torch.serving import (
        cascade_decode_attn, decode_attn_paged, decode_reference,
    )
    from magiattention_tpu_torch.serving import decode_attn as da

    full = PREFIX_LEN // PAGE
    # the first step three ways on one state: cascade auto, on, and flat
    seq_lens, host_lens = engine.cache.seq_lens.clone(), dict(engine._lengths)
    q, k, v = rand(len(slots), HQ, D), rand(len(slots), HK, D), rand(len(slots), HK, D)
    first = {}
    for mode in ("auto", "on", "off"):
        engine.cache.seq_lens.copy_(seq_lens)
        engine._lengths.update(host_lens)
        first[mode] = engine.decode_step(q, k, v, slots, cascade=mode)
    torch.cuda.synchronize()
    idx = torch.as_tensor(slots, device="cuda")
    ref_out, ref_lse = decode_reference(q, engine.cache, engine.cache.block_tables[idx],
                                        engine.cache.seq_lens[idx])
    for mode, (out, lse) in first.items():
        compare("paged_decode", f"prefix_decode_step0_cascade_{mode}", out, ref_out, lse, ref_lse)
    for mode in ("auto", "on"):
        compare("paged_decode", f"prefix_decode_step0_cascade_{mode}_vs_flat", first[mode][0],
                first["off"][0], first[mode][1], first["off"][1])
    step_ms = []
    for step in range(1, PREFIX_STEPS):
        q, k, v = rand(len(slots), HQ, D), rand(len(slots), HK, D), rand(len(slots), HK, D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = engine.decode_step(q, k, v, slots)  # MAGI_ATTENTION_CASCADE, default auto
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step % 8 == 0:
            ref_out, ref_lse = decode_reference(q, engine.cache, engine.cache.block_tables[idx],
                                                engine.cache.seq_lens[idx])
            compare("paged_decode", f"prefix_decode_step{step}", out, ref_out, lse, ref_lse)
    check([engine.length(s) for s in slots] == [t + PREFIX_STEPS for t in lengths],
          f"prefix: final lengths {[engine.length(s) for s in slots]}")
    launches = {n: csrc.launches[n] for n in (*FLEX_KERNELS, "paged_decode") if csrc.launches[n]}
    forwards = 1 + len(PREFIX_SUFFIXES) + math.ceil(PREFIX_SUFFIXES[PREFIX_CHUNKED] / PREFIX_CHUNK) - 1
    check(launches.get("flex_fwd_hb") == forwards and launches.get("paged_decode", 0) > 0
          and set(launches) == {"flex_fwd_hb", "paged_decode"},
          f"prefix launches {launches}: expected {forwards} of flex_fwd_hb, paged_decode, "
          "and no other kernel")
    # cascade auto and on ran level 1 in the shared mode: the first step's
    # two cascades and the PREFIX_STEPS - 1 steps after it, one group each
    check(shared_launches[0] == PREFIX_STEPS + 1,
          f"prefix: {shared_launches[0]} shared-mode launches, not {PREFIX_STEPS + 1}")
    shared_on_main_path = shared_launches[0]
    # the decode attention alone on the final state, cascade against flat,
    # in turns (host clock, synchronised: what a decode step pays for it)
    attn = {"cascade": lambda: cascade_decode_attn(q, engine.cache, slots, groups),
            "flat": lambda: decode_attn_paged(q, engine.cache, idx)}
    attn_ms = {name: [] for name in attn}
    for name in ("cascade", "flat", "flat", "cascade"):
        attn[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            attn[name]()
        torch.cuda.synchronize()
        attn_ms[name].append((time.perf_counter() - t0) * 1e2)
    device_ms = {name: [] for name in attn}
    for name in ("cascade", "flat", "flat", "cascade"):
        device_ms[name].append(queued_ms(attn[name], reps=3))
    # level 1 alone on the final state: the kernel's shared mode against its
    # flat mode over the broadcast table (what level 1 ran before the shared
    # mode), one split, with the bytes each must read
    g = groups[0]
    pages = torch.as_tensor(g.shared_pages, dtype=torch.int32, device="cuda")[None]
    qg = q[torch.as_tensor(g.members, device="cuda")]
    members = len(g.members)
    sl1 = torch.full((1,), g.prefix_len, dtype=torch.int32, device="cuda")
    prm = da.DecodeParams(1.0 / math.sqrt(D), 0.0, 1, torch.bfloat16)
    kv_bytes = 2 * 2 * g.prefix_len * HK * D
    level1 = {
        "shared_mode_ms": cuda_ms(lambda: da._decode_partials_kernel(
            qg, engine.cache, pages, sl1, prm, shared=True), reps=50),
        "broadcast_table_ms": cuda_ms(lambda: da._decode_partials_kernel(
            qg, engine.cache, pages.expand(members, -1).contiguous(),
            sl1.expand(members).contiguous(), prm), reps=50),
        "shared_mode_kv_bytes": kv_bytes,
        "broadcast_table_kv_bytes": members * kv_bytes,
        "shared_mode_bound_ms": bound(4.0 * g.prefix_len * HQ * D * members, kv_bytes)[0],
    }
    decode_s = sum(step_ms) / 1e3
    return {
        "phase": "prefix",
        "card": nvidia_smi_line(),
        "heads": {"hq": HQ, "hk": HK, "head_dim": D, "page_size": PAGE},
        "prefix_tokens": PREFIX_LEN, "shared_full_pages": full, "suffixes": list(PREFIX_SUFFIXES),
        "chunked_suffix": {"tokens": PREFIX_SUFFIXES[PREFIX_CHUNKED], "chunk": PREFIX_CHUNK},
        **line,
        "pages_in_use_after_decode": engine.allocator.pages_in_use,
        "cascade_mode": env.cascade_mode(),
        "cascade_groups": [{"members": len(g.members), "shared_pages": len(g.shared_pages)}
                           for g in groups],
        "decode_steps": PREFIX_STEPS,
        "decode_batch": len(slots),
        "decode_ms_per_step_cascade_auto_steps_2_to_32": sum(step_ms) / len(step_ms),
        "decode_tokens_per_s": len(slots) * len(step_ms) / decode_s,
        "decode_attention_ms_final_state_in_turns": attn_ms,
        "decode_attention_device_ms_final_state_in_turns": device_ms,
        "level1_kernel_final_state": level1,
        "launches": launches,
        "paged_decode_shared_mode_launches": shared_on_main_path,
    }


# -- the training path ---------------------------------------------------------


TRAIN_LAYERS = 4  # cut from the config's 16 to keep the smoke within its time
TRAIN_DOCS = [4096, 2048, 2048]  # one 8192-token stream, three documents
TRAIN_STEPS = 6
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw's


def attention_check(model, cap) -> None:
    """One layer's attention call from the first step against the plain
    forward and backward on the card: its q, k, v, the forward's out and lse,
    the dout that reached it and the dq, dk, dv it gave back."""
    import torch
    from magiattention_tpu_torch.ops import flex_attn as fa

    meta, cfg = model.meta, model.cfg
    tqp, tkp = meta.num_q_blocks * meta.block_q, meta.num_k_blocks * meta.block_k
    t = cap["q"].shape[0]

    def head_major(x, tp):
        return fa._pad_tokens(x.transpose(0, 1), tp)

    q, out, do = (head_major(cap[n], tqp) for n in ("q", "out", "dout"))
    k, v = (head_major(cap[n], tkp) for n in ("k", "v"))
    params = fa.FlexAttnParams(meta.block_q, meta.block_k, 1.0 / math.sqrt(cfg.head_dim),
                               0.0, False, cfg.torch_dtype)
    ftab, btab = fa.fwd_tables(meta, "cuda:0"), fa.bwd_tables(meta, "cuda:0")
    sink = torch.zeros((q.shape[0],), device="cuda")
    ref_out, ref_lse, _ = fa._fwd_torch(q, k, v, sink, ftab, params)
    compare("flex_fwd_hb", "training_layer0_step0", cap["out"], ref_out[:, :t].transpose(0, 1),
            cap["lse"], ref_lse[:, :t].transpose(0, 1))
    # the model does not use lse: its cotangent is 0, delta_eff = sum dout * out
    lse = head_major(cap["lse"], tqp)
    delta = (do.float() * out.float()).sum(-1)
    ref_dq = fa._dq_torch(q, k, v, do, lse, delta, ftab, params)
    compare_grads("flex_dq", "training_layer0_step0",
                  [("dq", cap["dq"].transpose(0, 1), ref_dq[:, :t])])
    ref_dk, ref_dv = fa._dkv_torch(q, k, v, do, lse, delta, btab, params)
    compare_grads("flex_dkv", "training_layer0_step0",
                  [("dk", cap["dk"].transpose(0, 1), ref_dk[:, :t]),
                   ("dv", cap["dv"].transpose(0, 1), ref_dv[:, :t])])


KERNEL_GROUPS = (  # kernel-name fragments -> the layer a step's device time goes to
    ("attention kernels", ("flex_fwd_kernel", "flex_fwd_hb_kernel", "flex_dq_kernel",
                           "flex_dkv_kernel")),
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass")),
    ("optimizer", ("multi_tensor", "adam")),
)


def profile_step(step, batch) -> dict:
    """One more train step under ``torch.profiler``: device time by kernel
    group, the step's host-clock time, and the device's idle share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a GPU user annotation (e.g. "Optimizer.step#AdamW.step")
    # spans kernels that are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other kernels"] = 0.0
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        group = next((n for n, frags in KERNEL_GROUPS
                      if any(f in e.key.lower() for f in frags)), "other kernels")
        groups[group] += ms
    device_ms = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
        "device_ms_by_group": groups,
        "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
    }


def training(seed: int) -> dict:
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.api import infer_varlen_mask_from_batch
    from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama, make_model_train_step
    from magiattention_tpu_torch.ops import flex_attn_with_meta

    full = LlamaConfig()
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    total = sum(TRAIN_DOCS)
    qr, kr, ts = infer_varlen_mask_from_batch(TRAIN_DOCS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_magi_llama(cfg, total, qr, kr, ts, seed=seed)  # the card, by default
    choice = (model.meta.block_q, model.meta.block_k, model.head_block)
    check(choice == (64, 64, cfg.n_heads // cfg.n_kv_heads),
          f"training: the harness's blocking is {choice}, not (64, 64, G)")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (total,), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1)  # the next token
    pos = torch.arange(total, device="cuda")  # global position ids
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))

    cap = {}

    def capture(q, k, v):
        """The model's attention, holding on to the first call's operands,
        results and gradients (no extra launch)."""
        out, lse = flex_attn_with_meta(q, k, v, model.meta, out_dtype=cfg.torch_dtype,
                                       head_block=model.head_block)
        if not cap:
            cap.update(q=q.detach(), k=k.detach(), v=v.detach(), out=out.detach(), lse=lse.detach())
            for name, x in (("dq", q), ("dk", k), ("dv", v), ("dout", out)):
                x.register_hook(lambda g, name=name: cap.__setitem__(name, g))
        return out

    losses, step_ms = [], []
    csrc.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        if i == 0:
            model.attention = capture  # shadows the method for the first step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(tokens, labels, pos))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == 0:
            del model.attention
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    peak = torch.cuda.max_memory_allocated()
    expected = TRAIN_LAYERS * TRAIN_STEPS
    check(launches == {n: expected for n in TRAINING_KERNELS},
          f"training launches {launches}, expected {expected} of each of {TRAINING_KERNELS} "
          "and no other flex kernel")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall on a fixed batch: {losses}")
    check(set(cap) == {"q", "k", "v", "out", "lse", "dq", "dk", "dv", "dout"},
          f"the first step's attention call captured only {sorted(cap)}")
    attention_check(model, cap)
    # a seventh step, after the six counted ones, under the profiler
    profile = profile_step(step, (tokens, labels, pos))
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    return {
        "phase": "training",
        "config": {**dataclasses.asdict(cfg), "n_layers_full": full.n_layers},
        "cut": f"n_layers {full.n_layers} -> {TRAIN_LAYERS} (depth only; every width as configured)",
        "choice": {"block_q": choice[0], "block_k": choice[1], "head_block": choice[2],
                   "grid": "row_major"},
        "docs": TRAIN_DOCS,
        "tokens_per_step": total,
        "optimizer": {"AdamW": {**ADAMW, "betas": list(ADAMW["betas"])}},
        "losses": losses,
        "step_ms": step_ms,
        "median_step_ms_steps_2_to_6": med,
        "tokens_per_s": total / (med / 1e3),
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "profiled_extra_step": profile,
    }


# -- the heterogeneous-mask path ---------------------------------------------------

HETERO_T = 16384  # testing/workloads.py::varlen_block_causal(16384): 12 documents, seed 7
HETERO_RUNS = ((TRAIN_HQ, TRAIN_HK, 2), (8, 8, 1))  # (hq, hk, the head_block the choice must give)


def library_attention(q, k, v, cu, max_len):
    """One PyTorch call computing the same causal-per-document attention
    ([t, h, d] bf16), a yardstick only: ``torch.nn.attention.varlen.varlen_attn``
    where the installed torch has it, else ``scaled_dot_product_attention``
    over the boolean block-diagonal causal mask with k/v repeated to hq
    heads on the memory-efficient backend. Returns (fn, what ran)."""
    import inspect

    import torch
    import torch.nn.functional as Fn

    hq, hk = q.shape[1], k.shape[1]

    def rep(x):  # k/v repeated to hq heads, inside the call so autograd sees it
        return x.repeat_interleave(hq // hk, 1)

    try:
        from torch.nn.attention import varlen

        params = inspect.signature(varlen.varlen_attn).parameters
        kw = {"is_causal": True} if "is_causal" in params else {"window_size": (-1, 0)}
        gqa = hq != hk and "enable_gqa" in params
        if gqa:
            kw["enable_gqa"] = True

        def fn():
            kv = (k, v) if gqa or hq == hk else (rep(k), rep(v))
            return varlen.varlen_attn(q, *kv, cu, cu, max_len, max_len, **kw)

        fn()
        return fn, f"torch.nn.attention.varlen.varlen_attn({', '.join(sorted(kw))})"
    except (ImportError, AttributeError, RuntimeError, TypeError) as exc:
        reason = f"{type(exc).__name__}: {str(exc)[:120]}"
    from torch.nn.attention import SDPBackend, sdpa_kernel

    t = q.shape[0]
    doc = torch.repeat_interleave(torch.arange(cu.numel() - 1, device=q.device), torch.diff(cu))
    pos = torch.arange(t, device=q.device)
    mask = (doc[:, None] == doc[None]) & (pos[None] <= pos[:, None])

    def fn():
        qs, ks, vs = (x.transpose(0, 1).unsqueeze(0) for x in (q, rep(k), rep(v)))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        return out.squeeze(0).transpose(0, 1)

    fn()
    return fn, f"scaled_dot_product_attention(EFFICIENT_ATTENTION, boolean mask) [varlen: {reason}]"


def mma_sync_sparse(lib, p, bwd_args, refs):
    """Launchers of the previous sparse-grid backward (the ``mma_sync_sparse``
    yardstick library) on ``bwd_args`` over per-head dq items and the dkv
    work list, checked once against the plain backward's (dq, dk, dv)
    ``refs``. A yardstick only: nothing here is counted as a launch."""
    import torch
    from magiattention_tpu_torch.ops.block_sparse import row_tables, work_list

    q, k, v, do, lse, delta = bwd_args
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    nq, nk = tqp // BLOCK, tkp // BLOCK
    dq_items = torch.from_numpy(work_list(row_tables(p.meta.fwd_q_block, nq)[1], hq)).cuda()
    counter = torch.empty((1,), dtype=torch.int32, device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    dq, dk, dv = torch.empty((hq, tqp, d), **f32), *(torch.empty((hk, tkp, d), **f32)
                                                     for _ in range(2))
    head = [x.data_ptr() for x in bwd_args]

    def run(fn, tables, items, outs, blocks):
        code = fn(*head, *(x.data_ptr() for x in tables[1:7]), items.data_ptr(),
                  counter.data_ptr(), *(o.data_ptr() for o in outs), hq, hk, tqp, tkp, d, blocks,
                  items.numel(), p.params.scale, p.params.softcap,
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous sparse backward walk: CUDA error {code}")

    def run_dq():
        run(lib.mma_sync_flex_dq_sparse, p.tables, dq_items, (dq,), nq)

    def run_dkv():
        run(lib.mma_sync_flex_dkv_sparse, p.btables, p.work.dkv, (dk, dv), nk)

    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    for what, got, ref, t in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, (p.tq, p.tk, p.tk)):
        _, failed = grad_errors(got[:, :t], ref[:, :t])
        check(not failed, f"the previous sparse walk's {what} fails the {failed} check(s)")
    return run_dq, run_dkv


def mma_sync_fwd_sparse(lib, p):
    """A launcher of the previous sparse forward (the ``mma_sync_fwd_sparse``
    yardstick library) on ``p``'s inputs and forward work list, checked once
    against the plain sparse forward. A yardstick only: nothing here is
    counted as a launch."""
    import torch

    q, k, v = p.q, p.k, p.v
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    out = torch.empty((hq, tqp, d), dtype=torch.bfloat16, device="cuda")
    lse, rowmax = (torch.empty((hq, tqp), device="cuda") for _ in range(2))
    counter = torch.empty((1,), dtype=torch.int32, device="cuda")
    ptrs = [x.data_ptr() for x in (q, k, v, p.sink, *p.tables[1:7], p.work.fwd, counter, out,
                                   lse, rowmax)]
    prm = p.sparse_params

    def run():
        code = lib.mma_sync_flex_fwd_sparse(
            *ptrs, hq, hk, tqp, tkp, d, tqp // BLOCK, BLOCK, BLOCK, p.work.fwd.numel(), p.hb,
            prm.scale, prm.softcap, int(prm.has_sink), 0, torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous sparse forward walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    o, r, pairs = p.sparse_fwd_pairs((out, lse, rowmax))
    _, failed = out_errors(o, r, pairs)
    check(not failed, f"the previous sparse forward walk fails the {failed} check(s)")
    return run


def hetero_run(gen, qr, kr, ty, hq, hk, expect_hb, planted, timed) -> tuple[dict, dict, dict]:
    """One default-argument forward and backward through
    ``flex_flash_attn_func`` on the varlen mask: the resolved choice, the
    launches, the results against the plain versions, and (``timed``) each
    kernel's time with the row-major one's, the plain one's, the bound and
    the library yardstick, the backward kernels in turns with the previous
    sparse walk, and the slice's forward + backward in device time. Returns
    (summary, launches, per-kernel times)."""
    import dataclasses as dc

    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.tuning import exact_mask_area

    t = HETERO_T
    bq, bk, hb, grid = fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, head_dim=D)
    check((grid, hb) == ("sparse", expect_hb),
          f"hq {hq} / hk {hk}: the choice is grid={grid!r} head_block={hb}, not sparse/{expect_hb}")
    p = Flex(gen, t, t, hq, hk, qr, kr, ty, head_block=hb)
    q, k, v = (x[:, :t].transpose(0, 1).contiguous().requires_grad_() for x in (p.q, p.k, p.v))
    dout = p.do[:, :t].transpose(0, 1).contiguous()
    dlse = p.dlse[:, :t].transpose(0, 1).contiguous()

    torch.cuda.synchronize()
    csrc.reset_launch_counts()
    t0 = time.perf_counter()
    out, lse = fa.flex_flash_attn_func(q, k, v, qr, kr, ty)  # every choice left to the port
    dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v), (dout, dlse))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS}
    fwd_name = "flex_fwd_sparse_hb" if hb > 1 else "flex_fwd_sparse"
    want = {n: int(n in (fwd_name, "flex_dq_sparse", "flex_dkv_sparse")) for n in FLEX_KERNELS}
    check(launches == want, f"hq {hq} / hk {hk}: launches {launches}, expected {want}")

    # the plain versions on the same inputs: the sparse forward on every
    # head at once, the dense backward one kv head's group at a time
    ref_out, ref_lse, _ = p.sparse_plain()
    compare(fwd_name, f"hetero_{hq}_{hk}", out.transpose(0, 1), ref_out[:, :t],
            lse.transpose(0, 1), ref_lse[:, :t])
    g = hq // hk
    ftab, btab, params = p.tables, p.btables, p.sparse_params
    tqp = p.q.shape[1]

    def head_major(x):
        return fa._pad_tokens(x.detach().transpose(0, 1), tqp)

    lse_h = head_major(lse)
    delta = (head_major(dout).float() * head_major(out).float()).sum(-1) - head_major(dlse)
    groups = range(hk) if timed else range(1)

    def plain_dq():
        return torch.cat([fa._dq_torch(p.q[j * g:(j + 1) * g], p.k[j:j + 1], p.v[j:j + 1],
                                       p.do[j * g:(j + 1) * g], lse_h[j * g:(j + 1) * g],
                                       delta[j * g:(j + 1) * g], ftab, params)
                          for j in groups])

    def plain_dkv():
        pairs = [fa._dkv_torch(p.q[j * g:(j + 1) * g], p.k[j:j + 1], p.v[j:j + 1],
                               p.do[j * g:(j + 1) * g], lse_h[j * g:(j + 1) * g],
                               delta[j * g:(j + 1) * g], btab, params) for j in groups]
        return torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs])

    nh, nk = len(groups) * g, len(groups)
    ref_dq = plain_dq()
    compare_grads("flex_dq_sparse", f"hetero_{hq}_{hk}",
                  [("dq", dq.transpose(0, 1)[:nh], ref_dq[:, :t])])
    ref_dk, ref_dv = plain_dkv()
    compare_grads("flex_dkv_sparse", f"hetero_{hq}_{hk}",
                  [("dk", dk.transpose(0, 1)[:nk], ref_dk[:, :t]),
                   ("dv", dv.transpose(0, 1)[:nk], ref_dv[:, :t])])
    area = exact_mask_area(qr, kr, ty)
    summary = {"hq": hq, "hk": hk, "choice": {"block_q": bq, "block_k": bk, "head_block": hb,
                                              "grid": grid},
               "launches": launches, "fwd_bwd_wall_ms": wall_ms, "pairs": area,
               "plain_checked_heads": nh}
    if not timed:
        return summary, launches, {}

    # times on the same problem: the sparse kernels (through the wrappers,
    # with the backward's own inputs), the row-major ones, the plain ones
    rm = dc.replace(params, head_block=1, grid="row_major")
    bwd_args = (p.q, p.k, p.v, p.do, lse_h, delta)
    fwd = fa._fwd_sparse_hb_kernel if hb > 1 else fa._fwd_sparse_kernel
    # each kernel in turns with the previous sparse walk (new, old, old, new)
    old = dict(zip(("flex_dq_sparse", "flex_dkv_sparse"),
                   mma_sync_sparse(planted["mma_sync_sparse"], p, bwd_args,
                                   (ref_dq, ref_dk, ref_dv))))
    old[fwd_name] = mma_sync_fwd_sparse(planted["mma_sync_fwd_sparse"], p)
    new = {fwd_name: lambda: fwd(p.q, p.k, p.v, p.sink, ftab, p.work, params),
           "flex_dq_sparse": lambda: fa._dq_sparse_kernel(*bwd_args, ftab, p.work, params),
           "flex_dkv_sparse": lambda: fa._dkv_sparse_kernel(*bwd_args, btab, p.work, params)}
    # and the forward in turns with its variant that moves AMLA's reference
    # on every rise of a row's max
    every_rise = with_library(fwd_name, planted[f"{fwd_name}_every_rise"], new[fwd_name])
    every_rise_errs, failed = out_errors(*p.sparse_fwd_pairs(every_rise()))
    check(not failed, f"the every-rise variant of {fwd_name} fails the {failed} check(s)")
    turns = {}
    for name in new:
        for which, fn in (("", new[name]), ("previous:", old[name]), ("previous:", old[name]),
                          ("", new[name])):
            turns.setdefault(which + name, []).append(cuda_ms(fn, reps=20))
    for which, fn in (("", new[fwd_name]), ("every_rise:", every_rise),
                      ("every_rise:", every_rise), ("", new[fwd_name])):
        turns.setdefault(which + fwd_name, []).append(cuda_ms(fn, reps=20))
    mean = {n: sum(x) / len(x) for n, x in turns.items()}
    ms = {n: mean[n] for n in new}

    def fwd_bwd():  # the slice as a user calls it, plans and lists cached
        o, l = fa.flex_flash_attn_func(q, k, v, qr, kr, ty)
        torch.autograd.grad((o, l), (q, k, v), (dout, dlse))

    fwd_bwd_event_ms = cuda_ms(fwd_bwd, reps=5)
    # the same kernels with their work lists in index order (head group,
    # then block): what taking the longest walks first buys
    in_order = fa.SparseWork(*(torch.sort(w).values for w in p.work))
    index_order_ms = {
        fwd_name: cuda_ms(lambda: fwd(p.q, p.k, p.v, p.sink, ftab, in_order, params), reps=20),
        "flex_dq_sparse": cuda_ms(lambda: fa._dq_sparse_kernel(*bwd_args, ftab, in_order, params),
                                  reps=20),
        "flex_dkv_sparse": cuda_ms(
            lambda: fa._dkv_sparse_kernel(*bwd_args, btab, in_order, params), reps=20),
    }
    row_major_ms = {
        "flex_fwd": cuda_ms(lambda: fa._fwd_kernel(p.q, p.k, p.v, p.sink, ftab, rm), reps=20),
        **({"flex_fwd_hb": cuda_ms(lambda: fa._fwd_hb_kernel(
            p.q, p.k, p.v, p.sink, ftab, dc.replace(rm, head_block=hb)), reps=20)}
           if hb > 1 else {}),
        "flex_dq": cuda_ms(lambda: fa._dq_kernel(*bwd_args, ftab, rm), reps=20),
        "flex_dkv": cuda_ms(lambda: fa._dkv_kernel(*bwd_args, btab, rm), reps=20),
    }
    plain_ms = {
        fwd_name: cuda_ms(p.sparse_plain, reps=1, warmup=1),
        "flex_dq_sparse": cuda_ms(plain_dq, reps=1, warmup=1),
        "flex_dkv_sparse": cuda_ms(plain_dkv, reps=1, warmup=1),
    }
    docs = sorted({a for a, _ in qr} | {b for _, b in qr})
    cu = torch.tensor(docs, dtype=torch.int32, device="cuda")
    qb, kb_, vb = (x.detach().to(torch.bfloat16) for x in (q, k, v))
    lib_fwd, lib_name = library_attention(qb, kb_, vb, cu, int(torch.diff(cu).max()))
    lib_ms = cuda_ms(lib_fwd, reps=10)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qb, kb_, vb))
    lib_train, _ = library_attention(ql, kl, vl, cu, int(torch.diff(cu).max()))
    try:  # fwd + bwd minus fwd: the library's backward, dq, dk and dv together
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_train(), (ql, kl, vl), dout),
                             reps=10) - lib_ms
        lib_bwd_note = None
    except RuntimeError as exc:  # a yardstick only: its absence fails nothing
        lib_bwd_ms, lib_bwd_note = None, f"{type(exc).__name__}: {str(exc)[:120]}"
    in_bytes = 2 * (2 * t * hq * D + 2 * t * hk * D)  # q, dout (or out), k, v in bf16
    bounds = {
        fwd_name: bound(4.0 * area * D * hq, 2 * (t * hq * D + 2 * t * hk * D)
                        + 2 * t * hq * D + 4 * 2 * t * hq),
        "flex_dq_sparse": bound(6.0 * area * D * hq, in_bytes + 4 * 2 * t * hq + 4 * t * hq * D),
        "flex_dkv_sparse": bound(8.0 * area * D * hq, in_bytes + 4 * 2 * t * hq
                                 + 4 * 2 * t * hk * D),
    }
    times = {
        name: {"ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
               "bound_by": bounds[name][1],
               "library_ms": {fwd_name: lib_ms, "flex_dq_sparse": lib_bwd_ms}.get(name)}
        for name in ms
    }
    rm_twin = {fwd_name: "flex_fwd_hb" if hb > 1 else "flex_fwd", "flex_dq_sparse": "flex_dq",
               "flex_dkv_sparse": "flex_dkv"}
    summary.update({"card": nvidia_smi_line(), "ms": ms, "ms_in_turns": turns,
                    "previous_walk_ms": {n: mean[f"previous:{n}"] for n in new},
                    "speedup_over_previous_walk": {n: mean[f"previous:{n}"] / ms[n] for n in new},
                    "over_row_major_same_problem": {n: ms[n] / row_major_ms[rm_twin[n]]
                                                    for n in new},
                    "share_of_bound": {n: bounds[n][0] / ms[n] for n in ms},
                    "amla_every_rise_ms": {fwd_name: mean[f"every_rise:{fwd_name}"]},
                    "amla_every_rise_errs": every_rise_errs,
                    "fwd_over_library": ms[fwd_name] / lib_ms,
                    "kernels_ms_sum": sum(ms.values()), "fwd_bwd_event_ms": fwd_bwd_event_ms,
                    "index_order_ms": index_order_ms,
                    "row_major_ms_same_problem": row_major_ms, "plain_ms": plain_ms,
                    "bound_ms": {n: b[0] for n, b in bounds.items()},
                    "library": lib_name, "library_fwd_ms": lib_ms,
                    "library_bwd_ms_for_dq_dk_dv": lib_bwd_ms, "library_bwd_note": lib_bwd_note})
    return summary, launches, times


def hetero(gen, planted) -> tuple[dict, dict]:
    """The slice's path: ``flex_flash_attn_func`` with its defaults on the
    16k varlen block-causal mask at the LlamaConfig attention widths and at
    8 / 8 heads. Returns (the phase's line, the kernels' times)."""
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    qr, kr, ty = split_slices(varlen_block_causal(HETERO_T))
    runs, launches, times = [], {}, {}
    for hq, hk, expect_hb in HETERO_RUNS:
        summary, counts, t = hetero_run(gen, qr, kr, ty, hq, hk, expect_hb, planted, timed=True)
        runs.append(summary)
        times.update({n: x for n, x in t.items() if n not in times})
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
    check(runs[0]["pairs"] == 18_758_257, f"the 16k varlen mask has {runs[0]['pairs']} pairs")
    return {"phase": "hetero", "tokens": HETERO_T, "documents": len(qr), "head_dim": D,
            "runs": runs, "launches": launches}, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1
    from magiattention_tpu_torch import csrc

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    planted_procs = start_planted_build()  # nvcc runs beside the real build
    built = csrc.build(ptxas_verbose=True)
    for name in csrc.KERNELS:
        csrc.load(name)
    planted = planted_libraries(planted_procs)
    emit({
        "phase": "build",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "wall_s": time.perf_counter() - t0,
        "nvcc_s": {n: r["seconds"] for n, r in built.items()},
        "ptxas": {n: [ln.strip() for ln in r["log"].splitlines()
                      if "registers" in ln or "spill" in ln or "setmaxnreg" in ln
                      or (n == "paged_decode" and "entry function" in ln)]
                  for n, r in built.items()},
        "sass": {**{n: sass_counts(built[n]["path"]) for n in FLEX_KERNELS},
                 "paged_decode": sass_counts(built["paged_decode"]["path"], DECODE_SASS)},
    })
    print(nvidia_smi_line(), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flex_cases(gen)
    hb_line = hb_cases(gen)
    emit({"phase": "kernels", "kernel": "flex_fwd_hb", **hb_line})
    emit({"phase": "planted_faults", "case": "fwd_causal_2048",
          "caught": fwd_planted_faults(gen, planted)})
    sparse_cases(gen)
    emit(sparse_fwd_cases(gen))
    emit(sparse_bwd_cases(gen))
    fwd_t = flex_timing(gen, 4096, planted)
    bwd_t = bwd_timing(gen, sum(TRAIN_DOCS), planted)
    emit({"phase": "bwd_timing", **bwd_t})
    emit(decode_cases(gen))
    emit({"phase": "planted_faults", "case": "paged_decode",
          "caught": decode_planted_faults(gen, planted)})

    summary, engine, slots = serving(gen)
    emit(summary)
    dec_t = decode_timing(engine, slots, gen, planted)
    emit({"phase": "decode_timing", **dec_t})
    del engine
    torch.cuda.empty_cache()
    # multi-head widths (G = 1): the choice is head_block 1, the prefill flex_fwd
    mha, engine, _ = serving(gen, hq=HQ, hk=HQ, prompts=(2048, 3000), chunked=1, steps=8,
                             phase="serving_mha")
    emit(mha)
    del engine
    prefix_line = prefix(gen)
    emit(prefix_line)
    torch.cuda.empty_cache()

    train = training(args.seed)
    emit(train)
    torch.cuda.empty_cache()

    hetero_line, hetero_t = hetero(gen, planted)
    emit(hetero_line)

    # launches on the main paths: each path's counts were zeroed just before it
    by_path = {"serving": summary["launches"], "serving_mha": mha["launches"],
               "prefix": prefix_line["launches"], "training": train["launches"],
               "hetero": hetero_line["launches"]}
    times = {"flex_fwd": fwd_t["flex_fwd"], "flex_fwd_hb": fwd_t["flex_fwd_hb"],
             "flex_dq": bwd_t["flex_dq"], "flex_dkv": bwd_t["flex_dkv"],
             "paged_decode": dec_t, **hetero_t}
    sources = {
        "flex_fwd": ("flex_fwd.cu", "magiattention_tpu/ops/flex_attn.py:543"),
        "flex_fwd_hb": ("flex_fwd_hb.cu", "magiattention_tpu/ops/flex_attn.py:388"),
        "flex_fwd_sparse": ("flex_fwd_sparse.cu", "magiattention_tpu/ops/flex_attn.py:772"),
        "flex_fwd_sparse_hb": ("flex_fwd_sparse_hb.cu", "magiattention_tpu/ops/flex_attn.py:938"),
        "flex_dq": ("flex_dq.cu", "magiattention_tpu/ops/flex_attn.py:1168"),
        "flex_dq_sparse": ("flex_dq_sparse.cu", "magiattention_tpu/ops/flex_attn.py:1127"),
        "flex_dkv": ("flex_dkv.cu", "magiattention_tpu/ops/flex_attn.py:1397"),
        "flex_dkv_sparse": ("flex_dkv_sparse.cu", "magiattention_tpu/ops/flex_attn.py:1347"),
        "paged_decode": ("decode.cu", "magiattention_tpu/serving/decode_attn.py:284"),
    }
    check(set(sources) == set(csrc.KERNELS), f"the kernels line misses {set(csrc.KERNELS) - set(sources)}")
    kernels = []
    for name, (src, replaces) in sources.items():
        paths = {p: n[name] for p, n in by_path.items() if n.get(name)}
        check(bool(paths), f"{name} was launched on no main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"magiattention_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": MAX_ERR[name],
            **{k: times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
