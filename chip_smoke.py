#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``magiattention_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. build — compile the four Hopper kernels (``flex_fwd``, ``flex_dq``,
   ``flex_dkv``, ``paged_decode``) from the sources in
   ``magiattention_tpu_torch/csrc/`` with nvcc for sm_90a, all at once, and
   print the card's name and power limit as nvidia-smi reports them;
2. kernels — each kernel against its plain PyTorch version on the card, in
   bf16 at head_dim 128, on the mask families and ragged lengths below
   (the backward with 4 and with 2 q heads per kv head and a random lse
   cotangent, and twice, for the same bits), each with its stated
   tolerance; faults planted in the backward kernels' walks, which the
   gradient checks must catch; then the kernels' times at their main path's shapes beside
   the plain version's, a PyTorch ``scaled_dot_product_attention``
   yardstick and the card's bound;
3. serving — the port's serving path at Llama-3.1-8B attention widths
   (32 q heads, 8 kv heads, head_dim 128, bf16, page size 128): admit 8
   requests, prefill them (one chunked, so the continuation path runs), run
   64 decode steps over the batch, and hold prefill outputs (prompts up to
   4096 tokens) and every 8th decode step against the plain versions;
4. training — the port's Llama trainer at the widths of the repo's
   ``LlamaConfig`` (vocab 32000, dim 2048, 16 q / 8 kv heads, head_dim 128,
   ffn 5632, bf16 compute, fp32 masters), cut from 16 to 4 layers, on one
   8192-token stream packed as documents [4096, 2048, 2048]: 6 AdamW steps
   on a fixed batch from ``--seed``, one layer's attention call of the
   first step held against the plain forward and backward.

The line before the last lists the four kernels with their launches on the
main paths, errors and times; the last line is
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
# the largest out (or gradient) error of each kernel over every comparison
MAX_ERR = {"flex_fwd": 0.0, "flex_dq": 0.0, "flex_dkv": 0.0, "paged_decode": 0.0}
SERVING_KERNELS = ("flex_fwd", "paged_decode")
TRAINING_KERNELS = ("flex_fwd", "flex_dq", "flex_dkv")


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def compare(kernel, name, out, ref_out, lse=None, ref_lse=None, extra=None):
    """Out within OUT_ATOL + OUT_RTOL*|ref|, lse (and ``extra`` pairs)
    within LSE_ATOL with -inf exactly where the plain version has it."""
    import torch

    out, ref_out = out.float(), ref_out.float()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite out")
    err = (out - ref_out).abs()
    bad = err > OUT_ATOL + OUT_RTOL * ref_out.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    rec = {"case": name, "out_max_abs_err": max_err}
    check(not bool(bad.any()), f"{name}: out max abs err {max_err} over tolerance")
    pairs = [("lse", lse, ref_lse)] + [(k, g, r) for k, (g, r) in (extra or {}).items()]
    for key, got, ref in pairs:
        if got is None:
            continue
        got, ref = got.float(), ref.float()
        check(
            bool((torch.isneginf(got) == torch.isneginf(ref)).all()),
            f"{name}: {key} -inf rows differ",
        )
        fin = torch.isfinite(ref)
        e = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
        rec[f"{key}_max_abs_err"] = e
        check(e <= LSE_ATOL, f"{name}: {key} max abs err {e} > {LSE_ATOL}")
    emit({"phase": "kernels", "kernel": kernel, **rec})
    MAX_ERR[kernel] = max(MAX_ERR[kernel], max_err)


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
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


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
                 softcap=0.0, sink=None):
        import torch
        from magiattention_tpu_torch.ops import flex_attn as fa

        self.tq, self.tk = tq, tk
        bq, bk = fa.resolve_tile(D, None, None)
        self.meta = fa.build_block_meta(q_ranges, k_ranges, types, tq, tk,
                                        block_q=bq, block_k=bk)
        tqp = self.meta.num_q_blocks * bq
        tkp = self.meta.num_k_blocks * bk

        def rand(t, h, tp):
            x = torch.randn((h, t, D), generator=gen, device="cuda")
            return fa._pad_tokens(x.to(torch.bfloat16), tp)

        self.q, self.k, self.v = rand(tq, hq, tqp), rand(tk, hk, tkp), rand(tk, hk, tkp)
        self.sink = (
            torch.full((hq,), 0.0, device="cuda") if sink is None
            else torch.as_tensor(sink, dtype=torch.float32, device="cuda")
        )
        self.params = fa.FlexAttnParams(
            block_q=bq, block_k=bk, scale=1.0 / math.sqrt(D), softcap=softcap,
            has_sink=sink is not None, out_dtype=torch.bfloat16,
        )
        self.tables = fa.fwd_tables(self.meta, "cuda:0")
        self.btables = fa.bwd_tables(self.meta, "cuda:0")
        self.do = rand(tq, hq, tqp)
        self.dlse = torch.randn((hq, tqp), generator=gen, device="cuda")
        self._bwd = None

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

    def planted_faults(self) -> dict:
        """The gradient checks on three faults planted in the kernels'
        work: the last entry of each q-major walk skipped (dq), the last
        entry of each k-major walk skipped (dk, dv), and the last k block's
        dk and dv zeroed. Returns, per fault and tensor, which checks catch
        it; a fault that the three checks together let through fails the
        smoke. Nothing here is counted as a main-path launch."""
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
        torch.cuda.synchronize()
        plants = {
            "skip_last_q_walk_entry": [("dq", dq_skip[:, :tq], ref_dq)],
            "skip_last_k_walk_entry": [("dk", dk_skip[:, :tk], ref_dk),
                                       ("dv", dv_skip[:, :tk], ref_dv)],
            "zero_last_k_block": [("dk", dk, ref_dk), ("dv", dv, ref_dv)],
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
        import torch

        out, lse, rowmax = self.kernel()
        torch.cuda.synchronize()
        ref_out, ref_lse, ref_rowmax = self.plain()
        tq = self.tq
        compare("flex_fwd", name, out[:, :tq], ref_out[:, :tq], lse[:, :tq],
                       ref_lse[:, :tq], {"rowmax": (rowmax[:, :tq], ref_rowmax[:, :tq])})


def flex_cases(gen) -> None:
    """The forward with 4 q heads per kv head, the backward with 4 and 2."""
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
    for name, tq, tk, qr, kr, ty, kw in cases:
        p = Flex(gen, tq, tk, hq, 2, qr, kr, ty, **kw)
        p.check(name)
        p.check_bwd(f"{name}_bwd_g4")
        Flex(gen, tq, tk, hq, 4, qr, kr, ty, **kw).check_bwd(f"{name}_bwd_g2")


def flex_timing(gen, t: int) -> dict:
    """Kernel, plain version and SDPA on one causal prefill at the serving
    widths, plus the card's bound for that work."""
    import torch
    import torch.nn.functional as Fn

    p = Flex(gen, t, t, HQ, HK, [(0, t)], [(0, t)], [1])
    p.check(f"flex_causal_{t}_serving_widths")
    ms = cuda_ms(p.kernel, reps=20)
    plain_ms = cuda_ms(p.plain, reps=3, warmup=1)
    q = p.q[:, :t].unsqueeze(0)
    k = p.k[:, :t].unsqueeze(0)
    v = p.v[:, :t].unsqueeze(0)
    lib_ms = cuda_ms(
        lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        reps=20,
    )
    flops = 4.0 * p.meta.total_area * D * HQ
    nbytes = 2 * (2 * t * HQ * D + 2 * t * HK * D) + 4 * 2 * t * HQ
    bound_ms, bound_by = bound(flops, nbytes)
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def bwd_timing(gen, t: int) -> dict:
    """Both backward kernels and their plain versions on one causal
    sequence at the training widths, each kernel's bound from its own work,
    and the backward of PyTorch's ``scaled_dot_product_attention`` on the
    same problem (fwd+bwd minus fwd) as a yardstick for the pair."""
    import torch
    import torch.nn.functional as Fn

    hq, hk = TRAIN_HQ, TRAIN_HK
    p = Flex(gen, t, t, hq, hk, [(0, t)], [(0, t)], [1])
    p.check_bwd(f"flex_bwd_causal_{t}_training_widths")
    emit({"phase": "planted_faults", "case": f"flex_bwd_causal_{t}_training_widths",
          "caught": p.planted_faults()})
    dq_ms = cuda_ms(p.dq_kernel, reps=10)
    dkv_ms = cuda_ms(p.dkv_kernel, reps=10)
    dq_plain_ms = cuda_ms(p.dq_plain, reps=2, warmup=1)
    dkv_plain_ms = cuda_ms(p.dkv_plain, reps=2, warmup=1)
    q, k, v = (x[:, :t].unsqueeze(0).detach().requires_grad_() for x in (p.q, p.k, p.v))
    do = p.do[:, :t].unsqueeze(0)

    def fwd():
        return Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), do)

    fwd_ms = cuda_ms(p.kernel, reps=10)
    sdpa_fwd_ms = cuda_ms(fwd, reps=10)
    sdpa_bwd_ms = cuda_ms(fwd_bwd, reps=10) - sdpa_fwd_ms
    area = p.meta.total_area
    in_bytes = 2 * (2 * t * hq * D + 2 * t * hk * D) + 4 * 2 * t * hq  # q, do, k, v; lse, delta
    dq_bound = bound(6.0 * area * D * hq, in_bytes + 4 * t * hq * D)
    dkv_bound = bound(8.0 * area * D * hq, in_bytes + 4 * 2 * t * hk * D)
    return {
        "tokens": t, "hq": hq, "hk": hk, "area": area,
        "flex_dq": {"ms": dq_ms, "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
                    "bound_by": dq_bound[1], "library_ms": sdpa_bwd_ms},
        "flex_dkv": {"ms": dkv_ms, "plain_ms": dkv_plain_ms, "bound_ms": dkv_bound[0],
                     "bound_by": dkv_bound[1], "library_ms": None},
        "sdpa_bwd_ms_for_the_pair": sdpa_bwd_ms,
        "flex_fwd_ms_same_problem": fwd_ms,
        "sdpa_fwd_ms_same_problem": sdpa_fwd_ms,
    }


# -- paged decode: kernel vs plain ------------------------------------------


def decode_cache(gen, lengths):
    """A bf16 cache at the serving widths holding one random sequence per
    slot, every slot owning max_pages_per_seq pages (page 0 unused)."""
    import torch
    from magiattention_tpu_torch.serving import (
        assign_block_table, make_paged_kv_cache, write_prefill_kv,
    )

    mpp = 64
    cache = make_paged_kv_cache(len(lengths) * mpp + 1, PAGE, HK, D,
                                max_seqs=len(lengths), max_pages_per_seq=mpp)
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, list(range(1 + slot * mpp, 1 + (slot + 1) * mpp)))
        kv = torch.randn((2, n, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    return cache


def decode_cases(gen) -> None:
    import torch
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


def decode_timing(engine, slots, gen) -> dict:
    """Kernel, plain version and SDPA over the gathered KV, on the serving
    path's final batch state, plus the card's bound for that work."""
    import torch
    import torch.nn.functional as Fn
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import gather_kv

    cache = engine.cache
    b = len(slots)
    idx = torch.as_tensor(slots, device="cuda")
    bt, seq_lens = cache.block_tables[idx], cache.seq_lens[idx]
    splits = da.resolve_num_splits(None, cache, b)
    params = da.DecodeParams(1.0 / math.sqrt(D), 0.0, splits, torch.bfloat16)
    q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    ms = cuda_ms(lambda: da._decode_partials_kernel(q, cache, bt, seq_lens, params), reps=50)
    plain_ms = cuda_ms(lambda: da._decode_torch(q, cache, bt, seq_lens, params), reps=5, warmup=1)
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
    flops = 4.0 * tokens * HQ * D
    nbytes = (2 * 2 * tokens * HK * D + 2 * b * HQ * D
              + 4 * b * splits * HQ * (D + 1) + 4 * (bt.numel() + b))
    bound_ms, bound_by = bound(flops, nbytes)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "splits": splits, "cached_tokens": tokens}


# -- the serving path ----------------------------------------------------------


def plain_causal_prefill(q, k, v):
    """The plain version of a one-shot causal prefill ([t, h, d] layout)."""
    from magiattention_tpu_torch.ops import flex_attn as fa

    t = q.shape[0]
    bq, bk = fa.resolve_tile(D, None, None)
    meta = fa.build_block_meta([(0, t)], [(0, t)], [1], t, t, block_q=bq, block_k=bk)
    tp = meta.num_q_blocks * bq
    params = fa.FlexAttnParams(bq, bk, 1.0 / math.sqrt(D), 0.0, False, q.dtype)
    sink = q.new_zeros((q.shape[1],), dtype=q.dtype).float()
    out, lse, _ = fa._fwd_torch(
        fa._pad_tokens(q.transpose(0, 1), tp), fa._pad_tokens(k.transpose(0, 1), tp),
        fa._pad_tokens(v.transpose(0, 1), tp), sink, fa.fwd_tables(meta, str(q.device)),
        params,
    )
    return out.transpose(0, 1)[:t], lse.transpose(0, 1)[:t]


def serving(gen) -> tuple[dict, object, list[int]]:
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import ServingEngine, decode_reference

    prompts = [1000, 1733, 2048, 2900, 4096, 5120, 6500, 8000]
    chunked = 3  # the 2900-token prompt is prefilled in 2048-token chunks
    steps = 64
    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    csrc.reset_launch_counts()
    slots, prefill_ms, checked = [], [], []
    for i, t in enumerate(prompts):
        res = engine.admit(t)
        check(res.admitted, f"admission of a {t}-token prompt refused: {res.reason}")
        q = torch.randn((t, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn((2, t, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
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
        check(out.shape == (t, HQ, D) and bool(torch.isfinite(out).all()),
              f"prefill {t}: bad output")
        if t <= 4096:
            ref_out, ref_lse = plain_causal_prefill(q, kv[0], kv[1])
            compare("flex_fwd", f"serving_prefill_{t}" + ("_chunked" if i == chunked else ""),
                    out, ref_out, lse, ref_lse)
            checked.append(t)
        slots.append(res.slot)

    step_ms = []
    for step in range(steps):
        q = torch.randn((len(slots), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn((2, len(slots), HK, D), generator=gen, device="cuda").to(torch.bfloat16)
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
            compare("paged_decode", f"serving_decode_step{step}", out, ref_out, lse, ref_lse)
    lengths = [engine.length(s) for s in slots]
    check(lengths == [t + steps for t in prompts], f"final lengths {lengths}")
    launches = {n: csrc.launches[n] for n in SERVING_KERNELS}
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    decode_s = sum(step_ms) / 1e3
    summary = {
        "phase": "serving",
        "prompts": prompts,
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
    compare("flex_fwd", "training_layer0_step0", cap["out"], ref_out[:, :t].transpose(0, 1),
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
    ("attention kernels", ("flex_fwd_kernel", "flex_dq_kernel", "flex_dkv_kernel")),
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
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (total,), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1)  # the next token
    pos = torch.arange(total, device="cuda")  # global position ids
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))

    cap = {}

    def capture(q, k, v):
        """The model's attention, holding on to the first call's operands,
        results and gradients (no extra launch)."""
        out, lse = flex_attn_with_meta(q, k, v, model.meta, out_dtype=cfg.torch_dtype)
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
    launches = {n: csrc.launches[n] for n in TRAINING_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    expected = TRAIN_LAYERS * TRAIN_STEPS
    check(all(n == expected for n in launches.values()),
          f"training launches {launches}, expected {expected} of each")
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
    built = csrc.build(ptxas_verbose=True)
    for name in csrc.KERNELS:
        csrc.load(name)
    emit({
        "phase": "build",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "wall_s": time.perf_counter() - t0,
        "nvcc_s": {n: r["seconds"] for n, r in built.items()},
        "ptxas": {n: [ln.strip() for ln in r["log"].splitlines()
                      if "registers" in ln or "spill" in ln] for n, r in built.items()},
    })
    print(nvidia_smi_line(), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flex_cases(gen)
    flex_t = flex_timing(gen, 4096)
    bwd_t = bwd_timing(gen, sum(TRAIN_DOCS))
    emit({"phase": "bwd_timing", **bwd_t})
    decode_cases(gen)

    summary, engine, slots = serving(gen)
    emit(summary)
    dec_t = decode_timing(engine, slots, gen)
    emit({"phase": "decode_timing", **dec_t})
    del engine

    train = training(args.seed)
    emit(train)

    # launches on the main paths: each path's counts were zeroed just before it
    by_path = {"serving": summary["launches"], "training": train["launches"]}
    times = {"flex_fwd": flex_t, "flex_dq": bwd_t["flex_dq"], "flex_dkv": bwd_t["flex_dkv"],
             "paged_decode": dec_t}
    sources = {
        "flex_fwd": ("flex_fwd.cu", "magiattention_tpu/ops/flex_attn.py:543"),
        "flex_dq": ("flex_dq.cu", "magiattention_tpu/ops/flex_attn.py:1168"),
        "flex_dkv": ("flex_dkv.cu", "magiattention_tpu/ops/flex_attn.py:1397"),
        "paged_decode": ("decode.cu", "magiattention_tpu/serving/decode_attn.py:284"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        paths = {p: n[name] for p, n in by_path.items() if name in n}
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
