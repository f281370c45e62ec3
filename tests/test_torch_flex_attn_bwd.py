"""The port's flex-attention backward (plain version, CPU) against the JAX
package's: ``jax.vjp`` of ``flex_flash_attn_func`` in Pallas interpret mode
pinned to the row-major grid with head_block=1 and 64x64 tiles (the path
that reaches ``_dq_pallas`` / ``_dkv_pallas``), and under the jnp reference
backend, against ``torch.autograd`` of the port's ``flex_flash_attn_func``.
Same float32 inputs and cotangents from a numpy seed; the cotangent of lse is
non-zero, so the first-class lse gradient is held too. dq, dk, dv and dsink
are each scored as the out component of ``divergence_report`` within the
float32 row of ``telemetry.numerics.DEFAULT_BUDGETS``: its absolute bound
on every entry, its whole row (relative and ulp bounds too) on the entries
of at least 1% of the tensor's largest magnitude. A gradient has entries
near zero, where a few ulps of an O(1) sum are a huge relative and ulp
distance that measures two float32 summation orders rather than the
algorithm; the forward tests sidestep that with positive ``v``, a gradient
has no such lever.

The plain backward is also held against ``torch.autograd`` through the
port's fp64 dense oracle ``ref_attn_from_ranges``, including local buffers
that hold global segments out of order (permuted runs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.ops import flex_attn_with_meta, flex_flash_attn_func
from magiattention_tpu_torch.ops.block_meta import Run, build_block_meta_general
from magiattention_tpu_torch.testing import ref_attn_from_ranges

from tests.test_torch_flex_attn import CASES, _inputs

BUDGET = DEFAULT_BUDGETS["float32"]
ABS_ONLY = dataclasses.replace(BUDGET, max_rel=float("inf"), max_ulp=float("inf"))
NEAR_ZERO = 1e-2  # of the tensor's largest magnitude


def _assert_grad_within_budget(ref, got, where):
    ref, got = np.asarray(ref), np.asarray(got)
    assert_within_budget(divergence_report(ref, got), ABS_ONLY, where=where)
    big = np.abs(ref) >= NEAR_ZERO * np.abs(ref).max()
    assert_within_budget(divergence_report(ref[big], got[big]), BUDGET, where=where)


def _cotangents(seed, tq, hq, d):
    rng = np.random.default_rng(seed)
    dout = rng.standard_normal((tq, hq, d)).astype(np.float32)
    dlse = rng.standard_normal((tq, hq)).astype(np.float32)
    return dout, dlse


@pytest.mark.parametrize("backend", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_jax(case, backend, monkeypatch):
    name, tq, tk, qr, kr, ty, hq, hk, d, opts = case
    q, k, v = _inputs(7, tq, tk, hq, hk, d)
    dout, dlse = _cotangents(11, tq, hq, d)
    softcap = opts.get("softcap", 0.0)
    sink = None if opts.get("sink") is None else np.asarray(opts["sink"], np.float32)
    jax_kw = dict(block_q=64, block_k=64, head_block=1, grid="row_major", softcap=softcap)
    if backend == "jnp":
        monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "jnp")
    else:
        jax_kw["interpret"] = True

    def jax_fn(q, k, v, s):
        return jax_flex(q, k, v, qr, kr, ty, sink=s, **jax_kw)

    primals = [jnp.asarray(x) for x in (q, k, v)] + ([jnp.asarray(sink)] if sink is not None else [None])
    _, vjp = jax.vjp(jax_fn, *primals)
    ref = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ts = None if sink is None else torch.from_numpy(sink).requires_grad_()
    out, lse = flex_flash_attn_func(tq_, tk_, tv_, qr, kr, ty, softcap=softcap, sink=ts)
    inputs = [tq_, tk_, tv_] + ([ts] if ts is not None else [])
    got = torch.autograd.grad((out, lse), inputs, (torch.from_numpy(dout), torch.from_numpy(dlse)))
    assert len(got) == (4 if sink is not None else 3)
    for what, r, g in zip(("dq", "dk", "dv", "dsink"), ref, got):
        _assert_grad_within_budget(r, g.numpy(), f"{name}/{backend}/{what}")


def _oracle_grads(q, k, v, qr, kr, ty, dout, dlse, fn, **kw):
    """(dq, dk, dv[, dsink]) of sum(out*dout) + sum(lse*dlse) over finite lse."""
    leaves = [q, k, v] + ([kw["sink"]] if kw.get("sink") is not None else [])
    out, lse = fn(q, k, v, qr, kr, ty, **kw)[:2]
    lse = torch.where(torch.isfinite(lse), lse, 0.0)
    return torch.autograd.grad((out * dout).sum() + (lse * dlse).sum(), leaves)


@pytest.mark.parametrize(
    "qr,kr,ty,softcap,sink",
    [
        ([(0, 60), (60, 140)], [(0, 60), (0, 140)], [1, 1], 0.0, None),
        ([(0, 70), (70, 140)], [(0, 140), (20, 120)], [0, 3], 5.0, None),
        ([(20, 100)], [(0, 90)], [1], 0.0, [0.5, -1.0, 2.0, 0.0]),
    ],
    ids=["varlen_causal", "full_bi_softcap", "uncovered_sink"],
)
def test_plain_backward_matches_fp64_autograd(qr, kr, ty, softcap, sink):
    q, k, v = (torch.from_numpy(x).double().requires_grad_() for x in _inputs(6, 140, 140, 4, 2, 32))
    dout, dlse = (torch.from_numpy(x).double() for x in _cotangents(3, 140, 4, 32))
    kw = {"softcap": softcap}
    if sink is not None:
        kw["sink"] = torch.tensor(sink, dtype=torch.float64, requires_grad=True)
    got = _oracle_grads(q, k, v, qr, kr, ty, dout, dlse, flex_flash_attn_func, **kw)
    ref = _oracle_grads(q, k, v, qr, kr, ty, dout, dlse, ref_attn_from_ranges, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-12, rtol=1e-10)


def test_plain_backward_over_permuted_runs_matches_oracle():
    """Local buffers holding global segments out of order: dq comes from the
    q-major table, dk/dv from the k-major one, both through run offsets."""
    qg, kg, vg = (torch.from_numpy(x).double() for x in _inputs(8, 200, 200, 4, 2, 32))
    dout, dlse = (torch.from_numpy(x).double() for x in _cotangents(5, 200, 4, 32))
    qr, kr, ty = [(0, 96), (96, 150), (150, 200)], [(0, 96), (0, 150), (20, 180)], [1, 0, 3]
    q_runs, k_runs = [(0, 100, 60), (60, 0, 70), (130, 160, 40)], [(0, 120, 80), (80, 0, 120)]
    q_idx = torch.cat([torch.arange(g, g + n) for _, g, n in q_runs])
    k_idx = torch.cat([torch.arange(g, g + n) for _, g, n in k_runs])
    slices = np.concatenate([np.asarray(qr), np.asarray(kr), np.asarray(ty)[:, None]], axis=1)
    meta = build_block_meta_general(slices, [Run(*r) for r in q_runs],
                                    [Run(*r) for r in k_runs], 170, 200,
                                    block_q=32, block_k=64)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qg[q_idx], kg[k_idx], vg[k_idx]))
    out, lse = flex_attn_with_meta(ql, kl, vl, meta)
    lse = torch.where(torch.isfinite(lse), lse, 0.0)
    got = torch.autograd.grad((out * dout[q_idx]).sum() + (lse * dlse[q_idx]).sum(), (ql, kl, vl))

    qg, kg, vg = (x.requires_grad_() for x in (qg, kg, vg))
    dout_g = torch.zeros_like(dout)
    dout_g[q_idx] = dout[q_idx]
    dlse_g = torch.zeros_like(dlse)
    dlse_g[q_idx] = dlse[q_idx]
    ref = _oracle_grads(qg, kg, vg, qr, kr, ty, dout_g, dlse_g, ref_attn_from_ranges)
    torch.testing.assert_close(got[0], ref[0][q_idx], atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(got[1], ref[1][k_idx], atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(got[2], ref[2][k_idx], atol=1e-12, rtol=1e-10)


def test_rowmax_is_not_differentiable():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(4, 64, 64, 2, 1, 32))
    out, lse, mx = flex_flash_attn_func(q, k, v, [(0, 64)], [(0, 64)], [1], return_max_logits=True)
    assert out.requires_grad and lse.requires_grad and not mx.requires_grad
