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
from tests.torch_jax_backend import jax_backend

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
        jax_backend(monkeypatch)
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


# -- the summation order of the Hopper backward kernels ---------------------------------


def _entry_p_ds(qt, kt, vt, dot, lse_t, delta_t, mask, scale, softcap):
    """One entry's p and ds [bq, bk] (float32), the per-logit core of
    ``csrc/flex_tile.cuh`` on one tile: 0 off the entry's mask."""
    z = qt @ kt.T * scale
    if softcap > 0.0:
        z = softcap * torch.tanh(z / softcap)
    lse_safe = torch.where(torch.isneginf(lse_t), 0.0, lse_t)
    p = torch.where(mask, torch.exp(z - lse_safe[:, None]), 0.0)
    ds = p * (dot @ vt.T - delta_t[:, None])
    if softcap > 0.0:
        ds = torch.where(mask, ds * (1.0 - (z / softcap) ** 2), 0.0)
    return p, ds


def _sm90_order_dq(q, k, v, do, lse, delta, ftab, scale, softcap, round_to, bq=64, bk=64):
    """``csrc/flex_dq.cu``'s sums in plain float32: per (q head, q block),
    dS rounded to bf16 before dS K; at even G one warpgroup walks the whole
    block, at odd G the s-th distinct k block of the walk goes to partial
    s % 2 and the two partials are added once at the end, then scaled."""
    from magiattention_tpu_torch.ops.flex_attn import _entry_tiles

    hq, tqp, d = q.shape
    group = hq // k.shape[0]
    tabs = tuple(t.long() for t in ftab[:5])
    rs, rc = ftab[5].tolist(), ftab[6].tolist()
    tiles = _entry_tiles(tabs, torch.arange(tabs[0].shape[0]), bq, bk)
    dq = torch.zeros((hq, tqp, d))
    for h in range(hq):
        for i in range(tqp // bq):
            rows = slice(i * bq, (i + 1) * bq)
            parts = [torch.zeros((bq, d)), torch.zeros((bq, d))]
            step, loaded = -1, -1
            for e in range(rs[i], rs[i] + rc[i]):
                kb = int(tabs[1][e])
                if kb != loaded:
                    loaded, step = kb, step + 1
                keys = slice(kb * bk, (kb + 1) * bk)
                kt = k[h // group, keys]
                _, ds = _entry_p_ds(q[h, rows], kt, v[h // group, keys], do[h, rows],
                                    lse[h, rows], delta[h, rows], tiles[e], scale, softcap)
                w = 0 if group % 2 == 0 else step % 2
                parts[w] += ds.to(round_to).float() @ kt
            dq[h, rows] = scale * (parts[0] + parts[1])
    return dq


def _sm90_order_dkv(q, k, v, do, lse, delta, btab, scale, softcap, round_to, bq=64, bk=64):
    """``csrc/flex_dkv.cu``'s sums in plain float32: per (kv head, k block),
    the (entry, q head) items in walk order, item n to partial n % 2; P and
    dS rounded to bf16 before their products; the two partials added once
    at the end (dK then scaled)."""
    from magiattention_tpu_torch.ops.flex_attn import _entry_tiles

    hk, tkp, d = k.shape
    group = q.shape[0] // hk
    kblk, qblk = (t.long() for t in btab[:2])
    tabs = (qblk, kblk, *(t.long() for t in btab[2:5]))
    rs, rc = btab[5].tolist(), btab[6].tolist()
    tiles = _entry_tiles(tabs, torch.arange(qblk.shape[0]), bq, bk)
    dk, dv = torch.zeros((hk, tkp, d)), torch.zeros((hk, tkp, d))
    for kvh in range(hk):
        for i in range(tkp // bk):
            keys = slice(i * bk, (i + 1) * bk)
            pk = [torch.zeros((bk, d)), torch.zeros((bk, d))]
            pv = [torch.zeros((bk, d)), torch.zeros((bk, d))]
            n = 0
            for e in range(rs[i], rs[i] + rc[i]):
                rows = slice(int(qblk[e]) * bq, (int(qblk[e]) + 1) * bq)
                for gi in range(group):
                    h = kvh * group + gi
                    p, ds = _entry_p_ds(q[h, rows], k[kvh, keys], v[kvh, keys], do[h, rows],
                                        lse[h, rows], delta[h, rows], tiles[e], scale, softcap)
                    pv[n % 2] += p.to(round_to).float().T @ do[h, rows]
                    pk[n % 2] += ds.to(round_to).float().T @ q[h, rows]
                    n += 1
            dk[kvh, keys] = scale * (pk[0] + pk[1])
            dv[kvh, keys] = pv[0] + pv[1]
    return dk, dv


@pytest.mark.parametrize("inputs", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case",
    [
        ("causal_g2", 256, 256, [(0, 256)], [(0, 256)], [1], 4, 2, 0.0),
        ("varlen_softcap_g1", 256, 256, [(0, 100), (100, 256)], [(0, 100), (100, 256)],
         [1, 1], 2, 2, 5.0),
        ("full_bi_shared_tiles_g3", 192, 256, [(0, 96), (96, 192)], [(0, 256), (32, 224)],
         [0, 3], 3, 1, 0.0),
        ("uncovered_rows_g1", 192, 192, [(40, 150)], [(0, 120)], [1], 2, 2, 0.0),
    ],
    ids=lambda c: c[0],
)
def test_sm90_summation_order_matches_jax_pallas(case, inputs):
    """The Hopper backward kernels' summation order (two partial sums per
    block, added once in a fixed order; P and dS rounded to the inputs'
    type before their products) against the JAX ``_dq_pallas`` /
    ``_dkv_pallas`` in interpret mode on the same inputs, which round at the
    same points. float32 inputs: nothing is rounded, the two differ by the
    order of their float32 sums alone, held to the whole float32 budget.
    bfloat16 inputs: both round P and dS to bf16, as the TPU kernels and the
    Hopper ones do, and a last-bit difference before the rounding may move a
    value by one bf16 step; every entry is held to the float32 budget's
    absolute bound."""
    from magiattention_tpu.ops import flex_attn as jfa
    from magiattention_tpu.ops.block_meta import build_block_meta as jax_build
    from magiattention_tpu_torch.ops import flex_attn as fa

    name, tq, tk, qr, kr, ty, hq, hk, softcap = case
    d, scale = 64, 1.0 / 8.0
    dtype, jdtype = getattr(torch, inputs), getattr(jnp, inputs)
    rng = np.random.default_rng(3)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    meta = fa.build_block_meta(qr, kr, ty, tq, tk, block_q=64, block_k=64)
    tqp, tkp = meta.num_q_blocks * 64, meta.num_k_blocks * 64
    q, do = (fa._pad_tokens(rand(hq, tq, d), tqp) for _ in range(2))
    k, v = (fa._pad_tokens(rand(hk, tk, d), tkp) for _ in range(2))
    ftab, btab = fa.fwd_tables(meta, "cpu"), fa.bwd_tables(meta, "cpu")
    params = fa.FlexAttnParams(64, 64, scale, softcap, False, torch.float32)
    out, lse, _ = fa._fwd_torch(q, k, v, torch.zeros(hq), ftab, params)
    dlse = torch.from_numpy(rng.standard_normal((hq, tqp)).astype(np.float32))
    delta = (do.float() * out).sum(-1) - dlse
    f32 = (q.float(), k.float(), v.float(), do.float(), lse, delta)
    got_dq = _sm90_order_dq(*f32, ftab, scale, softcap, dtype)
    got_dk, got_dv = _sm90_order_dkv(*f32, btab, scale, softcap, dtype)

    jmeta = jax_build(qr, kr, ty, tq, tk, block_q=64, block_k=64)
    jparams = jfa.FlexAttnParams(block_q=64, block_k=64, scale=scale, softcap=softcap,
                                 has_sink=False, out_dtype=inputs, interpret=True)
    lanes = (hq, tqp, jfa.LANES)
    jargs = tuple(jnp.asarray(t.float().numpy()).astype(jdtype) for t in (q, k, v, do)) + tuple(
        jnp.broadcast_to(jnp.asarray(t.numpy())[..., None], lanes) for t in (lse, delta))
    ref_dq = jfa._dq_pallas(*jargs, jfa.fwd_tables(jmeta), jparams)
    ref_dk, ref_dv = jfa._dkv_pallas(*jargs, jfa.bwd_tables(jmeta), jparams)
    for what, r, g in (("dq", ref_dq, got_dq), ("dk", ref_dk, got_dk), ("dv", ref_dv, got_dv)):
        cut = tq if what == "dq" else tk
        r, g = np.asarray(r)[:, :cut], g.numpy()[:, :cut]
        where = f"{name}/{inputs}/{what}"
        if inputs == "float32":
            _assert_grad_within_budget(r, g, where)
        else:
            assert_within_budget(divergence_report(r, g), ABS_ONLY, where=where)


def test_walk_order_visits_every_block_once():
    """The launch order of the row-major backward kernels: a permutation of
    the blocks (each launched once), longest walk first, ties in index
    order; on a causal mask the q blocks last to first (dq) and the k blocks
    first to last (dkv)."""
    from magiattention_tpu_torch.ops import flex_attn as fa

    rng = np.random.default_rng(0)
    for n in (1, 7, 130):
        rc = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
        order = fa.walk_order(rc)
        assert order.dtype == torch.int32
        assert sorted(order.tolist()) == list(range(n))
        lens = rc[order.long()].tolist()
        assert lens == sorted(lens, reverse=True)
        for a, b in zip(order.tolist(), order.tolist()[1:]):
            assert rc[a] > rc[b] or a < b
    meta = fa.build_block_meta([(0, 640)], [(0, 640)], [1], 640, 640, block_q=64, block_k=64)
    for tabs in (fa.fwd_tables(meta, "cpu"), fa.bwd_tables(meta, "cpu")):
        rc = tabs[6].tolist()
        assert fa.walk_order(tabs[6]).tolist() == sorted(range(10), key=lambda i: (-rc[i], i))
    # causal: the q blocks' walks grow down the mask, the k blocks' shrink
    assert fa.walk_order(fa.fwd_tables(meta, "cpu")[6]).tolist()[:8] == list(range(9, 1, -1))
    assert fa.walk_order(fa.bwd_tables(meta, "cpu")[6]).tolist()[:8] == list(range(8))


def test_tma_alignment_is_checked():
    """The row-major backward kernels read q/k/v/dout through TMA tensor
    maps and lse/delta with bulk copies: a base off 16 bytes raises before
    any launch, naming the tensor."""
    from magiattention_tpu_torch.ops import flex_attn as fa

    buf = torch.zeros(4 * 64 * 64 + 8, dtype=torch.bfloat16)
    fa._check_tma_aligned("flex_dq", {"q": buf[:-8], "k": buf[8:]})  # 0 and 16 bytes in
    with pytest.raises(ValueError, match="flex_dkv: lse .* 16-byte"):
        fa._check_tma_aligned("flex_dkv", {"q": buf[:-8], "lse": buf[1:].view(-1)[:64]})
