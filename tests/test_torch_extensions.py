"""The port's extensions (``extensions/``) against the JAX package's and the
dense oracle: the JAX package's own cases (``tests/test_extensions/
test_extensions.py``) on the port, and the two packages on the same numpy
inputs.

``flash_attention_with_sink``: every layout (``sh`` per head and with S > 1
tokens, ``ssh`` batched and shared, ``shd``), causal, sliding window, the
zero sink that is not plain attention, the bad-layout refusals, the batch as
one packed flex call; out, lse and the gradients (dsink included) against
JAX's per-sequence call within the float32 row of ``DEFAULT_BUDGETS``.
DSA: full top-k equal to dense causal attention, the indexer's selection
equal to JAX's on the test seeds, a passed selection reused, a short KV
leaking no future block, and ``dsa_attn_func`` against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import extensions as jext
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.api.functools import infer_attn_mask_from_sliding_window
from magiattention_tpu_torch.extensions import (
    dsa_attn_func,
    dsa_topk_blocks,
    flash_attention_with_sink,
)
from magiattention_tpu_torch.extensions import sink_attention
from magiattention_tpu_torch.testing import assert_close, ref_attn, ref_attn_from_ranges

from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget

BUDGET = DEFAULT_BUDGETS["float32"]
TOL = dict(atol=3e-5, rtol=3e-5)


def _qkv(b, t, hq, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, t, hq, d), (b, t, hk, d), (b, t, hk, d)))


def _qkv_pos(b, t, hq, hk, d, seed=0):
    """q, k normal, v positive: outputs (convex combinations of v) stay away
    from zero, where the budget's ulp and relative bounds would measure two
    float32 summation orders (as ``tests/test_torch_flex_attn.py``)."""
    q, k, _ = _qkv(b, t, hq, hk, d, seed)
    v = np.random.default_rng(seed + 100).uniform(0.5, 1.5, (b, t, hk, d)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


# -- the JAX package's cases on the port -------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_sink_wrapper_matches_oracle(causal):
    b, t, hq, hk, d = 2, 256, 4, 2, 32
    q, k, v = _t(*_qkv(b, t, hq, hk, d))
    sink = torch.tensor([0.5, -0.3, 0.1, 0.9])
    out = flash_attention_with_sink(q, k, v, sink, causal=causal)
    for i in range(b):
        ref, _, _ = ref_attn_from_ranges(q[i], k[i], v[i], [(0, t)], [(0, t)], [int(causal)],
                                         sink=sink)
        assert_close(out[i], ref, msg=f"batch {i}", **TOL)


def test_sink_wrapper_zero_sink_is_not_plain_attention():
    b, t, hq, hk, d = 1, 128, 2, 2, 32
    q, k, v = _t(*_qkv(b, t, hq, hk, d))
    out = flash_attention_with_sink(q, k, v, torch.zeros(hq), causal=True)
    ref_plain, ref_lse, _ = ref_attn_from_ranges(q[0], k[0], v[0], [(0, t)], [(0, t)], [1])
    resc = torch.exp(ref_lse - torch.logaddexp(ref_lse, torch.zeros(()).double()))[..., None]
    assert_close(out[0], ref_plain * resc, **TOL)
    assert not torch.allclose(out[0].double(), ref_plain, atol=1e-3)


def test_sink_wrapper_sliding_window():
    b, t, hq, hk, d = 1, 256, 2, 2, 32
    q, k, v = _t(*_qkv(b, t, hq, hk, d))
    sink = torch.tensor([0.2, -0.4])
    out = flash_attention_with_sink(q, k, v, sink, window=64)
    qr, kr, ts = infer_attn_mask_from_sliding_window(t, 64)
    ref, _, _ = ref_attn_from_ranges(q[0], k[0], v[0], qr.to_naive_ranges(),
                                     kr.to_naive_ranges(), [int(x) for x in ts], sink=sink)
    assert_close(out[0], ref, **TOL)


def test_sink_wrapper_sh_multi_token():
    b, t, hq, hk, d = 1, 128, 2, 2, 32
    q, k, v = _t(*_qkv(b, t, hq, hk, d))
    sink = torch.from_numpy(np.random.default_rng(5).standard_normal((3, hq)).astype(np.float32))
    out, lse = flash_attention_with_sink(q, k, v, sink, sink_layout="sh", causal=True,
                                         return_lse=True)
    ref, ref_lse, _ = ref_attn_from_ranges(q[0], k[0], v[0], [(0, t)], [(0, t)], [1])
    lse_exp = torch.logaddexp(ref_lse, torch.logsumexp(sink.double(), dim=0)[None, :])
    assert_close(lse[0], lse_exp, **TOL)
    assert_close(out[0], ref * torch.exp(ref_lse - lse_exp)[..., None], **TOL)


@pytest.mark.parametrize("batched", [True, False], ids=["b_sq_s_h", "sq_s_h"])
def test_sink_wrapper_ssh_per_row(batched):
    b, t, hq, hk, d = 2, 128, 2, 2, 32
    q, k, v = _t(*_qkv(b, t, hq, hk, d))
    shape = (b, t, 2, hq) if batched else (t, 2, hq)
    sink = torch.from_numpy(np.random.default_rng(6).standard_normal(shape).astype(np.float32))
    out, lse = flash_attention_with_sink(q, k, v, sink, sink_layout="ssh", causal=True,
                                         return_lse=True)
    for i in range(b):
        ref, ref_lse, _ = ref_attn_from_ranges(q[i], k[i], v[i], [(0, t)], [(0, t)], [1])
        lse_exp = torch.logaddexp(ref_lse, torch.logsumexp((sink[i] if batched else sink).double(),
                                                           dim=1))
        assert_close(lse[i], lse_exp, **TOL)
        assert_close(out[i], ref * torch.exp(ref_lse - lse_exp)[..., None], msg=f"batch {i}",
                     **TOL)


def test_sink_wrapper_shd_appended_token_oracle():
    """shd equals dense attention over KV extended with S zero-key tokens
    carrying the sink values, every row seeing them."""
    b, t, hq, hk, d, s = 1, 128, 2, 2, 32, 2
    q, k, v = _t(*_qkv(b, t, hq, hk, d))
    sink = torch.from_numpy(np.random.default_rng(7).standard_normal((s, hq, d)).astype(np.float32))
    out, lse = flash_attention_with_sink(q, k, v, sink, sink_layout="shd", causal=True,
                                         return_lse=True)
    k_ext = torch.cat([k[0], torch.zeros(s, hk, d)])
    v_ext = torch.cat([v[0], sink])
    mask = np.zeros((t, t + s), dtype=bool)
    mask[:, :t] = np.tril(np.ones((t, t), dtype=bool))
    mask[:, t:] = True
    ref, ref_lse, _ = ref_attn(q[0], k_ext, v_ext, mask)
    assert_close(lse[0], ref_lse, **TOL)
    assert_close(out[0], ref, **TOL)


def test_sink_wrapper_bad_layout_shape_rejected():
    q, k, v = _t(*_qkv(1, 64, 2, 2, 32))
    with pytest.raises(ValueError, match="invalid for"):
        flash_attention_with_sink(q, k, v, torch.zeros(3, 3), sink_layout="sh")
    with pytest.raises(ValueError, match="sink_layout"):
        flash_attention_with_sink(q, k, v, torch.zeros(2), sink_layout="hsd")
    with pytest.raises(ValueError, match=r"\[b, s, h, d\]"):
        flash_attention_with_sink(q[0], k[0], v[0], torch.zeros(2))


def test_dsa_full_topk_equals_dense():
    t, hq, hk, d = 256, 2, 2, 32
    q, k, v = (x[0] for x in _t(*_qkv(1, t, hq, hk, d, seed=1)))
    out, lse = dsa_attn_func(q, k, v, topk=t // 64, causal=True, block_q=64, block_k=64)
    ref, ref_lse, _ = ref_attn_from_ranges(q, k, v, [(0, t)], [(0, t)], [1])
    assert_close(out, ref, **TOL)
    assert_close(lse, ref_lse, **TOL)


def test_dsa_sparse_selection_matches_manual_oracle():
    t, hq, hk, d, bq, topk = 512, 2, 2, 32, 64, 3
    q, k, v = (x[0] for x in _t(*_qkv(1, t, hq, hk, d, seed=2)))
    sel = dsa_topk_blocks(q, k, topk, block_q=bq, block_k=bq, causal=True)
    nq = t // bq
    assert sel.shape == (nq, topk)
    for i in range(nq):
        kept = sel[i][sel[i] >= 0]
        assert i in kept and (kept <= i).all()
    out, _ = dsa_attn_func(q, k, v, topk=topk, causal=True, kv_block_indices=sel, block_q=bq,
                           block_k=bq)
    qr, kr, ts = [], [], []
    for i in range(nq):
        for j in sorted(sel[i][sel[i] >= 0]):
            q0, q1, k0, k1 = i * bq, (i + 1) * bq, int(j) * bq, (int(j) + 1) * bq
            ts.append(0 if k1 - 1 <= q0 else 1)
            qr.append((q0, q1))
            kr.append((k0, k1 if k1 - 1 <= q0 else min(k1, q1)))
    ref, _, _ = ref_attn_from_ranges(q, k, v, qr, kr, ts)
    assert_close(out, ref, **TOL)


def test_dsa_selection_reuse():
    t, hq, hk, d = 256, 2, 2, 32
    q, k, v = (x[0] for x in _t(*_qkv(1, t, hq, hk, d, seed=3)))
    sel = dsa_topk_blocks(q, k, 2, block_q=64, block_k=64, causal=True)
    kw = dict(topk=2, causal=True, kv_block_indices=sel, block_q=64, block_k=64)
    o1, _ = dsa_attn_func(q, k, v, **kw)
    o2, _ = dsa_attn_func(q, 2 * k, v, **kw)  # the same selection, other keys
    assert o1.shape == o2.shape and not torch.allclose(o1, o2)
    np.testing.assert_array_equal(dsa_topk_blocks(q, k, 2, block_q=64, block_k=64), sel)


def test_dsa_topk_short_kv_no_causal_leak():
    tq, tk, hq, d = 512, 128, 2, 32
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((tq, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((tk, hq, d)).astype(np.float32))
    sel = dsa_topk_blocks(q, k, 1, block_q=128, block_k=128, causal=True)
    off = tk - tq
    for i in range(sel.shape[0]):
        q_hi = (i + 1) * 128 - 1
        kept = sel[i][sel[i] >= 0]
        if q_hi + off < 0:
            assert len(kept) == 0, f"q block {i} sees no keys but selected"
        else:
            assert (kept * 128 <= q_hi + off).all(), "future block selected"


# -- the two packages on the same inputs -------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk,bq,bk", [(512, 512, 64, 64), (384, 512, 128, 64),
                                         (512, 128, 128, 128)])
def test_dsa_selection_is_jaxs(tq, tk, bq, bk, causal, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((tk, 2, 32)).astype(np.float32)
    got = dsa_topk_blocks(torch.from_numpy(q), torch.from_numpy(k), 3, block_q=bq, block_k=bk,
                          causal=causal)
    want = jext.dsa_topk_blocks(jnp.asarray(q), jnp.asarray(k), 3, block_q=bq, block_k=bk,
                                causal=causal)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _vs_jax(jax_fn, port_fn, inputs, dout, dlse):
    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in inputs))
    dl = np.where(np.isfinite(np.asarray(jl)), dlse, 0.0).astype(np.float32)
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dl)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out, lse = port_fn(*leaves)
    grads = torch.autograd.grad((out, lse), leaves, (torch.from_numpy(dout), torch.from_numpy(dl)))
    assert_within_budget(divergence_report(np.asarray(jo), out.detach().numpy(),
                                           ref_lse=np.asarray(jl), test_lse=lse.detach().numpy()),
                         BUDGET)
    for i, (r, g) in enumerate(zip(jgrads, grads)):
        _assert_grad_within_budget(r, g.numpy(), f"grad {i}")


def test_dsa_attn_matches_jax():
    t, hq, hk, d = 384, 4, 2, 32
    q, k, v = (x[0] for x in _qkv_pos(1, t, hq, hk, d, seed=8))
    rng = np.random.default_rng(9)
    dout = rng.standard_normal((t, hq, d)).astype(np.float32)
    dlse = rng.standard_normal((t, hq)).astype(np.float32)
    # JAX's indexer needs concrete (q, k): select once, outside its vjp
    sel = jext.dsa_topk_blocks(jnp.asarray(q), jnp.asarray(k), 2, block_q=128, block_k=64)
    kw = dict(topk=2, causal=True, block_q=128, block_k=64)
    _vs_jax(lambda q, k, v: jext.dsa_attn_func(q, k, v, kv_block_indices=sel, **kw),
            lambda q, k, v: dsa_attn_func(q, k, v, **kw), (q, k, v), dout, dlse)


SINKS = {  # layout -> sink shape at (b, t, hq, d)
    "sh_per_head": ("sh", lambda b, t, h, d: (h,)),
    "sh_tokens": ("sh", lambda b, t, h, d: (3, h)),
    "ssh": ("ssh", lambda b, t, h, d: (b, t, 2, h)),
    "shd": ("shd", lambda b, t, h, d: (2, h, d)),
}


@pytest.mark.parametrize("mask", ["causal", "window", "full"])
@pytest.mark.parametrize("sink_name", list(SINKS))
def test_sink_wrapper_matches_jax(sink_name, mask):
    b, t, hq, hk, d = 2, 192, 4, 2, 32
    layout, shape = SINKS[sink_name]
    q, k, v = _qkv_pos(b, t, hq, hk, d, seed=10)
    rng = np.random.default_rng(11)
    sink = rng.standard_normal(shape(b, t, hq, d)).astype(np.float32)
    if layout == "shd":  # sink values join the output: positive, as v
        sink = np.abs(sink) + 0.5
    dout = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    dlse = rng.standard_normal((b, t, hq)).astype(np.float32)
    kw = dict(sink_layout=layout, causal=mask == "causal",
              window=48 if mask == "window" else None, return_lse=True)
    _vs_jax(lambda q, k, v, s: jext.flash_attention_with_sink(q, k, v, s, **kw),
            lambda q, k, v, s: flash_attention_with_sink(q, k, v, s, **kw),
            (q, k, v, sink), dout, dlse)


def test_sink_batch_is_one_packed_call(monkeypatch):
    """b sequences, one flex call: each sequence's slices on its own rows."""
    calls = []
    real = sink_attention.flex_flash_attn_func

    def spy(q, k, v, qr, kr, ts, **kw):
        calls.append((q.shape[0], list(qr), list(kr), list(ts)))
        return real(q, k, v, qr, kr, ts, **kw)

    monkeypatch.setattr(sink_attention, "flex_flash_attn_func", spy)
    q, k, v = _t(*_qkv(3, 128, 2, 2, 32))
    flash_attention_with_sink(q, k, v, torch.zeros(2), window=32)
    qr, kr, ts = infer_attn_mask_from_sliding_window(128, 32)
    assert len(calls) == 1
    rows, pqr, pkr, pts = calls[0]
    assert rows == 3 * 128 and pts == [int(x) for x in ts] * 3
    assert pqr == [(s + i * 128, e + i * 128) for i in range(3) for s, e in qr.to_naive_ranges()]
    assert pkr == [(s + i * 128, e + i * 128) for i in range(3) for s, e in kr.to_naive_ranges()]
