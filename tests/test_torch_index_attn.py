"""The port's index-list and sparse-load attention (``ops/index_attn.py``)
against the JAX package's.

Held: the per-q-block selection's block mask and the sparse-load plan
(gather indices and tables) byte-identical to JAX's at the caller's
blocking; out, lse and gradients of ``index_attn_func`` and
``sparse_load_attn_func`` (which the port runs on plans at the kernel's
tile) against JAX's (Pallas interpret mode) within the float32 row of
``DEFAULT_BUDGETS``, causal and not, with ranges wholly above, across and
below the diagonal; and the refusals of a malformed selection."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import index_attn as jia
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.ops import index_attn as ia

from tests.test_torch_block_sparse import pair_mask, same_meta
from tests.test_torch_flex_attn import _inputs
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget, _cotangents

BUDGET = DEFAULT_BUDGETS["float32"]
HQ, HK, D = 4, 2, 32
# selected global k ranges (unsorted on purpose): one wholly above the
# diagonal's start, one across it, one at the start, and short ones
RANGES = {
    "three": [(300, 420), (10, 90), (600, 700)],
    "at_zero": [(0, 1), (64, 200), (250, 251)],
    "tail": [(480, 640), (100, 164)],
}


def _check_against_jax(jax_fn, port_fn, tq, tk, seed):
    qn, kn, vn = _inputs(seed, tq, tk, HQ, HK, D)
    dout, dlse = _cotangents(seed + 1, tq, HQ, D)
    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (qn, kn, vn)))
    dl = np.where(np.isfinite(np.asarray(jl)), dlse, 0.0).astype(np.float32)
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dl)))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    out, lse = port_fn(q, k, v)
    grads = torch.autograd.grad((out, lse), (q, k, v), (torch.from_numpy(dout),
                                                        torch.from_numpy(dl)))
    assert_within_budget(divergence_report(np.asarray(jo), out.detach().numpy(),
                                           ref_lse=np.asarray(jl), test_lse=lse.detach().numpy()),
                         BUDGET)
    for what, r, g in zip(("dq", "dk", "dv"), jgrads, grads):
        _assert_grad_within_budget(r, g.numpy(), what)


def _selection(seed, nq, nk, topk):
    rng = np.random.default_rng(seed)
    sel = np.full((nq, topk), -1, np.int64)
    for i in range(nq):
        n = int(rng.integers(1, topk + 1))
        sel[i, :n] = rng.choice(nk, size=n, replace=False)
    return sel


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bq,bk,tq,tk", [(128, 128, 384, 384), (64, 128, 256, 384),
                                         (128, 64, 384, 256)])
def test_index_attn_matches_jax(bq, bk, tq, tk, causal):
    nq, nk = -(-tq // bq), -(-tk // bk)
    sel = _selection(bq + bk, nq, nk, 3)
    np.testing.assert_array_equal(ia.index_block_mask(sel, nq, nk),
                                  jia_block_mask(sel, nq, nk))
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    _check_against_jax(lambda q, k, v: jia.index_attn_func(q, k, v, sel, **kw),
                       lambda q, k, v: ia.index_attn_func(q, k, v, sel, **kw), tq, tk, 3)


def jia_block_mask(sel, nq, nk):
    """The block mask JAX's ``index_attn_func`` builds from a selection."""
    bm = np.zeros((nq, nk), bool)
    for i in range(nq):
        bm[i, sel[i][sel[i] >= 0]] = True
    return bm


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", list(RANGES))
@pytest.mark.parametrize("block", [64, 128])
def test_sparse_load_plan_byte_identical(name, causal, block):
    r = np.ascontiguousarray(np.asarray(RANGES[name], np.int64))
    got = ia._sparse_load_plan(r.tobytes(), len(r), 512, causal, block, block)
    want = jia._sparse_load_plan(r.tobytes(), len(r), 512, causal, block, block)
    assert got[0].dtype == want[0].dtype and got[0].tobytes() == want[0].tobytes()
    same_meta(got[1], want[1])
    # the kernel-tile plan attends JAX's pairs on the compact buffer
    tile = ia.sparse_load_plan(r, 512, 704, D, causal=causal)[1]
    np.testing.assert_array_equal(pair_mask(tile), pair_mask(want[1]))
    assert tile.total_area == want[1].total_area


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", list(RANGES))
def test_sparse_load_matches_jax(name, causal):
    r = RANGES[name]
    _check_against_jax(
        lambda q, k, v: jia.sparse_load_attn_func(q, k, v, r, causal=causal),
        lambda q, k, v: ia.sparse_load_attn_func(q, k, v, r, causal=causal), 512, 704, 7)


def test_refusals():
    q = torch.zeros(256, HQ, D)
    k = torch.zeros(256, HK, D)
    with pytest.raises(ValueError, match="k block 2 of 2"):
        ia.index_attn_func(q, k, k, np.asarray([[0, 2], [1, -1]]))
    with pytest.raises(ValueError, match=r"need \[2 q blocks"):
        ia.index_attn_func(q, k, k, np.asarray([[0], [1], [0]]))
    with pytest.raises(ValueError, match="disjoint"):
        ia.sparse_load_attn_func(q, k, k, [(0, 100), (50, 120)])
    with pytest.raises(ValueError, match="within"):
        ia.sparse_load_attn_func(q, k, k, [(200, 300)])
    with pytest.raises(ValueError, match="at least one"):
        ia.sparse_load_attn_func(q, k, k, np.zeros((0, 2)))
    with pytest.raises(ValueError, match="empty"):
        ia.sparse_load_attn_func(q, k, k, [(10, 10)])
