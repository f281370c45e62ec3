"""The port's block-sparse driver (``ops/block_sparse.py``) against the JAX
package's.

Held: ``BlockEnumeration``'s four constructors equal to JAX's (the decode
table's page-pool check and its message included); the occupancy and
block-mask metas byte-identical at the caller's blocking; the plan the
kernel walks, built at the kernel's 64 x 64 tile, attending exactly JAX's
(q, k) pairs with JAX's exact area at 128/128, JAX's unequal blockings
128/64, 64/128, 128/32, 32/128 and 96/64 (not a multiple of the tile),
causal and not, square and tq != tk; and ``block_sparse_attn_func``'s out,
lse and gradients against JAX's (Pallas interpret mode, as its own tests
run it on the CPU) within the float32 row of ``DEFAULT_BUDGETS``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import block_sparse as jbs
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu.telemetry.occupancy import block_occupancy_map
from magiattention_tpu_torch.ops import block_sparse as bs
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.ops.block_meta import build_block_meta

from tests.test_torch_flex_attn import _inputs
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget, _cotangents

BUDGET = DEFAULT_BUDGETS["float32"]
# the caller's blockings: JAX's default, its tests' unequal ones, one that
# the kernel tile does not divide
BLOCKINGS = [(128, 128), (128, 64), (64, 128), (128, 32), (32, 128), (96, 64)]
SHAPES = [(512, 512), (384, 640), (640, 384)]


def same_meta(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def pair_mask(meta) -> np.ndarray:
    """The [total_q, total_k] pairs a plan's forward table attends (the
    port's plain-version mask builder, which reads either package's
    tables: they have one format)."""
    tabs = tuple(torch.from_numpy(np.asarray(a, np.int32)) for a in (
        meta.fwd_q_block, meta.fwd_k_block, meta.fwd_slice_id, meta.fwd_runs, meta.slice_bounds))
    dense = fa._dense_mask_from_tables(tabs, meta.num_q_blocks * meta.block_q,
                                       meta.num_k_blocks * meta.block_k, meta.block_q,
                                       meta.block_k)
    return dense[:meta.total_q, :meta.total_k].numpy()


def _mask(seed, tq, tk, bq, bk, density=0.35):
    rng = np.random.default_rng(seed)
    return rng.random((-(-tq // bq), -(-tk // bk))) < density


# -- BlockEnumeration ------------------------------------------------------------


def _same_enum(a, b):
    assert a.num_rows == b.num_rows and a.num_entries == b.num_entries
    for f in ("major", "minor", "row_start", "row_count"):
        x, y = getattr(a, f), getattr(b, f)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert np.array_equal(x, np.asarray(y)), f
    np.testing.assert_array_equal(a.occupied_pairs(), b.occupied_pairs())
    for i in range(a.num_rows):
        for j in range(3):
            assert a.entry(i, j) == int(b.entry(i, j))


def test_from_sorted_and_active_lists():
    rng = np.random.default_rng(0)
    active = [sorted(rng.choice(12, size=int(rng.integers(0, 6)), replace=False).tolist())
              for _ in range(9)]
    a, b = bs.BlockEnumeration.from_active_lists(active), jbs.BlockEnumeration.from_active_lists(
        active)
    _same_enum(a, b)
    _same_enum(bs.BlockEnumeration.from_sorted(a.major, a.minor, 9),
               jbs.BlockEnumeration.from_sorted(b.major, b.minor, 9))
    # tensors in, tensors out, the same tables
    t = bs.BlockEnumeration.from_sorted(torch.from_numpy(a.major.astype(np.int64)),
                                        torch.from_numpy(a.minor), 9)
    _same_enum(t, b)
    with pytest.raises(ValueError, match="active rows"):
        bs.BlockEnumeration.from_active_lists(active, 10)


def test_from_occupancy():
    occ = block_occupancy_map([(0, 300), (300, 512)], [(0, 300), (100, 512)], [1, 0], 64, 64)
    for src in (occ, occ.as_json()):
        _same_enum(bs.BlockEnumeration.from_occupancy(src),
                   jbs.BlockEnumeration.from_occupancy(src))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_from_block_table(kind):
    bt = np.random.default_rng(1).integers(0, 40, size=(3, 8)).astype(np.int32)
    want = jbs.BlockEnumeration.from_block_table(jnp.asarray(bt), 4)
    got = bs.BlockEnumeration.from_block_table(torch.from_numpy(bt) if kind == "tensor" else bt, 4)
    _same_enum(got, want)
    bad = bt.copy()
    bad[2, 5] = 40
    with pytest.raises(ValueError) as port_err:
        bs.BlockEnumeration.from_block_table(torch.from_numpy(bad) if kind == "tensor" else bad, 4,
                                             num_pages=40)
    with pytest.raises(ValueError) as jax_err:
        jbs.BlockEnumeration.from_block_table(bad, 4, num_pages=40)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="not divisible"):
        bs.BlockEnumeration.from_block_table(bt, 3)


# -- metas at the caller's blocking ----------------------------------------------


def test_occupancy_meta_byte_identical():
    qr, kr, ty = [(0, 200), (200, 448), (0, 448)], [(0, 200), (150, 448), (0, 64)], [1, 3, 0]
    occ = block_occupancy_map(qr, kr, ty, 64, 64)
    got = bs.build_block_meta_from_occupancy(occ.as_json(), qr, kr, ty, 448, 448)
    same_meta(got, jbs.build_block_meta_from_occupancy(occ.as_json(), qr, kr, ty, 448, 448))
    same_meta(got, build_block_meta(qr, kr, ty, 448, 448, block_q=64, block_k=64))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", SHAPES)
@pytest.mark.parametrize("bq,bk", BLOCKINGS)
def test_block_mask_meta_byte_identical_and_kernel_tile_pairs(bq, bk, tq, tk, causal):
    bm = _mask(bq * 7 + bk, tq, tk, bq, bk)
    jax_meta = jbs.build_block_meta_from_block_mask(bm, tq, tk, block_q=bq, block_k=bk,
                                                    causal=causal)
    same_meta(bs.build_block_meta_from_block_mask(bm, tq, tk, block_q=bq, block_k=bk,
                                                  causal=causal), jax_meta)
    tile = bs.block_mask_meta(bm, tq, tk, 64, block_q=bq, block_k=bk, causal=causal)
    assert (tile.block_q, tile.block_k) == fa.HOPPER_TILES[64]
    want = pair_mask(jax_meta)
    np.testing.assert_array_equal(pair_mask(tile), want)
    assert tile.total_area == jax_meta.total_area == int(want.sum())


@pytest.mark.parametrize("bq,bk", [(128, 64), (64, 128), (128, 32), (32, 128), (64, 64), (96, 64)])
def test_causal_area_all_true(bq, bk):
    """All tiles selected under causal: exactly the causal triangle (the
    JAX package's unequal-blocking regression)."""
    total = 128
    bm = np.ones((-(-total // bq), -(-total // bk)), bool)
    meta = bs.block_mask_meta(bm, total, total, 32, block_q=bq, block_k=bk, causal=True)
    assert meta.total_area == total * (total + 1) // 2
    np.testing.assert_array_equal(pair_mask(meta), np.tril(np.ones((total, total), bool)))


def test_shape_error_is_jaxs():
    bm = np.ones((3, 4), bool)
    with pytest.raises(ValueError) as port_err:
        bs.build_block_meta_from_block_mask(bm, 512, 512)
    with pytest.raises(ValueError) as jax_err:
        jbs.build_block_meta_from_block_mask(bm, 512, 512)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="tile grid"):
        bs.block_sparse_attn_func(*(torch.zeros(512, 2, 32) for _ in range(3)), bm)


def test_plan_is_cached_per_mask():
    bm = _mask(3, 256, 256, 128, 128, 0.6)
    a = bs.block_mask_meta(bm, 256, 256, 32, causal=True)
    assert bs.block_mask_meta(bm.copy(), 256, 256, 32, causal=True) is a
    assert bs.block_mask_meta(bm, 256, 256, 32, causal=False) is not a


# -- results and gradients -------------------------------------------------------


@pytest.mark.parametrize("bq,bk,tq,tk,causal", [
    (128, 128, 256, 256, True), (128, 64, 256, 256, True), (32, 128, 256, 256, False),
    (96, 64, 256, 192, True), (64, 128, 192, 320, False), (128, 32, 256, 256, False),
])
def test_results_and_gradients_match_jax(bq, bk, tq, tk, causal):
    hq, hk, d = 4, 2, 32
    bm = _mask(11, tq, tk, bq, bk, 0.5)
    bm[:, 0] = True  # every q block attends something below the diagonal
    qn, kn, vn = _inputs(3, tq, tk, hq, hk, d)
    dout, dlse = _cotangents(5, tq, hq, d)
    kw = dict(causal=causal, block_q=bq, block_k=bk)

    def jax_fn(q, k, v):
        return jbs.block_sparse_attn_func(q, k, v, bm, **kw)

    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (qn, kn, vn)))
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(np.where(np.isfinite(jl), dlse, 0.0))))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    out, lse = bs.block_sparse_attn_func(q, k, v, bm, **kw)
    dl = torch.from_numpy(np.where(np.isfinite(np.asarray(jl)), dlse, 0.0).astype(np.float32))
    grads = torch.autograd.grad((out, lse), (q, k, v), (torch.from_numpy(dout), dl))
    assert_within_budget(divergence_report(np.asarray(jo), out.detach().numpy(),
                                           ref_lse=np.asarray(jl), test_lse=lse.detach().numpy()),
                         BUDGET)
    for what, r, g in zip(("dq", "dk", "dv"), jgrads, grads):
        _assert_grad_within_budget(r, g.numpy(), what)
