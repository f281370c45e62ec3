"""The port's sparse grid (CPU plain versions) against the JAX package's.

- ``_amla_rescale`` bit for bit against the JAX function.
- A plain model of the Hopper sparse forwards' softmax order
  (``csrc/flex_fwd_sm90.cuh`` in its AMLA mode: the integer base-2
  reference moved only past ``AMLA_MOVE_AT``, the exponent-add rescale,
  each head's walk whole in entry order) against JAX ``_fwd_pallas_sparse``
  / ``_fwd_pallas_hb_sparse`` in interpret mode and against
  ``_fwd_torch_sparse``.
- The plain sparse forward ``_fwd_torch_sparse`` against JAX
  ``flex_flash_attn_func(..., grid="sparse", head_block=hb)`` in Pallas
  interpret mode (``_fwd_pallas_sparse`` / ``_fwd_pallas_hb_sparse``) at
  64x64 tiles: out and lse within the float32 row of
  ``telemetry.numerics.DEFAULT_BUDGETS`` on positive ``v``, rowmax (the
  exact max, not the quantized one) to 1e-6.
- Gradients through ``_FlexAttnCore`` on ``grid="sparse"`` against the JAX
  sparse grid's (``_dq_pallas_sparse`` / ``_dkv_pallas_sparse``), under the
  rule of ``tests/test_torch_flex_attn_bwd.py``.
- ``auto_kernel_config`` picks the grid the JAX one picks on the masks the
  choice was made for, and its env pins; ``exact_mask_area``, the
  workloads and the kernels' work list.
- The slice as a whole: ``flex_flash_attn_func`` with its defaults on a
  varlen mask, port against JAX (each with its own automatic choice).

Inputs come from numpy with a seed; masks are at most 512 tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.ops.flex_attn import _amla_rescale as jax_amla_rescale
from magiattention_tpu.ops.flex_attn import _auto_head_block as jax_auto_head_block
from magiattention_tpu.ops.flex_attn import auto_kernel_config as jax_auto_kernel_config
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu.testing import workloads as jax_workloads
from magiattention_tpu.tuning.cost_model import exact_mask_area as jax_exact_mask_area
from magiattention_tpu_torch import env
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.ops.block_meta import build_block_meta
from magiattention_tpu_torch.ops.block_sparse import row_tables, work_list
from magiattention_tpu_torch.testing import workloads
from magiattention_tpu_torch.tuning import exact_mask_area

from tests.test_ops.test_block_sparse_grid import _MASKS as JAX_GRID_MASKS
from tests.test_torch_flex_attn import _inputs
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget, _cotangents

BUDGET = DEFAULT_BUDGETS["float32"]
split = workloads.split_slices


def _docs(lengths):
    """Documents packed back to back, each causal over itself."""
    bounds = np.cumsum([0, *lengths]).tolist()
    return [(a, b, a, b, 1) for a, b in zip(bounds, bounds[1:])]


# the three families of the JAX sparse-grid test, the shared-question mask and
# the training mask's shape ([4096, 2048, 2048]), scaled to 512 tokens
MASKS = {
    **{name: build() for name, build in JAX_GRID_MASKS.items()},
    "shared_question": workloads.shared_question_q_overlap(512),
    "train_docs": _docs([256, 128, 128]),
}
HEADS = [(4, 4), (4, 2), (8, 2)]


# -- (a) AMLA's exponent-add rescale ------------------------------------------


@pytest.mark.parametrize("delta", [0, -1, -7, -31, -126, -200, -300])
def test_amla_rescale_is_bitwise_the_jax_function(delta):
    """Random f32 over 1e-20 .. 1e20 of both signs, with zeros (both signs)
    and subnormals; -200 and -300 take the int32 add past its wrap."""
    rng = np.random.default_rng(abs(delta))
    x = rng.standard_normal(4096) * 10.0 ** rng.uniform(-20, 20, 4096)
    x = x.astype(np.float32)
    x[::37], x[1::41], x[2::43] = 0.0, -0.0, np.float32(1e-40)
    d = np.full(x.shape, delta, dtype=np.int32)
    d[::5] = 0  # mixed deltas in one call, as rows of a tile have
    ref = np.asarray(jax_amla_rescale(jnp.asarray(x), jnp.asarray(d)))
    got = fa._amla_rescale(torch.from_numpy(x), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# -- (b) the sparse forward ------------------------------------------------------


def _forward_case(mask, hq, hk, hb, softcap=0.0, sink=None, d=64):
    qr, kr, ty = split(MASKS[mask])
    t = max(max(b for _, b in qr), max(b for _, b in kr))
    q, k, v = _inputs(hq * 7 + hk, t, t, hq, hk, d)
    jo, jl, jm = jax_flex(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qr, kr, ty,
        block_q=64, block_k=64, head_block=hb, grid="sparse", interpret=True,
        softcap=softcap, sink=None if sink is None else jnp.asarray(sink),
        return_max_logits=True,
    )
    out, lse, mx = fa.flex_flash_attn_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), qr, kr, ty,
        block_q=64, block_k=64, head_block=hb, grid="sparse", softcap=softcap,
        sink=None if sink is None else torch.from_numpy(sink), return_max_logits=True,
    )
    report = divergence_report(
        np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl), test_lse=lse.numpy()
    )
    assert_within_budget(report, BUDGET, where=f"{mask} hq={hq} hk={hk} hb={hb}")
    jm, tm = np.asarray(jm), mx.numpy()
    np.testing.assert_array_equal(np.isneginf(jm), np.isneginf(tm))
    fin = np.isfinite(jm)
    np.testing.assert_allclose(tm[fin], jm[fin], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hq{h[0]}_hk{h[1]}")
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_sparse_forward_matches_jax(mask, heads):
    hq, hk = heads
    _forward_case(mask, hq, hk, hb=hq // hk)


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"hq{h[0]}_hk{h[1]}")
@pytest.mark.parametrize("hb_of_group", [0, 2], ids=["hb1", "hb2G"])
def test_sparse_forward_head_blocks_match_jax(heads, hb_of_group):
    """head_block 1 (``_fwd_pallas_sparse``) and 2G (``_fwd_pallas_hb_sparse``
    over two kv heads) against the port's one plain version."""
    hq, hk = heads
    hb = 1 if hb_of_group == 0 else 2 * (hq // hk)
    _forward_case("block_causal", hq, hk, hb=hb)


def test_sparse_forward_softcap_sink_matches_jax():
    sink = np.asarray([0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0], np.float32)
    _forward_case("shared_question", 8, 2, hb=4, softcap=5.0, sink=sink)


def test_sparse_forward_uncovered_rows():
    """A q block with only a dummy entry, and rows no slice covers, keep the
    uncovered convention on the sparse grid: out 0, lse -inf (or the sink),
    rowmax -inf."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 200, 200, 4, 2, 32))
    kw = dict(grid="sparse", block_q=64, block_k=64, head_block=2, return_max_logits=False)
    out, lse = fa.flex_flash_attn_func(q, k, v, [(0, 50)], [(0, 50)], [1], **kw)
    assert (out[50:] == 0).all() and torch.isneginf(lse[50:]).all()
    sink = torch.tensor([0.25, -2.0, 1.0, 0.0])
    out, lse = fa.flex_flash_attn_func(q, k, v, [(0, 50)], [(0, 50)], [1], sink=sink, **kw)
    assert (out[50:] == 0).all() and torch.equal(lse[50:], sink.expand(150, 4))


def test_sparse_forward_matches_dense_plain_version_in_float64():
    """The AMLA walk and the dense softmax agree to float64 rounding."""
    qr, kr, ty = split(MASKS["varlen_causal"])
    q, k, v = (torch.from_numpy(x).double() for x in _inputs(9, 512, 512, 4, 2, 32))
    a = fa.flex_flash_attn_func(q, k, v, qr, kr, ty, grid="sparse", return_max_logits=True)
    b = fa.flex_flash_attn_func(q, k, v, qr, kr, ty, grid="row_major", return_max_logits=True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-10)


# -- (b') the Hopper sparse forwards' softmax order -----------------------------------

AMLA_MOVE_AT = 8.0  # csrc/flex_fwd_sm90.cuh: AMLA's reference moves past it, in base 2


def _sm90_order_fwd_sparse(q, k, v, sink, ftab, params, round_to, bq=64, bk=64):
    """``csrc/flex_fwd_sm90.cuh``'s AMLA walk in plain float32, per (q head,
    q block) and entry tile in walk order (the sparse kernels never split a
    head's walk: a head pair's warpgroups walk one head each, a single
    head's walk is one warpgroup's): the tile's natural row max, the
    integer reference ceil(max z log2 e) moved only when it passes the
    reference by more than ``AMLA_MOVE_AT`` (a fresh row takes it with
    delta 0), P = exp2(z log2 e - ref) rounded to ``round_to`` before P V,
    l and O rescaled by ``_amla_rescale`` (the exponent add). The epilogue
    is ``_amla_finalize``. Returns (out, lse, rowmax, the number of nonzero
    deltas: rescales taken)."""
    from magiattention_tpu_torch.ops.flex_attn import (
        LOG2E, _amla_finalize, _amla_rescale, _entry_tiles,
    )

    hq, tqp, d = q.shape
    group = hq // k.shape[0]
    tabs = tuple(t.long() for t in ftab[:5])
    rs, rc = ftab[5].tolist(), ftab[6].tolist()
    tiles = _entry_tiles(tabs, torch.arange(tabs[0].shape[0]), bq, bk)
    neg = torch.tensor(float("-inf"))
    out = torch.zeros((hq, tqp, d))
    lse, rowmax = torch.zeros((hq, tqp)), torch.zeros((hq, tqp))
    moves = 0
    for h in range(hq):
        kf, vf = k[h // group].float(), v[h // group].float()
        for i in range(tqp // bq):
            rows = slice(i * bq, (i + 1) * bq)
            st = dict(ref=torch.full((bq,), neg), m=torch.full((bq,), neg), l=torch.zeros(bq),
                      o=torch.zeros((bq, d)))
            for e in range(rs[i], rs[i] + rc[i]):
                kb = int(tabs[1][e])
                keys = slice(kb * bk, (kb + 1) * bk)
                z = q[h, rows].float() @ kf[keys].T * params.scale
                if params.softcap > 0.0:
                    z = params.softcap * torch.tanh(z / params.softcap)
                z = torch.where(tiles[e], z, neg)
                tile_max = z.amax(-1)
                st["m"] = torch.maximum(st["m"], tile_max)
                top = torch.ceil(tile_max * LOG2E)
                fresh = torch.isneginf(st["ref"])
                move = torch.where(fresh, ~torch.isneginf(top), top > st["ref"] + AMLA_MOVE_AT)
                delta = torch.where(move & ~fresh, st["ref"] - top, 0.0).to(torch.int32)
                moves += int((delta != 0).sum())
                st["ref"] = torch.where(move, top, st["ref"])
                ref_safe = torch.where(torch.isneginf(st["ref"]), 0.0, st["ref"])
                p = torch.exp2(z * LOG2E - ref_safe[:, None])
                st["l"] = _amla_rescale(st["l"], delta) + p.sum(-1)
                st["o"] = (_amla_rescale(st["o"], delta[:, None])
                           + p.to(round_to).float() @ vf[keys].to(round_to).float())
            o, lrow = _amla_finalize(st["ref"], st["l"], st["o"], sink[h].float(),
                                     params.has_sink)
            out[h, rows], lse[h, rows], rowmax[h, rows] = o, lrow, st["m"]
    return out, lse, rowmax, moves


# (mask, hq, hk, head_block, d, softcap, sink, rising keys)
_ORDER_CASES = {
    "varlen_causal_g1_hb1": ("varlen_causal", 4, 4, 1, 64, 0.0, False, False),
    "block_causal_g2_hb2": ("block_causal", 4, 2, 2, 64, 0.0, False, False),
    "block_causal_g2_hb1": ("block_causal", 4, 2, 1, 64, 0.0, False, False),
    "shared_question_g4_softcap_sink": ("shared_question", 8, 2, 4, 64, 5.0, True, False),
    "train_docs_g4_hb1_d128": ("train_docs", 8, 2, 1, 128, 0.0, False, False),
    "swa_causal_g1_hb2_d128": ("swa_causal", 2, 2, 2, 128, 0.0, False, False),
    "uncovered_rows_g2_sink": ("uncovered", 4, 2, 2, 64, 0.0, True, False),
    "rising_keys_g2_hb2": ("causal", 4, 2, 2, 64, 0.0, False, True),
    "rising_keys_g1_hb1": ("causal", 2, 2, 1, 64, 0.0, False, True),
}
_ORDER_MASKS = {**MASKS, "uncovered": [(0, 300, 0, 300, 1)], "causal": [(0, 512, 0, 512, 1)]}


def _order_case(case, dtype):
    """The case's inputs (numpy, seeded; keys scaled from 1 to 12 along the
    sequence for the rising cases, so that the reference moves), as the
    port's head-major padded tensors in ``dtype``, with its plan."""
    mask, hq, hk, hb, d, softcap, sink, rising = _ORDER_CASES[case]
    qr, kr, ty = split(_ORDER_MASKS[mask])
    t = 512
    q, k, v = _inputs(hq * 11 + hk, t, t, hq, hk, d)
    if rising:
        k = (k * np.linspace(1.0, 12.0, t, dtype=np.float32)[:, None, None]).astype(np.float32)
    sink_np = (np.linspace(-1.0, 2.0, hq).astype(np.float32) if sink
               else np.zeros(hq, np.float32))
    meta = build_block_meta(qr, kr, ty, t, t, block_q=64, block_k=64)
    tp = meta.num_q_blocks * 64

    def head_major(x):
        return fa._pad_tokens(torch.from_numpy(x).to(dtype).transpose(0, 1), tp)

    params = fa.FlexAttnParams(64, 64, d ** -0.5, softcap, sink, dtype, hb, "sparse")
    return ((q, k, v, sink_np, qr, kr, ty), (head_major(q), head_major(k), head_major(v)),
            torch.from_numpy(sink_np), fa.fwd_tables(meta, "cpu"), params)


@pytest.mark.parametrize("case", sorted(_ORDER_CASES))
def test_sm90_sparse_forward_order_matches_jax_pallas(case):
    """The model on float32 inputs (nothing rounded: P stays in V's type, as
    in the TPU kernel) against JAX ``flex_flash_attn_func(grid="sparse")``
    in Pallas interpret mode (``_fwd_pallas_sparse`` at head_block 1,
    ``_fwd_pallas_hb_sparse`` above) and against the port's
    ``_fwd_torch_sparse``: out and lse within the float32 row of
    ``DEFAULT_BUDGETS`` (v positive), rowmax (exact, not quantized) to
    1e-6. The rising-keys cases must take the rescale."""
    (qn, kn, vn, sink_np, qr, kr, ty), (q, k, v), sink, ftab, params = _order_case(
        case, torch.float32)
    mask, hq, hk, hb, d, softcap, has_sink, rising = _ORDER_CASES[case]
    out, lse, mx, moves = _sm90_order_fwd_sparse(q, k, v, sink, ftab, params, torch.float32)
    assert moves > 0 if rising else True
    t = qn.shape[0]
    jo, jl, jm = jax_flex(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), qr, kr, ty, block_q=64, block_k=64,
        head_block=hb, grid="sparse", interpret=True, softcap=softcap,
        sink=jnp.asarray(sink_np) if has_sink else None, return_max_logits=True)
    got_out, got_lse = out[:, :t].transpose(0, 1).numpy(), lse[:, :t].transpose(0, 1).numpy()
    report = divergence_report(np.asarray(jo), got_out, ref_lse=np.asarray(jl), test_lse=got_lse)
    assert_within_budget(report, BUDGET, where=f"{case} vs JAX")
    jm, tm = np.asarray(jm), mx[:, :t].amax(dim=1).numpy()
    np.testing.assert_array_equal(np.isneginf(jm), np.isneginf(tm))
    np.testing.assert_allclose(tm[np.isfinite(jm)], jm[np.isfinite(jm)], atol=1e-6, rtol=1e-6)
    ref_out, ref_lse, ref_mx = fa._fwd_torch_sparse(q, k, v, sink, ftab, params)
    report = divergence_report(ref_out[:, :t].numpy(), out[:, :t].numpy(),
                               ref_lse=ref_lse[:, :t].numpy(), test_lse=lse[:, :t].numpy())
    assert_within_budget(report, BUDGET, where=f"{case} vs _fwd_torch_sparse")
    torch.testing.assert_close(mx, ref_mx, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(_ORDER_CASES))
def test_sm90_sparse_forward_order_in_bf16_matches_plain(case):
    """The model on bf16 inputs, P rounded to bf16 before P V as the Hopper
    kernels and ``_fwd_torch_sparse`` round it, against
    ``_fwd_torch_sparse``, with the tolerances ``chip_smoke.py`` holds the
    kernels to on the card: out within 1e-2 + 1e-2 |ref| (the bf16 rounding
    of P and of the output), lse and rowmax within 2e-4, -inf in the same
    places."""
    _, (q, k, v), sink, ftab, params = _order_case(case, torch.bfloat16)
    out, lse, mx, _ = _sm90_order_fwd_sparse(q, k, v, sink, ftab, params, torch.bfloat16)
    ref_out, ref_lse, ref_mx = fa._fwd_torch_sparse(q, k, v, sink, ftab, params)
    out = out.to(torch.bfloat16).float()
    assert ((out - ref_out.float()).abs() <= 1e-2 + 1e-2 * ref_out.float().abs()).all()
    for got, ref in ((lse, ref_lse), (mx, ref_mx)):
        assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        assert ((got[fin] - ref[fin]).abs() <= 2e-4).all()


# -- (c) gradients through the sparse grid --------------------------------------


def _grad_case(mask, hq, hk, hb, softcap=0.0, sink=None, d=64, block=64, jax_kw=None):
    qr, kr, ty = split(MASKS[mask])
    t = max(max(b for _, b in qr), max(b for _, b in kr))
    q, k, v = _inputs(hq + 5 * hk, t, t, hq, hk, d)
    dout, dlse = _cotangents(13, t, hq, d)
    jkw = jax_kw if jax_kw is not None else dict(
        block_q=block, block_k=block, head_block=hb, grid="sparse")

    def jax_fn(q, k, v, s):
        return jax_flex(q, k, v, qr, kr, ty, sink=s, softcap=softcap, interpret=True, **jkw)

    primals = [jnp.asarray(x) for x in (q, k, v)] + [None if sink is None else jnp.asarray(sink)]
    (jo, jl), vjp = jax.vjp(jax_fn, *primals)
    ref = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ts = None if sink is None else torch.from_numpy(sink).requires_grad_()
    pkw = {} if jax_kw is not None else dict(
        block_q=block, block_k=block, head_block=hb, grid="sparse")
    out, lse = fa.flex_flash_attn_func(*leaves, qr, kr, ty, sink=ts, softcap=softcap, **pkw)
    report = divergence_report(np.asarray(jo), out.detach().numpy(),
                               ref_lse=np.asarray(jl), test_lse=lse.detach().numpy())
    assert_within_budget(report, BUDGET, where=f"{mask} forward")
    inputs = leaves + ([ts] if ts is not None else [])
    got = torch.autograd.grad((out, lse), inputs,
                              (torch.from_numpy(dout), torch.from_numpy(dlse)))
    for what, r, g in zip(("dq", "dk", "dv", "dsink"), ref, got):
        _assert_grad_within_budget(r, g.numpy(), f"{mask}/{what}")


@pytest.mark.parametrize(
    "mask,hq,hk,hb,softcap,sink",
    [
        ("varlen_causal", 4, 2, 2, 0.0, None),
        ("block_causal", 4, 2, 1, 0.0, None),
        ("train_docs", 8, 2, 4, 0.0, None),
        ("shared_question", 4, 4, 1, 5.0, [0.5, -1.0, 2.0, 0.0]),
    ],
    ids=["varlen_causal", "block_causal_hb1", "train_docs_g4", "shared_question_sink_softcap"],
)
def test_sparse_grads_match_jax(mask, hq, hk, hb, softcap, sink):
    sink = None if sink is None else np.asarray(sink, np.float32)
    _grad_case(mask, hq, hk, hb, softcap=softcap, sink=sink)


# -- (d) the kernel choice ---------------------------------------------------------


def _choice_masks():
    """The masks the grid choice was made for: the 16k varlen block-causal
    headline, the trainer's documents, causal 16k and 8k, and the shared
    question at 16k."""
    return {
        "varlen_block_causal_16k": workloads.varlen_block_causal(16384),
        "train_docs_8k": _docs([4096, 2048, 2048]),
        "causal_16k": workloads.dense_causal(16384),
        "causal_8k": workloads.dense_causal(8192),
        "shared_question_16k": workloads.shared_question_q_overlap(16384),
    }


@pytest.mark.parametrize("heads", [(16, 8), (8, 8), (32, 8)], ids=lambda h: f"hq{h[0]}_hk{h[1]}")
@pytest.mark.parametrize("mask", sorted(_choice_masks()))
def test_auto_kernel_config_grid_matches_jax(mask, heads, monkeypatch):
    for name in ("MAGI_ATTENTION_GRID", "MAGI_ATTENTION_HEAD_BLOCK", "MAGI_ATTENTION_BLOCK_Q",
                 "MAGI_ATTENTION_BLOCK_K", "MAGI_ATTENTION_AUTOTUNE"):
        monkeypatch.delenv(name, raising=False)
    hq, hk = heads
    qr, kr, ty = split(_choice_masks()[mask])
    *_, jax_grid = jax_auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty)
    bq, bk, hb, grid = fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty)
    assert grid == jax_grid
    assert (bq, bk) == fa.HOPPER_TILES[128]
    assert hb == hq // hk  # G on either grid: one kv head's q heads an item


def _windows(total, window, rows=256):
    """Causal sliding windows in ``rows``-row chunks: each chunk of queries
    sees the ``window`` keys that end at its last row."""
    return [(s, s + rows, max(0, s + rows - window), s + rows, 1) for s in range(0, total, rows)]


def _fixed_blocking_masks():
    """The masks of the grid-precedence fault (the varlen and sliding-window
    masks where the density rule and the reference's static choice part),
    and three where they agree."""
    return {
        "varlen_block_causal_16k": workloads.varlen_block_causal(16384),
        "varlen_block_causal_4k": workloads.varlen_block_causal(4096),
        "window_1024_8k": _windows(8192, 1024),
        "window_2048_8k": _windows(8192, 2048),
        "window_4096_16k": _windows(16384, 4096),
        "window_3072_8k": _windows(8192, 3072),
        "causal_16k": workloads.dense_causal(16384),
        "shared_question_16k": workloads.shared_question_q_overlap(16384),
    }


def _launched_grid(module, q, k, qr, kr, ty, monkeypatch, **kw):
    """The grid a ``flex_flash_attn_func`` (JAX's or the port's) hands to
    its ``flex_attn_with_meta``, with the plan and the kernels stubbed
    out."""
    seen = {}
    monkeypatch.setattr(module, "_cached_meta", lambda *a: None)
    monkeypatch.setattr(module, "flex_attn_with_meta", lambda *a, **kw: seen.update(kw))
    module.flex_flash_attn_func(q, k, k, qr, kr, ty, **kw)
    return seen["grid"]


@pytest.mark.parametrize("condition", ["unpinned", "fixed_tile", "autotune_off", "all_blocking_given"])
@pytest.mark.parametrize("heads", [(16, 8), (32, 8), (8, 8)], ids=lambda h: f"hq{h[0]}_hk{h[1]}")
@pytest.mark.parametrize("mask", sorted(_fixed_blocking_masks()))
def test_grid_under_fixed_blocking_matches_jax(mask, heads, condition, monkeypatch):
    """The grid under a caller-fixed 64x64 tile, under
    ``MAGI_ATTENTION_AUTOTUNE=off``, and with block_q, block_k and
    head_block all given to ``flex_flash_attn_func`` (the reference then
    skips its automatic choice) is the one the JAX package takes; the
    unpinned choice still agrees."""
    import magiattention_tpu.ops.flex_attn as jax_fa

    for name in ("MAGI_ATTENTION_GRID", "MAGI_ATTENTION_HEAD_BLOCK", "MAGI_ATTENTION_BLOCK_Q",
                 "MAGI_ATTENTION_BLOCK_K", "MAGI_ATTENTION_AUTOTUNE",
                 "MAGI_ATTENTION_AUTO_RANGE_MERGE"):
        monkeypatch.delenv(name, raising=False)
    hq, hk = heads
    qr, kr, ty = split(_fixed_blocking_masks()[mask])
    if condition == "all_blocking_given":
        total = max(r[1] for r in qr)
        kw = dict(block_q=64, block_k=64, head_block=hq // hk)
        q_np = np.broadcast_to(np.zeros((), np.float32), (total, hq, 128))
        k_np = np.broadcast_to(np.zeros((), np.float32), (total, hk, 128))
        jax_grid = _launched_grid(jax_fa, q_np, k_np, qr, kr, ty, monkeypatch, **kw)
        q_t, k_t = torch.zeros(()).expand(total, hq, 128), torch.zeros(()).expand(total, hk, 128)
        assert _launched_grid(fa, q_t, k_t, qr, kr, ty, monkeypatch, **kw) == jax_grid == "row_major"
        monkeypatch.setenv("MAGI_ATTENTION_GRID", "sparse")
        assert _launched_grid(fa, q_t, k_t, qr, kr, ty, monkeypatch, **kw) == "sparse"
        assert _launched_grid(jax_fa, q_np, k_np, qr, kr, ty, monkeypatch, **kw) == "sparse"
        return
    kw = dict(fixed_block_q=64, fixed_block_k=64) if condition == "fixed_tile" else {}
    if condition == "autotune_off":
        monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "off")
    *_, jax_grid = jax_auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, **kw)
    assert fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, **kw)[3] == jax_grid
    if condition != "unpinned":
        assert jax_grid == "row_major"
        # a grid pin still goes first, on either side
        monkeypatch.setenv("MAGI_ATTENTION_GRID", "sparse")
        assert fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, **kw)[3] == "sparse"
        assert jax_auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, **kw)[3] == "sparse"


def test_auto_kernel_config_env_pins(monkeypatch):
    qr, kr, ty = split(workloads.varlen_block_causal(4096))
    cqr, ckr, cty = split(workloads.dense_causal(4096))
    monkeypatch.delenv("MAGI_ATTENTION_HEAD_BLOCK", raising=False)
    monkeypatch.setenv("MAGI_ATTENTION_GRID", "row_major")
    assert fa.auto_kernel_config(qr, kr, 16, 8, attn_type_map=ty)[2:] == (2, "row_major")
    monkeypatch.setenv("MAGI_ATTENTION_GRID", "sparse")
    assert fa.auto_kernel_config(cqr, ckr, 16, 8, attn_type_map=cty)[2:] == (2, "sparse")
    # the caller's pin goes before the env's
    assert fa.auto_kernel_config(cqr, ckr, 16, 8, attn_type_map=cty, grid="row_major")[3] == "row_major"
    monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", "5")
    assert fa.auto_kernel_config(cqr, ckr, 16, 8, attn_type_map=cty)[2] == 4
    monkeypatch.setenv("MAGI_ATTENTION_GRID", "diagonal")
    with pytest.raises(ValueError, match="MAGI_ATTENTION_GRID"):
        fa.auto_kernel_config(qr, kr, 16, 8, attn_type_map=ty)
    with pytest.raises(ValueError, match="MAGI_ATTENTION_GRID"):
        env.grid_override()


@pytest.mark.parametrize("hq,group", [(16, 2), (32, 4), (8, 1), (12, 3), (8, 8)])
def test_auto_head_block_matches_jax(hq, group):
    for pref in (0, 1, 2, 3, 4, 5, 8, 16, 64):
        assert fa._auto_head_block(pref, hq, group) == jax_auto_head_block(pref, hq, group)


def test_flex_flash_attn_func_resolves_the_sparse_grid(monkeypatch):
    """Defaults on a heterogeneous mask reach the sparse plain forward; a
    causal mask keeps the row-major one."""
    monkeypatch.delenv("MAGI_ATTENTION_GRID", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_HEAD_BLOCK", raising=False)
    calls = []
    monkeypatch.setattr(fa, "_fwd_torch_sparse",
                        lambda *a, _f=fa._fwd_torch_sparse: calls.append("sparse") or _f(*a))
    monkeypatch.setattr(fa, "_fwd_torch", lambda *a, _f=fa._fwd_torch: calls.append("row") or _f(*a))
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 512, 512, 4, 2, 32))
    fa.flex_flash_attn_func(q, k, v, *split(MASKS["varlen_causal"]))
    fa.flex_flash_attn_func(q, k, v, [(0, 512)], [(0, 512)], [1])
    assert calls == ["sparse", "row"]


def test_variants_refused_everywhere():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 128, 128, 4, 2, 32))
    with pytest.raises(ValueError, match="head_block 3"):
        fa.flex_flash_attn_func(q, k, v, [(0, 128)], [(0, 128)], [1], head_block=3, grid="sparse")
    with pytest.raises(ValueError, match="grid"):
        fa.flex_flash_attn_func(q, k, v, [(0, 128)], [(0, 128)], [1], grid="diagonal")


# -- (e) mask area and workloads -----------------------------------------------------


@pytest.mark.parametrize(
    "slices",
    [
        workloads.varlen_block_causal(16384),
        workloads.shared_question_q_overlap(16384),
        workloads.dense_causal(999),
        [(0, 100, 0, 300, 3), (100, 250, 50, 260, 2), (250, 300, 0, 300, 0), (300, 300, 5, 9, 1)],
    ],
    ids=["varlen", "shared_question", "causal", "bi_inv_full_empty"],
)
def test_exact_mask_area_matches_jax(slices):
    qr, kr, ty = split(slices)
    assert exact_mask_area(qr, kr, ty) == jax_exact_mask_area(qr, kr, ty)


@pytest.mark.parametrize(
    "name,args",
    [("dense_causal", (777,)), ("varlen_block_causal", (16384,)),
     ("varlen_block_causal", (5000, 7, 3)), ("shared_question", (16384,)),
     ("shared_question", (1001, 5))],
)
def test_workloads_match_jax(name, args):
    got = workloads.DYNSOLVER_WORKLOADS[name](*args)
    ref = jax_workloads.DYNSOLVER_WORKLOADS[name](*args)
    assert [tuple(map(int, s)) for s in got] == [tuple(map(int, s)) for s in ref]


# -- (f) the persistent kernels' work list ------------------------------------------


@pytest.mark.parametrize("groups", [1, 3, 8])
def test_work_list_is_every_item_longest_first(groups):
    qr, kr, ty = split(workloads.varlen_block_causal(4096))
    meta = build_block_meta(qr, kr, ty, 4096, 4096, block_q=64, block_k=64)
    for major, n in ((meta.fwd_q_block, meta.num_q_blocks), (meta.bwd_k_block, meta.num_k_blocks)):
        _, rc = row_tables(major, n)
        assert (rc >= 1).all()  # every block has an entry (a dummy one if need be)
        items = work_list(rc, groups)
        assert items.dtype == np.int32
        assert sorted(items.tolist()) == list(range(groups * n))
        group, row = items // n, items % n
        key = list(zip(-rc[row], group, row))
        assert key == sorted(key)


def test_sparse_work_is_cached_per_plan_and_head_block():
    qr, kr, ty = split(MASKS["varlen_causal"])
    meta = build_block_meta(qr, kr, ty, 512, 512, block_q=64, block_k=64)
    w = fa.sparse_work(meta, "cpu", 8, 2, 4)
    assert fa.sparse_work(meta, "cpu", 8, 2, 4) is w
    # G = 4: the dq items are head pairs
    assert (w.fwd.numel(), w.dq.numel(), w.dkv.numel()) == (2 * 8, 4 * 8, 2 * 8)


@pytest.mark.parametrize("hq,hk,pair", [(4, 4, False), (8, 4, True), (6, 2, False),
                                        (8, 2, True), (16, 2, True)],
                         ids=["g1", "g2", "g3", "g4", "g8"])
def test_sparse_work_lists_every_item_once_longest_first(hq, hk, pair):
    """Each of ``sparse_work``'s lists holds every (head group, block)
    item once, longest walk first (ties by group, then block): the dq list
    in head pairs of one kv head at even G, in q heads at odd G, the dkv
    list in kv heads over the k-major walks, the forward's in head_block
    groups."""
    qr, kr, ty = split(workloads.varlen_block_causal(4096))
    meta = build_block_meta(qr, kr, ty, 4096, 4096, block_q=64, block_k=64)
    group = hq // hk
    assert fa.dq_heads_per_item(hq, hk) == (2 if pair else 1)
    w = fa.sparse_work(meta, "cpu", hq, hk, group)
    _, rc_q = row_tables(meta.fwd_q_block, meta.num_q_blocks)
    _, rc_k = row_tables(meta.bwd_k_block, meta.num_k_blocks)
    dq_groups = hq // 2 if pair else hq
    for items, groups, rc in ((w.fwd, hk, rc_q), (w.dq, dq_groups, rc_q), (w.dkv, hk, rc_k)):
        items = items.numpy()
        n = rc.shape[0]
        assert items.dtype == np.int32
        assert sorted(items.tolist()) == list(range(groups * n))
        grp, row = items // n, items % n
        key = list(zip(-rc[row], grp, row))
        assert key == sorted(key)
    if pair:  # a pair's two heads share one kv head
        first = (w.dq.numpy() // meta.num_q_blocks) * 2
        assert (first // group == (first + 1) // group).all()


# -- (g) the slice as a whole -----------------------------------------------------------


def test_defaults_on_a_varlen_mask_match_jax(monkeypatch):
    """``flex_flash_attn_func`` with its defaults, port (which takes the
    sparse grid at 64x64 and head_block G) against JAX with its own
    automatic choice (interpret mode): forward and gradients."""
    for name in ("MAGI_ATTENTION_GRID", "MAGI_ATTENTION_HEAD_BLOCK", "MAGI_ATTENTION_BLOCK_Q",
                 "MAGI_ATTENTION_BLOCK_K"):
        monkeypatch.delenv(name, raising=False)
    qr, kr, ty = split(MASKS["train_docs"])
    assert fa.auto_kernel_config(qr, kr, 8, 4, attn_type_map=ty, head_dim=64)[2:] == (2, "sparse")
    _grad_case("train_docs", 8, 4, hb=None, jax_kw={})
