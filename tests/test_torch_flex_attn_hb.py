"""The head-batched row-major forward, and the kernel choice that puts it on
the serving and training paths, against the JAX package.

- Forward: JAX ``flex_flash_attn_func(..., grid="row_major",
  head_block=hb, interpret=True)`` (``_fwd_pallas_hb`` in Pallas interpret
  mode for hb > 1) against the port's plain path at the same head_block,
  over three mask families (causal, varlen block-causal, sliding window),
  G in {1, 2, 4} and hb in {G, 2G}, plus a softcap and a sink case: out and
  lse within the float32 row of ``DEFAULT_BUDGETS`` on positive ``v``,
  rowmax to 1e-6. Gradients through ``_FlexAttnCore`` at hb > 1 under the
  rule of ``tests/test_torch_flex_attn_bwd.py``.
- ``auto_kernel_config`` on the row-major grid: head_block G unpinned, the
  ``MAGI_ATTENTION_HEAD_BLOCK`` pin snapped as JAX ``_auto_head_block``
  snaps it, and the sparse grid unchanged.
- ``models.resolve_harness_blocking`` against the JAX harness's with
  ``MAGI_ATTENTION_AUTOTUNE=off``, where both follow the env alone.

Inputs come from numpy with a seed; masks are 512 tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.models import LlamaConfig as JaxLlamaConfig
from magiattention_tpu.models._common import resolve_harness_blocking as jax_harness_blocking
from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.ops.flex_attn import _auto_head_block as jax_auto_head_block
from magiattention_tpu.ops.flex_attn import auto_kernel_config as jax_auto_kernel_config
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.models import LlamaConfig, resolve_harness_blocking
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.testing import workloads

from tests.test_ops.test_block_sparse_grid import _MASKS as JAX_GRID_MASKS
from tests.test_torch_flex_attn import _inputs
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget, _cotangents

BUDGET = DEFAULT_BUDGETS["float32"]
split = workloads.split_slices
MASKS = {
    "causal": workloads.dense_causal(512),
    "varlen_block_causal": workloads.varlen_block_causal(512, n_docs=5, seed=3),
    "sliding_window": JAX_GRID_MASKS["swa_causal"](),
}
HEADS = {1: (4, 4), 2: (4, 2), 4: (8, 2)}  # G -> (hq, hk)
ENV = ("MAGI_ATTENTION_GRID", "MAGI_ATTENTION_HEAD_BLOCK", "MAGI_ATTENTION_BLOCK_Q",
       "MAGI_ATTENTION_BLOCK_K", "MAGI_ATTENTION_AUTOTUNE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _kw(hb):
    return dict(block_q=64, block_k=64, head_block=hb, grid="row_major")


def _forward_case(mask, hq, hk, hb, softcap=0.0, sink=None, d=64):
    qr, kr, ty = split(MASKS[mask])
    t = max(b for _, b in qr)
    q, k, v = _inputs(hq * 11 + hb, t, t, hq, hk, d)
    jo, jl, jm = jax_flex(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qr, kr, ty, interpret=True,
        softcap=softcap, sink=None if sink is None else jnp.asarray(sink),
        return_max_logits=True, **_kw(hb),
    )
    out, lse, mx = fa.flex_flash_attn_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), qr, kr, ty,
        softcap=softcap, sink=None if sink is None else torch.from_numpy(sink),
        return_max_logits=True, **_kw(hb),
    )
    report = divergence_report(np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl),
                               test_lse=lse.numpy())
    assert_within_budget(report, BUDGET, where=f"{mask} hq={hq} hk={hk} hb={hb}")
    jm, tm = np.asarray(jm), mx.numpy()
    np.testing.assert_array_equal(np.isneginf(jm), np.isneginf(tm))
    fin = np.isfinite(jm)
    np.testing.assert_allclose(tm[fin], jm[fin], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hb_of_group", [1, 2], ids=["hbG", "hb2G"])
@pytest.mark.parametrize("group", sorted(HEADS), ids=lambda g: f"g{g}")
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_head_batched_forward_matches_jax(mask, group, hb_of_group):
    hq, hk = HEADS[group]
    _forward_case(mask, hq, hk, hb=group * hb_of_group)


@pytest.mark.parametrize("group", sorted(HEADS), ids=lambda g: f"g{g}")
@pytest.mark.parametrize("mask", ["causal", "varlen_block_causal"])
def test_head_batched_forward_at_head_dim_32_matches_jax(mask, group):
    """DiTConfig's head_dim: JAX ``_fwd_pallas_hb`` in interpret mode at d 32
    against the port's plain version (what ``flex_fwd_hb`` is held to on
    the card)."""
    hq, hk = HEADS[group]
    _forward_case(mask, hq, hk, hb=group, d=32)


@pytest.mark.parametrize(
    "opts",
    [{"softcap": 5.0}, {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}],
    ids=["softcap", "sink"],
)
def test_head_batched_forward_softcap_sink_match_jax(opts):
    sink = opts.get("sink")
    _forward_case("varlen_block_causal", 8, 2, hb=4, softcap=opts.get("softcap", 0.0),
                  sink=None if sink is None else np.asarray(sink, np.float32))


@pytest.mark.parametrize(
    "mask,hq,hk,hb",
    [("causal", 8, 2, 4), ("varlen_block_causal", 4, 2, 4), ("sliding_window", 4, 4, 2)],
)
def test_head_batched_grads_match_jax(mask, hq, hk, hb):
    """vjp of out and lse through ``_FlexAttnCore`` at head_block > 1: the
    backward (``flex_dq``/``flex_dkv``' plain versions) does not read
    head_block, as the JAX backward does not."""
    qr, kr, ty = split(MASKS[mask])
    t = max(b for _, b in qr)
    d = 64
    q, k, v = _inputs(hq + 3 * hk, t, t, hq, hk, d)
    dout, dlse = _cotangents(17, t, hq, d)

    def jax_fn(q, k, v):
        return jax_flex(q, k, v, qr, kr, ty, interpret=True, **_kw(hb))

    (jo, jl), vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = fa.flex_flash_attn_func(*leaves, qr, kr, ty, **_kw(hb))
    report = divergence_report(np.asarray(jo), out.detach().numpy(), ref_lse=np.asarray(jl),
                               test_lse=lse.detach().numpy())
    assert_within_budget(report, BUDGET, where=f"{mask} forward")
    got = torch.autograd.grad((out, lse), leaves, (torch.from_numpy(dout), torch.from_numpy(dlse)))
    for what, r, g in zip(("dq", "dk", "dv"), ref, got):
        _assert_grad_within_budget(r, g.numpy(), f"{mask}/{what}")


def test_head_block_reaches_the_core(monkeypatch):
    """``flex_flash_attn_func``'s head_block arrives in ``_FlexAttnCore``'s
    parameters on the row-major grid (the card picks ``flex_fwd_hb`` from
    it); a head_block no kernel takes is refused before anything runs."""
    seen = []
    real = fa._FlexAttnCore.apply
    monkeypatch.setattr(fa._FlexAttnCore, "apply",
                        lambda *a: seen.append(a[6]) or real(*a))
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 128, 128, 8, 2, 32))
    fa.flex_flash_attn_func(q, k, v, [(0, 128)], [(0, 128)], [1])
    fa.flex_flash_attn_func(q, k, v, [(0, 128)], [(0, 128)], [1], head_block=8)
    assert [(p.grid, p.head_block) for p in seen] == [("row_major", 4), ("row_major", 8)]
    with pytest.raises(ValueError, match="head_block 6"):
        fa.flex_flash_attn_func(q, k, v, [(0, 128)], [(0, 128)], [1], head_block=6)


# -- the kernel choice ---------------------------------------------------------------


# the serving prefills: one-shot causal, and a chunk continuing a history
CHOICE_MASKS = {
    "causal_1000": workloads.dense_causal(1000),
    "causal_4096": workloads.dense_causal(4096),
    "chunked_prefill": [(0, 2048, 0, 6144, 1)],
}
TRAIN_DOCS = [(0, 4096, 0, 4096, 1), (4096, 6144, 4096, 6144, 1), (6144, 8192, 6144, 8192, 1)]


@pytest.mark.parametrize("heads", [(32, 8), (16, 8), (8, 8), (12, 4)],
                         ids=lambda h: f"hq{h[0]}_hk{h[1]}")
@pytest.mark.parametrize("mask", sorted(CHOICE_MASKS))
def test_row_major_choice_is_head_block_g(mask, heads):
    """Where the JAX choice takes the row-major grid with head_block > 1
    (its ``_fwd_pallas_hb``), the port takes it too, at head_block G."""
    hq, hk = heads
    qr, kr, ty = split(CHOICE_MASKS[mask])
    *_, jax_hb, jax_grid = jax_auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty)
    bq, bk, hb, grid = fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty)
    assert grid == jax_grid == "row_major" and jax_hb > 1
    assert (bq, bk, hb) == (*fa.HOPPER_TILES[128], hq // hk)


@pytest.mark.parametrize("hq,group", [(32, 4), (16, 2), (8, 1), (12, 3), (8, 8), (24, 6)])
def test_head_block_pin_snaps_as_jax(hq, group, monkeypatch):
    qr, kr, ty = split(CHOICE_MASKS["causal_4096"])
    for pref in (1, 2, 3, 4, 5, 8, 12, 16, 64):
        monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", str(pref))
        for grid in ("row_major", "sparse"):
            got = fa.auto_kernel_config(qr, kr, hq, hq // group, attn_type_map=ty, grid=grid)
            assert got[2:] == (jax_auto_head_block(pref, hq, group), grid)


def test_sparse_grid_choice_unchanged():
    """A heterogeneous mask still takes the sparse grid at head_block G."""
    qr, kr, ty = split(workloads.varlen_block_causal(16384))
    for hq, hk in ((16, 8), (8, 8), (32, 8)):
        assert fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty)[2:] == (hq // hk, "sparse")


# -- the model harness -----------------------------------------------------------------


HARNESS_CFG = dict(n_heads=16, n_kv_heads=8, head_dim=64)


@pytest.mark.parametrize("caller", [None, (32, 32)], ids=["auto_tile", "caller_tile"])
@pytest.mark.parametrize("pinned_tile", [False, True], ids=["env_tile_unset", "env_tile_64"])
@pytest.mark.parametrize("hb_pin", [None, "1", "2", "3", "8"])
def test_harness_blocking_matches_jax_with_autotune_off(hb_pin, pinned_tile, caller, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "off")
    if hb_pin is not None:
        monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", hb_pin)
    if pinned_tile:
        monkeypatch.setenv("MAGI_ATTENTION_BLOCK_Q", "64")
        monkeypatch.setenv("MAGI_ATTENTION_BLOCK_K", "64")
    qr, kr, ty = split(TRAIN_DOCS)
    bq, bk = caller if caller is not None else (None, None)
    ref = jax_harness_blocking(JaxLlamaConfig(**HARNESS_CFG), None, None, qr, kr, ty, 8192, 1,
                               bq, bk)
    got = resolve_harness_blocking(LlamaConfig(**HARNESS_CFG), qr, kr, ty, 8192, 1, bq, bk)
    if pinned_tile or caller is not None:
        assert got == ref
    else:  # the env's default tile is each package's own: 128 on the TPU, Hopper's here
        assert got == (*fa.HOPPER_TILES[64], ref[2])


def test_harness_blocking_defaults_to_the_row_major_choice(monkeypatch):
    qr, kr, ty = split(TRAIN_DOCS)
    cfg = LlamaConfig(**HARNESS_CFG)
    assert resolve_harness_blocking(cfg, qr, kr, ty, 8192, 1, None, None) == (64, 64, 2)
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "measure")
    assert resolve_harness_blocking(cfg, qr, kr, ty, 8192, 1, None, None) == (64, 64, 2)
    monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", "1")
    assert resolve_harness_blocking(cfg, qr, kr, ty, 8192, 1, None, None) == (64, 64, 1)
    # a varlen mask the density rule would send to the sparse grid stays row-major
    vqr, vkr, vty = split(workloads.varlen_block_causal(8192))
    monkeypatch.delenv("MAGI_ATTENTION_HEAD_BLOCK")
    assert resolve_harness_blocking(cfg, vqr, vkr, vty, 8192, 1, None, None) == (64, 64, 2)
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "fast")
    with pytest.raises(ValueError, match="MAGI_ATTENTION_AUTOTUNE"):
        resolve_harness_blocking(cfg, qr, kr, ty, 8192, 1, None, None)

