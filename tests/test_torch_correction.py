"""The port's LSE correction (torch) against the JAX package's (jnp) on the
same partials, including the all--inf hardening that
``tests/test_serving/test_correction_neginf.py`` pins: uncovered rows stay
(0, -inf) and garbage (NaN/inf) payloads on them never leak into a merge.
Then the sink fold in its three layouts (``sh``, ``ssh``, ``shd``), forward
and gradient against ``jax.grad``, on covered and uncovered rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from magiattention_tpu.ops.correction import (
    correct_attn_lse_with_sink as jax_lse_with_sink,
    correct_attn_out_lse_with_sink as jax_out_lse_with_sink,
    correct_attn_out_with_sink as jax_out_with_sink,
    correct_attn_out as jax_correct_out,
    correct_attn_out_lse as jax_correct_out_lse,
    merge_partials as jax_merge,
    safe_lse_merge as jax_safe_lse_merge,
)
from magiattention_tpu_torch.ops.correction import (
    correct_attn_lse,
    correct_attn_lse_with_sink,
    correct_attn_out_lse_with_sink,
    correct_attn_out_with_sink,
    correct_attn_out,
    correct_attn_out_lse,
    merge_partials,
    safe_lse_merge,
)

NINF = float("-inf")


def _partial(rng, t=16, h=3, d=8, p_uncovered=0.4, garbage=True):
    lse = rng.standard_normal((t, h)).astype(np.float32)
    out = rng.standard_normal((t, h, d)).astype(np.float32)
    unc = rng.random((t, h)) < p_uncovered
    lse[unc] = NINF
    out[unc] = np.nan if garbage else 0.0
    return out, lse, unc


@pytest.mark.parametrize("seed", range(4))
def test_merge_matches_jax_and_is_nanfree(seed):
    rng = np.random.default_rng(seed)
    o1, l1, m1 = _partial(rng)
    o2, l2, m2 = _partial(rng)
    o2[m2] = np.inf  # the other garbage kind
    out, lse = correct_attn_out_lse(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    jo, jl = jax_correct_out_lse(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    out, lse = out.numpy(), lse.numpy()
    assert np.isfinite(out).all(), "garbage payload leaked into the merge"
    assert not np.isnan(lse).any()
    both = m1 & m2
    np.testing.assert_array_equal(np.isneginf(lse), both)
    np.testing.assert_array_equal(out[both], 0.0)
    np.testing.assert_allclose(out, np.asarray(jo), atol=1e-6, rtol=1e-6)
    fin = ~both
    np.testing.assert_allclose(lse[fin], np.asarray(jl)[fin], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_all_neginf_rows_stay_neginf(dtype):
    tdt = getattr(torch, dtype)
    l1 = torch.full((4, 2), NINF, dtype=tdt)
    merged = safe_lse_merge(l1, l1.clone())
    assert torch.isneginf(merged).all()
    assert torch.isneginf(correct_attn_lse(l1, l1)).all()
    out = correct_attn_out(
        torch.full((4, 2, 3), float("nan"), dtype=tdt), l1,
        torch.full((4, 2, 3), float("inf"), dtype=tdt), l1, merged,
    )
    assert (out == 0).all()


def test_safe_lse_merge_matches_jax_and_logaddexp():
    rng = np.random.default_rng(11)
    a = rng.standard_normal(64).astype(np.float32) * 5
    b = rng.standard_normal(64).astype(np.float32) * 5
    a[::5] = NINF
    b[::7] = NINF
    got = safe_lse_merge(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_safe_lse_merge(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        got[fin], np.logaddexp(a.astype(np.float64), b)[fin], atol=1e-5, rtol=1e-6
    )


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_merge_partials_matches_jax_tree(n):
    rng = np.random.default_rng(20 + n)
    parts = [_partial(rng, garbage=False) for _ in range(n)]
    out, lse = merge_partials(
        [torch.from_numpy(p[0]) for p in parts], [torch.from_numpy(p[1]) for p in parts]
    )
    jo, jl = jax_merge([jnp.asarray(p[0]) for p in parts], [jnp.asarray(p[1]) for p in parts])
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=1e-6, rtol=1e-6)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(jl))
    fin = np.isfinite(jl)
    np.testing.assert_allclose(lse.numpy()[fin], jl[fin], atol=1e-6, rtol=1e-6)


def test_correct_attn_out_with_merged_lse_matches_jax():
    rng = np.random.default_rng(31)
    o1, l1, _ = _partial(rng)
    o2, l2, _ = _partial(rng)
    lse = safe_lse_merge(torch.from_numpy(l1), torch.from_numpy(l2))
    got = correct_attn_out(torch.from_numpy(o1), torch.from_numpy(l1),
                           torch.from_numpy(o2), torch.from_numpy(l2), lse)
    ref = jax_correct_out(jnp.asarray(o1), jnp.asarray(l1), jnp.asarray(o2),
                          jnp.asarray(l2), jnp.asarray(lse.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_merge_partials_rejects_empty():
    with pytest.raises(ValueError):
        merge_partials([], [])


# (layout, sink tokens): shd with no sink token leaves an uncovered row at -inf
SINK_CASES = [("sh", 1), ("sh", 3), ("ssh", 2), ("shd", 2), ("shd", 0)]


def _sink(rng, layout, n, t, h, d):
    shape = {"sh": (n, h), "ssh": (t, n, h), "shd": (n, h, d)}[layout]
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("layout,n", SINK_CASES, ids=[f"{lay}{n}" for lay, n in SINK_CASES])
def test_sink_fold_matches_jax_with_gradients(layout, n):
    rng = np.random.default_rng(41 + n)
    t, h, d = 12, 3, 8
    out, lse, unc = _partial(rng, t, h, d, garbage=False)
    sink = _sink(rng, layout, n, t, h, d)
    g_out = rng.standard_normal((t, h, d)).astype(np.float32)
    g_lse = rng.standard_normal((t, h)).astype(np.float32)

    def jloss(o, l, s):
        o2, l2 = jax_out_lse_with_sink(o, l, s, layout)
        return (o2 * g_out).sum() + jnp.where(jnp.isfinite(l2), l2 * g_lse, 0.0).sum()

    jargs = tuple(map(jnp.asarray, (out, lse, sink)))
    jo, jl = jax_out_lse_with_sink(*jargs, layout)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (out, lse, sink)]
    po, pl = correct_attn_out_lse_with_sink(*ts, layout)
    ((po * torch.from_numpy(g_out)).sum()
     + torch.where(torch.isfinite(pl), pl * torch.from_numpy(g_lse), 0.0).sum()).backward()
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isneginf(pl.detach().numpy()), np.isneginf(jl))
    if n == 0:
        assert np.isneginf(jl[unc]).all()
    fin = np.isfinite(jl)
    np.testing.assert_allclose(pl.detach().numpy()[fin], jl[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(po.detach().numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    for name, x, g in zip(("dout", "dlse", "dsink"), ts, jg):
        got, g = x.grad.numpy(), np.asarray(g)
        assert np.isfinite(got).all(), name
        if layout == "shd" and n == 0 and name == "dlse":
            # JAX's gradient is NaN on the rows that stay at -inf (its
            # exp(lse - lse') evaluates -inf - -inf under the where); the
            # port's is 0 there, as on every other uncovered row
            assert np.isnan(g[unc]).all() and not got[unc].any()
            got, g = got[~unc], g[~unc]
        np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6, err_msg=name)
    # the two single-output spellings agree with the pair
    np.testing.assert_array_equal(
        correct_attn_out_with_sink(*(x.detach() for x in ts), layout).numpy(),
        po.detach().numpy())
    np.testing.assert_array_equal(
        correct_attn_lse_with_sink(ts[1].detach(), ts[2].detach(), layout).numpy(),
        pl.detach().numpy())
    np.testing.assert_allclose(
        np.asarray(jax_out_with_sink(*jargs, layout)), np.asarray(jo), rtol=0, atol=0)
    np.testing.assert_allclose(
        np.asarray(jax_lse_with_sink(jargs[1], jargs[2], layout)), jl, rtol=0, atol=0)


def test_sink_layout_shapes_are_checked():
    lse = torch.zeros((4, 2))
    out = torch.zeros((4, 2, 8))
    with pytest.raises(ValueError, match="sh sink"):
        correct_attn_out_lse_with_sink(out, lse, torch.zeros(2), "sh")
    with pytest.raises(ValueError, match="ssh sink"):
        correct_attn_out_lse_with_sink(out, lse, torch.zeros((3, 1, 2)), "ssh")
    with pytest.raises(ValueError, match="expected"):
        correct_attn_out_lse_with_sink(out, lse, torch.zeros((1, 2)), "hs")
