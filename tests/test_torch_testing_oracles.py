"""The port's test oracles (``testing/``) against the JAX package's:
``ref_attn_online`` (against JAX's and against the dense ``ref_attn``),
the precision harness (the same norms, the same pass / fail), the flag
generator (the same combinations in every mode, and the port's flag space
accepted by the port's flag readers) and the naive dispatch oracle (against
JAX's on the same dispatch and against the port's index arithmetic)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from magiattention_tpu.common import AttnMaskType as JaxMaskType
from magiattention_tpu.common import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import (
    make_dispatch_meta_from_qk_ranges as jax_dispatch_meta,
)
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu import testing as jt
from magiattention_tpu_torch import env, testing
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.common import AttnMaskType, AttnRanges
from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu_torch.parallel.dispatch import _perm, _take_rows

BUDGET = DEFAULT_BUDGETS["float32"]


def _mask(seed, tq, tk):
    rng = np.random.default_rng(seed)
    m = rng.random((tq, tk)) < 0.5
    m[5] = False  # one uncovered row
    return m


@pytest.mark.parametrize("block", [16, 64, 128])
@pytest.mark.parametrize("seed", range(3))
def test_ref_attn_online_matches_jax_and_dense(seed, block):
    rng = np.random.default_rng(seed)
    tq, tk, hq, hk, d = 96, 160, 4, 2, 16
    q = rng.standard_normal((tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((tk, hk, d)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (tk, hk, d)).astype(np.float32)
    mask = _mask(seed, tq, tk)
    jo, jl = jt.ref_attn_online(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, block=block)
    out, lse = testing.ref_attn_online(*(torch.from_numpy(x) for x in (q, k, v)), mask,
                                       block=block)
    assert out.dtype == torch.float32
    assert_within_budget(divergence_report(np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl),
                                           test_lse=lse.numpy()), BUDGET)
    do, dl, _ = testing.ref_attn(*(torch.from_numpy(x) for x in (q, k, v)), mask)
    assert_within_budget(divergence_report(do.numpy(), out.numpy(), ref_lse=dl.numpy(),
                                           test_lse=lse.numpy()), BUDGET)
    assert (out[5] == 0).all() and torch.isneginf(lse[5]).all()


def test_precision_norms_are_jaxs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 8)).astype(np.float32)
    b = a + 1e-3 * rng.standard_normal((64, 8)).astype(np.float32)
    assert testing.calc_inf_norm(torch.from_numpy(a), b) == jt.calc_inf_norm(a, b)
    assert testing.calc_rel_err(a, torch.from_numpy(b)) == jt.calc_rel_err(a, b)
    assert testing.calc_inf_norm(np.zeros(0), np.zeros(0)) == 0.0


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1e-4, 1e-2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_assert_close_defaults_are_jaxs(scale, dtype):
    rng = np.random.default_rng(1)
    e = rng.standard_normal(100).astype(dtype)
    a = (e + scale * rng.standard_normal(100)).astype(dtype)
    want = _outcome(jt.assert_close, jnp.asarray(a), jnp.asarray(e))
    assert _outcome(testing.assert_close, a, e) == want
    assert _outcome(testing.assert_close, torch.from_numpy(a), torch.from_numpy(e)) == want


@pytest.mark.parametrize("noise", [1e-4, 3e-3, 1e-1])
def test_assert_close_to_ref_is_jaxs(noise):
    rng = np.random.default_rng(2)
    hp = rng.standard_normal(256)
    lp = hp + 1e-3 * rng.standard_normal(256)
    actual = hp + noise * rng.standard_normal(256)
    want = _outcome(jt.assert_close_to_ref, actual, lp, hp)
    assert _outcome(testing.assert_close_to_ref, torch.from_numpy(actual), lp, hp) == want


SPACE = {"a": (0, 1, 2), "b": ("x", "y"), "c": (True, False)}


@pytest.mark.parametrize("mode", ["sequential", "random", "heuristic"])
def test_flag_generator_is_jaxs(mode):
    def legal(c):
        return not (c["a"] == 2 and c["b"] == "y")

    got = list(testing.FlagCombGenerator(SPACE, legal, mode=mode, num_samples=6, seed=3))
    assert got == list(jt.FlagCombGenerator(SPACE, legal, mode=mode, num_samples=6, seed=3))
    with pytest.raises(ValueError, match="unknown mode"):
        testing.FlagCombGenerator(SPACE, mode="bogus")


def test_port_flag_space_is_read_by_the_port(monkeypatch):
    """Every legal combination of the port's flags is accepted by the
    port's readers and ``check_flag_comb``; the illegal one is refused."""
    from magiattention_tpu_torch.testing.flag_generator import is_legal

    combos = list(testing.FlagCombGenerator(mode="sequential", is_legal=is_legal))
    assert combos and all(c["MAGI_ATTENTION_HIERARCHICAL_COMM"] == "0" for c in combos)
    for combo in combos[::7]:
        for name, val in combo.items():
            monkeypatch.setenv(name, val)
        assert env.kernel_backend() == combo["MAGI_ATTENTION_KERNEL_BACKEND"]
        assert env.plan_reuse_mode() == combo["MAGI_ATTENTION_PLAN_REUSE"]
        interface.check_flag_comb()
    monkeypatch.setenv("MAGI_ATTENTION_HIERARCHICAL_COMM", "1")
    with pytest.raises(ValueError, match="two-level"):
        interface.check_flag_comb()


@pytest.mark.parametrize("cp", [2, 4])
def test_gt_dispatcher_matches_jax_and_the_index_arithmetic(cp):
    qr = [(0, 300), (300, 512), (512, 1024)]
    total, chunk = 1024, 64
    jm, _, _ = jax_dispatch_meta(JaxRanges.from_ranges(qr), JaxRanges.from_ranges(qr),
                                 [JaxMaskType(1)] * 3, total, total, chunk, cp)
    pm, _, _ = make_dispatch_meta_from_qk_ranges(AttnRanges.from_ranges(qr),
                                                 AttnRanges.from_ranges(qr), [AttnMaskType(1)] * 3,
                                                 total, total, chunk, cp)
    x = np.random.default_rng(4).standard_normal((total, 3)).astype(np.float32)
    gt, jgt = testing.GroundTruthDispatcher(pm), jt.GroundTruthDispatcher(jm)
    np.testing.assert_array_equal(gt.dispatch(x), jgt.dispatch(x))
    np.testing.assert_array_equal(gt.undispatch(gt.dispatch(x)), x)
    xt = torch.from_numpy(x)
    assert torch.equal(gt.dispatch(xt), torch.from_numpy(jgt.dispatch(x)))
    for rank in range(cp):
        np.testing.assert_array_equal(gt.shard(x, rank), jgt.shard(x, rank))
        # the port's dispatch index arithmetic gives each rank the same rows
        got = _take_rows(xt, _perm(pm, rank, "cpu"), total)
        assert torch.equal(got, torch.from_numpy(gt.shard(x, rank)))
