"""The port's numerical guards (``resilience/guards.py``) against the JAX
package's on the same numpy partials: a -inf lse is healthy; ``check``
passes the data through bit for bit and gives JAX's error-code value;
``repair`` gives JAX's outputs; a quarantined partial merges as a no-op
through ``correct_attn_out_lse``; ``consume_error_code`` raises
``NumericalGuardError`` with JAX's site list and is silent at 0 or None;
and ``off`` calls no guard function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops.correction import correct_attn_out_lse as jax_correct
from magiattention_tpu.resilience import guards as JG
from magiattention_tpu_torch.ops.correction import correct_attn_out_lse
from magiattention_tpu_torch.resilience import guards as G

NEG_INF = float("-inf")
RTOL, ATOL = 2e-4, 2e-5


def _partial(bad=None, shape=(4, 2, 3), seed=0):
    """(out, lse) numpy f32 with an optional fault planted."""
    rng = np.random.default_rng(seed)
    out = rng.standard_normal(shape).astype(np.float32)
    lse = rng.standard_normal(shape[:-1]).astype(np.float32)
    if bad == "nan_out":
        out[1, 0, 2] = np.nan
    elif bad == "inf_out":
        out[3, 1, 0] = -np.inf
    elif bad == "inf_lse":
        lse[2, 1] = np.inf
    elif bad == "nan_lse":
        lse[0, 0] = np.nan
    elif bad == "neginf_lse":  # healthy: no coverage
        lse[1, 1] = NEG_INF
        out[1, 1] = 0.0
    return out, lse


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _same(got, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_GUARD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_CHAOS", raising=False)


def test_neg_inf_lse_is_healthy(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    out, lse = np.zeros((4, 2, 3), np.float32), np.full((4, 2), NEG_INF, np.float32)
    o, l, code = G.guard_partial(*_t(out, lse), G.new_error_code(), 0, "s")
    assert int(code) == 0 == int(JG.guard_partial(jnp.asarray(out), jnp.asarray(lse),
                                                  JG.new_error_code(), 0, "s")[2])
    assert _same(l, lse)


@pytest.mark.parametrize("site_index", [0, 3, 30, 33])
@pytest.mark.parametrize("fault", ["nan_out", "inf_out", "inf_lse", "nan_lse", "neginf_lse",
                                   None])
def test_check_passes_through_and_codes_as_jax(fault, site_index, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    out, lse = _partial(fault)
    o_t, l_t = _t(out, lse)
    code0 = G.new_error_code()
    code0 |= 4  # an earlier site's bit survives
    o, l, code = G.guard_partial(o_t, l_t, code0, site_index, f"s{site_index}")
    _, _, want = JG.guard_partial(jnp.asarray(out), jnp.asarray(lse),
                                  jnp.asarray(4, jnp.int32), site_index, f"s{site_index}")
    assert code.dtype == torch.int32 and int(code) == int(want)
    assert o is o_t and l is l_t  # check mode: the same tensors, bit for bit
    assert (int(code) != 4) == (fault not in (None, "neginf_lse")) or site_index % 31 == 2


@pytest.mark.parametrize("fault", ["nan_out", "inf_out", "inf_lse", "nan_lse", "neginf_lse"])
def test_repair_quarantines_as_jax(fault, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "repair")
    out, lse = _partial(fault, shape=(6, 3, 8), seed=1)
    o, l, code = G.guard_partial(*_t(out, lse), G.new_error_code(), 0, "s")
    wo, wl, wcode = JG.guard_partial(jnp.asarray(out), jnp.asarray(lse), JG.new_error_code(),
                                     0, "s")
    assert _same(o, wo) and _same(l, wl) and int(code) == int(wcode)
    assert torch.isfinite(o).all()
    # no code threaded: repair still applies
    o2, l2, none = G.guard_partial(*_t(out, lse), None, 0, "s")
    assert none is None and _same(o2, wo) and _same(l2, wl)


def test_quarantine_if_repair(monkeypatch):
    out, lse = _partial("nan_lse")
    for mode in ("check", "repair"):
        monkeypatch.setenv("MAGI_ATTENTION_GUARD", mode)
        o_t, l_t = _t(out, lse)
        o, l = G.quarantine_if_repair(o_t, l_t, "correction")
        wo, wl = JG.quarantine_if_repair(jnp.asarray(out), jnp.asarray(lse), "correction")
        assert _same(o, wo) and _same(l, wl)
        if mode == "check":
            assert o is o_t and l is l_t


def test_quarantined_partial_merges_as_noop(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "repair")
    good_out, good_lse = _partial()
    poison_out = np.full_like(good_out, np.nan)
    poison_lse = np.full_like(good_lse, np.inf)
    out, lse = correct_attn_out_lse(*_t(good_out, good_lse, poison_out, poison_lse))
    np.testing.assert_allclose(out.numpy(), good_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), good_lse, rtol=RTOL, atol=ATOL)
    wo, wl = jax_correct(*(jnp.asarray(x) for x in (good_out, good_lse, poison_out, poison_lse)))
    np.testing.assert_allclose(out.numpy(), np.asarray(wo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wl), rtol=RTOL, atol=ATOL)


def test_correction_off_mode_propagates_the_poison():
    good_out, good_lse = _partial()
    poison_out = np.full_like(good_out, np.nan)
    out, _ = correct_attn_out_lse(*_t(good_out, good_lse, poison_out, np.zeros_like(good_lse)))
    assert torch.isnan(out).any()


@pytest.mark.parametrize("code,sites", [
    ([0b101], ("host", "stage0", "stage1")),
    ([0b10, 0b1], ("a", "b", "c")),  # two ranks' codes are ORed
    ([1 << 1], tuple(f"split{i}" for i in range(33))),  # wraps past 31 bits
])
def test_consume_raises_with_jax_sites(code, sites, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    with pytest.raises(JG.NumericalGuardError) as want:
        JG.consume_error_code(jnp.asarray(code, jnp.int32), sites)
    with pytest.raises(G.NumericalGuardError) as got:
        G.consume_error_code(torch.tensor(code, dtype=torch.int32), sites)
    assert got.value.sites == want.value.sites
    assert str(got.value) == str(want.value)


def test_consume_repair_and_silence(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "repair")
    G.consume_error_code(torch.tensor(0b11, dtype=torch.int32), ("a", "b"))  # recorded, no raise
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    G.consume_error_code(torch.zeros((2,), dtype=torch.int32), ("a",))
    G.consume_error_code(None, ("a",))
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "off")
    G.consume_error_code(torch.tensor(1, dtype=torch.int32), ("a",))


def test_plan_guard_sites_as_jax():
    import types

    for degree, stages in ((0, 0), (1, 1), (3, 3)):
        plan = types.SimpleNamespace(overlap_degree=degree, stages=(None,) * stages)
        assert G.plan_guard_sites(plan) == JG.plan_guard_sites(plan)
    assert G.split_guard_sites(3) == ("split0", "split1", "split2")


def test_off_mode_calls_no_guard_function(monkeypatch):
    """Off: the correction, the decode and the cp merge call no guard
    function (a tripwire in its place)."""
    from magiattention_tpu_torch.serving import assign_block_table, decode_attn_paged
    from magiattention_tpu_torch.serving import make_paged_kv_cache

    def tripwire(*a, **k):
        raise AssertionError("a guard function ran with guards off")

    monkeypatch.setattr(G, "guard_partial", tripwire)
    monkeypatch.setattr(G, "new_error_code", tripwire)
    out, lse = _partial()
    correct_attn_out_lse(*_t(out, lse, out, lse))
    cache = make_paged_kv_cache(3, 8, 2, 16, max_seqs=1, max_pages_per_seq=2,
                                dtype=torch.float32, device="cpu")
    assign_block_table(cache, 0, [1, 2], keep_len=5)
    decode_attn_paged(torch.ones((1, 4, 16)), cache, torch.zeros(1, dtype=torch.int32),
                      num_splits=2)
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "repair")
    with pytest.raises(AssertionError, match="guards off"):
        correct_attn_out_lse(*_t(out, lse, out, lse))
