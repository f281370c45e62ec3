"""The port's ``telemetry/numerics.py`` (the numpy oracle the port's parity
tests gate through) against the JAX package's: ulp distances and nudges in
float32 / float16 / float64, divergence reports with and without the lse
component (-inf rows, NaNs), the default budgets, their composition, and
the gate's verdicts and breached stats."""

import dataclasses

import numpy as np
import pytest

from magiattention_tpu.telemetry import numerics as jnum
from magiattention_tpu_torch.telemetry import numerics as pnum


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
@pytest.mark.parametrize("n", [-5, -1, 0, 1, 3, 4096])
def test_ulp_machinery_is_jax(dtype, n):
    rng = np.random.default_rng(abs(n))
    x = np.concatenate([rng.standard_normal(64), [0.0, -0.0, 1e-30, -1e-30]]).astype(dtype)
    moved = pnum.nudge_ulps(x, n)
    assert moved.tobytes() == jnum.nudge_ulps(x, n).tobytes()
    d = pnum.ulp_distance(x, moved)
    assert d.tobytes() == jnum.ulp_distance(x, moved).tobytes()
    assert (d == abs(n)).all()  # -0.0 and +0.0 are the same point of the walk


def _report_fields(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_lse", [False, True])
def test_divergence_report_is_jax(seed, with_lse):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((32, 4, 8)).astype(np.float32)
    test = pnum.nudge_ulps(ref, int(rng.integers(0, 40)))
    test[0, 0, 0] += np.float32(1e-3 * seed)
    if seed == 5:
        test[1, 1, 1] = np.nan
    kw = {}
    if with_lse:
        lse = rng.standard_normal((32, 4)).astype(np.float32)
        lse[:3] = -np.inf
        tlse = lse + np.float32(1e-5)
        tlse[0, 0] = 0.0 if seed == 4 else -np.inf
        kw = dict(ref_lse=lse, test_lse=tlse)
    got, want = pnum.divergence_report(ref, test, **kw), jnum.divergence_report(ref, test, **kw)
    assert _report_fields(got) == _report_fields(want)
    for name, budget in pnum.DEFAULT_BUDGETS.items():
        jb = jnum.DEFAULT_BUDGETS[name]
        assert dataclasses.asdict(budget) == dataclasses.asdict(jb)
        assert budget.violations(got) == jb.violations(want)
        assert got.within(budget) == want.within(jb)


def test_budget_composition_and_lookup_are_jax():
    a, b = pnum.DEFAULT_BUDGETS["float32"], pnum.DEFAULT_BUDGETS["bfloat16"]
    ja, jb = jnum.DEFAULT_BUDGETS["float32"], jnum.DEFAULT_BUDGETS["bfloat16"]
    assert dataclasses.asdict(a & b) == dataclasses.asdict(ja & jb)
    assert dataclasses.asdict(a | b) == dataclasses.asdict(ja | jb)
    assert pnum.budget_for_dtype(np.float32) == a and pnum.budget_for_dtype("bfloat16") == b
    with pytest.raises(ValueError, match="no default error budget"):
        pnum.budget_for_dtype(np.int8)
    with pytest.raises(ValueError, match="shape mismatch"):
        pnum.divergence_report(np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError, match="without ref_lse"):
        pnum.divergence_report(np.zeros(3), np.zeros(3), test_lse=np.zeros(3))


def test_the_gate_names_the_breached_stats():
    ref = np.ones((16,), np.float32)
    ok = pnum.divergence_report(ref, pnum.nudge_ulps(ref, 3))
    assert pnum.assert_within_budget(ok) is ok  # the dtype's own row
    bad = pnum.divergence_report(ref, ref + np.float32(0.5), ref_lse=ref, test_lse=ref + 1)
    with pytest.raises(pnum.ErrorBudgetExceeded) as err:
        pnum.assert_within_budget(bad, where="here")
    with pytest.raises(jnum.ErrorBudgetExceeded) as jerr:
        jnum.assert_within_budget(jnum.divergence_report(ref, ref + np.float32(0.5), ref_lse=ref,
                                                         test_lse=ref + 1), where="here")
    assert err.value.violations == jerr.value.violations
    assert str(err.value) == str(jerr.value)
    assert "lse.max_abs" in err.value.violations and "out.max_abs" in err.value.violations
