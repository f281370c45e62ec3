"""Numerics oracle: error budgets and divergence reports.

The port's copy of the host-side (numpy) part of the JAX package's
``telemetry/numerics.py``. :func:`divergence_report` scores a test array
against a reference per position: absolute, relative and ulp error (the
bit-pattern distance in the test dtype's own grid), with out-vs-lse
attribution when both components are given. :class:`ErrorBudget` is the
composable policy (per-dtype defaults in :data:`DEFAULT_BUDGETS`; ``&`` =
the strictest of two budgets, ``|`` = the loosest), and
:func:`assert_within_budget` is the gate the parity tests share. Torch
tensors go in through numpy (``t.detach().cpu().numpy()``). The in-graph
value census of the JAX module needs the telemetry registry and is not
part of this copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# relative error denominator floor: |test - ref| / max(|ref|, floor) keeps
# near-zero reference positions from reporting infinite relative error
REL_FLOOR = 1e-6


def _int_type(dtype: np.dtype) -> np.dtype:
    return np.dtype(f"int{np.dtype(dtype).itemsize * 8}")


def _ordered_ints(x: np.ndarray) -> np.ndarray:
    """Float bit patterns as integers ordered like the floats (±0 both at
    0): the ulp distance is then a plain integer distance."""
    itype = _int_type(x.dtype)
    i = x.view(itype).astype(np.int64)
    return np.where(i >= 0, i, np.iinfo(itype).min - i)


def ulp_distance(ref, test) -> np.ndarray:
    """Per-position ulp distance between ``ref`` and ``test`` in
    ``test``'s dtype grid (``ref`` is rounded onto it first: the honest
    comparison of a low-precision path with an f32 oracle). Agreeing NaNs
    count 0; any other non-finite disagreement shows as the huge
    bit-pattern distance it is."""
    t = np.asarray(test)
    r = np.asarray(ref).astype(t.dtype)
    d = np.abs(_ordered_ints(t) - _ordered_ints(r))
    both_nan = np.isnan(t.astype(np.float64)) & np.isnan(r.astype(np.float64))
    return np.where(both_nan, 0, d)


def nudge_ulps(x, n: int):
    """``x`` moved by ``n`` ulps in its own dtype (negative ``n`` walks
    down): how a check plants a divergence of exactly n ulps."""
    a = np.asarray(x)
    itype = _int_type(a.dtype)
    ordered = _ordered_ints(a) + int(n)
    back = np.where(ordered >= 0, ordered, np.iinfo(itype).min - ordered).astype(itype)
    return back.view(a.dtype)


class ErrorBudgetExceeded(ValueError):
    """A divergence report breached its budget. ``violations`` names the
    breached stats (``out.max_ulp``, ``lse.max_abs``, ...): the out-vs-lse
    attribution."""

    def __init__(self, violations, report, budget, where: str = ""):
        self.violations = tuple(violations)
        self.report = report
        self.budget = budget
        loc = f" at {where}" if where else ""
        super().__init__(
            f"error budget exceeded{loc}: {list(self.violations)} "
            f"(dtype {report.dtype}: out max_abs {report.out_max_abs:.3e}"
            f"/{budget.max_abs:.3e}, max_rel {report.out_max_rel:.3e}"
            f"/{budget.max_rel:.3e}, max_ulp {report.out_max_ulp:.0f}"
            f"/{budget.max_ulp:.0f}; dominant component: {report.dominant})"
        )


@dataclasses.dataclass(frozen=True)
class ErrorBudget:
    """Per-dtype divergence policy. ``max_*`` bound the out component,
    ``lse_max_*`` the (always f32) lse component. Compose with ``&``
    (the strictest of each field) or ``|`` (the loosest), or
    ``dataclasses.replace`` for one field."""

    dtype: str
    max_abs: float
    max_rel: float
    max_ulp: float
    lse_max_abs: float
    lse_max_ulp: float

    _FIELDS = ("max_abs", "max_rel", "max_ulp", "lse_max_abs", "lse_max_ulp")

    def __and__(self, other: "ErrorBudget") -> "ErrorBudget":
        return ErrorBudget(dtype=f"{self.dtype}&{other.dtype}",
                           **{f: min(getattr(self, f), getattr(other, f)) for f in self._FIELDS})

    def __or__(self, other: "ErrorBudget") -> "ErrorBudget":
        return ErrorBudget(dtype=f"{self.dtype}|{other.dtype}",
                           **{f: max(getattr(self, f), getattr(other, f)) for f in self._FIELDS})

    def violations(self, report: "DivergenceReport") -> list[str]:
        """The breached stats as ``component.stat``; empty within budget."""
        out = []
        if report.out_max_abs > self.max_abs:
            out.append("out.max_abs")
        if report.out_max_rel > self.max_rel:
            out.append("out.max_rel")
        if report.out_max_ulp > self.max_ulp:
            out.append("out.max_ulp")
        if report.lse_max_abs is not None:
            if report.lse_max_abs > self.lse_max_abs:
                out.append("lse.max_abs")
            if report.lse_max_ulp > self.lse_max_ulp:
                out.append("lse.max_ulp")
        return out

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# Per-dtype defaults, the JAX package's rows (calibrated there against the
# split-merge against single-split drift of decode: summation order only)
DEFAULT_BUDGETS: dict[str, ErrorBudget] = {
    "float32": ErrorBudget("float32", max_abs=1e-4, max_rel=1e-3, max_ulp=4096,
                           lse_max_abs=1e-4, lse_max_ulp=4096),
    "bfloat16": ErrorBudget("bfloat16", max_abs=0.05, max_rel=0.05, max_ulp=8,
                            lse_max_abs=1e-3, lse_max_ulp=8192),
    "float16": ErrorBudget("float16", max_abs=0.01, max_rel=0.01, max_ulp=32,
                           lse_max_abs=1e-3, lse_max_ulp=8192),
    "float8_e4m3fn": ErrorBudget("float8_e4m3fn", max_abs=0.25, max_rel=0.25, max_ulp=2,
                                 lse_max_abs=1e-2, lse_max_ulp=16384),
    "float8_e5m2": ErrorBudget("float8_e5m2", max_abs=0.5, max_rel=0.5, max_ulp=2,
                               lse_max_abs=1e-2, lse_max_ulp=16384),
}


def budget_for_dtype(dtype) -> ErrorBudget:
    """The default :class:`ErrorBudget` of a dtype (a name or a numpy
    dtype); ``ValueError`` for a dtype without a row."""
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    try:
        return DEFAULT_BUDGETS[name]
    except KeyError:
        raise ValueError(f"no default error budget for dtype {name!r} "
                         f"(known: {sorted(DEFAULT_BUDGETS)}); pass an explicit ErrorBudget") from None


@dataclasses.dataclass(frozen=True)
class DivergenceReport:
    """Per-position divergence stats of a (test, reference) pair. Out stats
    are in the test dtype's grid (``dtype``), lse stats in the lse dtype's;
    ``worst`` is the flat index of the largest-ulp out position;
    ``dominant`` names the component with the larger ulp error."""

    dtype: str
    shape: tuple
    out_max_abs: float
    out_mean_abs: float
    out_max_rel: float
    out_max_ulp: float
    out_mean_ulp: float
    worst: int
    lse_max_abs: float | None
    lse_max_ulp: float | None
    dominant: str  # "out" | "lse"

    def within(self, budget: ErrorBudget) -> bool:
        return not budget.violations(self)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def divergence_report(ref, test, *, ref_lse=None, test_lse=None) -> DivergenceReport:
    """Score ``test`` against the reference ``ref`` (the out component);
    pass the lse pair too for the out-vs-lse attribution, which matters for
    an LSE-corrected merge, where a wrong lse poisons out
    multiplicatively."""
    t = np.asarray(test)
    r64 = np.asarray(ref).astype(np.float64)
    t64 = t.astype(np.float64)
    if r64.shape != t64.shape:
        raise ValueError(f"divergence_report: shape mismatch ref {r64.shape} vs test {t64.shape}")
    abs_err = np.abs(t64 - r64)
    rel_err = abs_err / np.maximum(np.abs(r64), REL_FLOOR)
    ulp = ulp_distance(ref, test).astype(np.float64)
    # a NaN error (non-finite values) must not hide behind np.max's NaN
    # propagation: score it as infinite
    abs_err = np.where(np.isnan(abs_err), np.inf, abs_err)
    rel_err = np.where(np.isnan(rel_err), np.inf, rel_err)
    worst = int(np.argmax(ulp)) if ulp.size else 0
    lse_max_abs = lse_max_ulp = None
    if test_lse is not None:
        if ref_lse is None:
            raise ValueError("divergence_report: test_lse supplied without ref_lse")
        rl = np.asarray(ref_lse).astype(np.float64)
        tl = np.asarray(test_lse).astype(np.float64)
        # lse = -inf is the zero-coverage value: agreeing -inf rows are exact
        # (the -inf - -inf NaN is masked away), disagreeing ones infinitely off
        with np.errstate(invalid="ignore"):
            lse_abs = np.abs(tl - rl)
        lse_abs = np.where(np.isneginf(rl) & np.isneginf(tl), 0.0, lse_abs)
        lse_abs = np.where(np.isnan(lse_abs), np.inf, lse_abs)
        lse_max_abs = float(np.max(lse_abs)) if lse_abs.size else 0.0
        lse_ulp = ulp_distance(ref_lse, test_lse).astype(np.float64)
        lse_max_ulp = float(np.max(lse_ulp)) if lse_ulp.size else 0.0
    out_max_ulp = float(np.max(ulp)) if ulp.size else 0.0
    dominant = "out"
    if lse_max_ulp is not None and lse_max_ulp > out_max_ulp:
        dominant = "lse"
    return DivergenceReport(
        dtype=str(t.dtype),
        shape=tuple(int(s) for s in t.shape),
        out_max_abs=float(np.max(abs_err)) if abs_err.size else 0.0,
        out_mean_abs=float(np.mean(abs_err)) if abs_err.size else 0.0,
        out_max_rel=float(np.max(rel_err)) if rel_err.size else 0.0,
        out_max_ulp=out_max_ulp,
        out_mean_ulp=float(np.mean(ulp)) if ulp.size else 0.0,
        worst=worst,
        lse_max_abs=lse_max_abs,
        lse_max_ulp=lse_max_ulp,
        dominant=dominant,
    )


def assert_within_budget(report: DivergenceReport, budget: ErrorBudget | None = None, *,
                         where: str = "") -> DivergenceReport:
    """The gate: raise :class:`ErrorBudgetExceeded` naming the breached
    stats when ``report`` exceeds ``budget`` (default: the report dtype's
    :func:`budget_for_dtype` row). Returns the report."""
    if budget is None:
        budget = budget_for_dtype(report.dtype)
    bad = budget.violations(report)
    if bad:
        raise ErrorBudgetExceeded(bad, report, budget, where=where)
    return report
