"""Telemetry of the port: the numerics oracle (``numerics.py``: error
budgets and divergence reports, host-side numpy)."""

from .numerics import (
    DEFAULT_BUDGETS,
    DivergenceReport,
    ErrorBudget,
    ErrorBudgetExceeded,
    assert_within_budget,
    budget_for_dtype,
    divergence_report,
    nudge_ulps,
    ulp_distance,
)

__all__ = [
    "DEFAULT_BUDGETS",
    "DivergenceReport",
    "ErrorBudget",
    "ErrorBudgetExceeded",
    "assert_within_budget",
    "budget_for_dtype",
    "divergence_report",
    "nudge_ulps",
    "ulp_distance",
]
