"""Telemetry of the port: the numerics oracle (``numerics.py``: error
budgets and divergence reports, host-side numpy) and the logger tree
(``logger.py``: ``MAGI_ATTENTION_LOG_LEVEL``)."""

from .logger import configure_logging, get_logger
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
    "configure_logging",
    "divergence_report",
    "get_logger",
    "nudge_ulps",
    "ulp_distance",
]
