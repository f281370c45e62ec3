"""Resilience: fault injection, numerical guards, degradation.

The JAX package's ``resilience/`` on torch:

- :mod:`.chaos`: deterministic, seedable fault injection behind
  ``MAGI_ATTENTION_CHAOS`` (kernel-partial nan/inf, cast and reduce payload
  corruption, pool exhaustion, allocation, prefill, decode-replica, plan
  and hop-plan build failures, hop stragglers), each injector addressed by
  site;
- :mod:`.guards`: the numerical guards behind
  ``MAGI_ATTENTION_GUARD=off|check|repair``: an int32 error code on the
  device, read once at the call boundary (a typed
  :class:`NumericalGuardError` in ``check``), and the where-based
  quarantine (lse -> -inf, out -> 0) of ``repair``;
- the degradation paths live at their call sites: ``ServingEngine.admit``
  answers an ``AdmissionResult`` (``pool_exhausted``, ``alloc_error``)
  and never raises on resource pressure, a failed prefill releases its
  pages, a failed decode replica is torn down and its requests replayed,
  a failed plan build falls back to the degree-0 plan, a failed hop-plan
  build to the a2a collective; each fallback warns on the
  ``magiattention_tpu_torch.resilience`` logger.
"""

from .chaos import (  # noqa: F401
    ChaosClause,
    ChaosInjectedError,
    ChaosInjectedIOError,
    enabled as chaos_enabled,
    get_chaos,
    parse_chaos_spec,
    reset_chaos,
)
from .guards import (  # noqa: F401
    NumericalGuardError,
    consume_error_code,
    guard_mode,
    guard_partial,
    guards_active,
    new_error_code,
    plan_guard_sites,
    quarantine_if_repair,
)

__all__ = [
    "ChaosClause",
    "ChaosInjectedError",
    "ChaosInjectedIOError",
    "NumericalGuardError",
    "chaos_enabled",
    "consume_error_code",
    "get_chaos",
    "guard_mode",
    "guard_partial",
    "guards_active",
    "new_error_code",
    "parse_chaos_spec",
    "plan_guard_sites",
    "quarantine_if_repair",
    "reset_chaos",
]
