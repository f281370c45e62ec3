"""Numerical guards (``MAGI_ATTENTION_GUARD=off|check|repair``).

The JAX package's ``resilience/guards.py`` on torch tensors. The runtime's
output is LSE-corrected merges of partial (out, lse) pairs, so one
non-finite partial poisons everything downstream. The guards sit on the
kernels' partials at every merge boundary (the decode splits, the cp
stages, ``ops/correction``) and detect or contain that:

- detection is error-code accumulation: each guarded site ORs one bit into
  an int32 code that lives on the partials' device, with ``torch.where``,
  so nothing inside a guarded region waits on the device;
- ``check`` leaves the data bit for bit as ``off`` would and reads the code
  on the host once, at the call boundary (:func:`consume_error_code`),
  raising a typed :class:`NumericalGuardError` naming the failing sites;
- ``repair`` also quarantines bad rows (lse -> -inf, out -> 0), so that one
  poisoned partial merges as a no-op through the -inf-safe correction.
  The quarantine is ``torch.where``, so a quarantined row's cotangent is
  exactly zero.

A partial's legitimate "no coverage" value is lse = -inf with out = 0; the
guards treat it as healthy (only a NaN or +inf lse, or a non-finite out,
is bad). ``off`` calls no guard function at all.

Telemetry, as the JAX package records it: ``magi_guard_checks{site=}``
ticks once per guard call (the port runs eagerly; the JAX package counts
once per traced program), ``magi_guard_violations`` / ``_repairs`` once per
bad site of a code read at the call boundary, and a ``check`` violation
writes the flight recorder's ``numerical_guard`` dump before it raises.
The counters are host work on the code already read: no hook reads a
device tensor.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")

# one bit per site in the int32 code; deep split counts wrap (site names
# may alias past 31 sites: the decode reports every aliased candidate)
_CODE_BITS = 31


class NumericalGuardError(RuntimeError):
    """A guarded merge saw a non-finite partial (``check`` mode).

    ``sites`` names the tripped guard sites, e.g. ``("stage1",)``."""

    def __init__(self, sites):
        self.sites = tuple(sites)
        super().__init__(
            "non-finite partial detected at guard site(s) "
            f"{list(self.sites)} (MAGI_ATTENTION_GUARD=check; use "
            "'repair' to quarantine instead of raising)"
        )


def guard_mode() -> str:
    from .. import env

    return env.guard_mode()


def guards_active() -> bool:
    return guard_mode() != "off"


def new_error_code(device=None):
    """A zero int32 error code on ``device`` (a scalar tensor)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def _good_rows(out, lse):
    """[..., h] bool: the healthy rows of a partial: every out element
    finite, and lse below +inf (a NaN compares false; -inf, the legitimate
    zero-coverage value, is healthy)."""
    return torch.isfinite(out).all(dim=-1) & (lse < float("inf"))


def _bad_rows(out, lse):
    """[..., h] bool: the poisoned rows of a partial (a NaN or +inf lse, or a
    non-finite out element); lse = -inf with out = 0 stays healthy."""
    return ~_good_rows(out, lse)


def guard_partial(out, lse, code, site_index: int, site: str):
    """Guard one partial (out [..., h, d], lse [..., h]) at ``site``.

    Returns ``(out, lse, code)``: in ``check`` mode the data passes through
    bit for bit (the same tensors) and the site's bit is ORed into ``code``
    with ``torch.where``; in ``repair`` mode the bad rows are also
    quarantined to (0, -inf) with ``torch.where``. ``code`` may be None (a
    caller that threads no code: repair still applies). No operand is copied
    from the host: the bit and the fills are kernel scalars. ``off`` must
    not call this."""
    from .. import telemetry

    mode = guard_mode()
    assert mode != "off", "guard_partial called with guards off"
    telemetry.record_guard_check(site)
    good = _good_rows(out, lse)
    if code is not None:
        bit = 1 << (site_index % _CODE_BITS)
        code = torch.where(good.all().to(code.device), code, code | bit)
    if mode == "repair":
        lse = torch.where(good, lse, NEG_INF)
        out = torch.where(good[..., None], out, 0.0)
    return out, lse, code


def quarantine_if_repair(out, lse, site: str):
    """Repair-only guard for the merges that thread no code
    (``ops/correction``, the LSE group reduce): quarantine the bad rows in
    ``repair`` mode, return the inputs untouched otherwise."""
    if guard_mode() != "repair":
        return out, lse
    out, lse, _ = guard_partial(out, lse, None, 0, site)
    return out, lse


def plan_guard_sites(plan) -> tuple[str, ...]:
    """The guard-site names of a ``DistAttnPlan`` in error-code bit order:
    the order ``dist_attn_local`` guards in."""
    if plan.overlap_degree == 0:
        return ("merged",)
    return ("host",) + tuple(f"stage{i}" for i in range(len(plan.stages)))


def split_guard_sites(num_splits: int) -> tuple[str, ...]:
    """The guard-site names of a split-KV decode's partials."""
    return tuple(f"split{i}" for i in range(num_splits))


# -- the call boundary ----------------------------------------------------------------


def _decode_bits(value: int, sites) -> list[str]:
    return [s for i, s in enumerate(tuple(sites)) if (value >> (i % _CODE_BITS)) & 1]


def consume_error_code(code, sites, *, mode: str | None = None) -> None:
    """Read an accumulated error code on the host, once, where the outputs
    leave the guarded region (the JAX package's eager ``_report``). A zero
    code or ``None`` is silent; in ``check`` mode a set bit raises
    :class:`NumericalGuardError` naming its sites. ``code`` may be a tensor
    of codes (one per rank or call): they are ORed."""
    if code is None:
        return
    if mode is None:
        mode = guard_mode()
    if mode == "off":
        return
    value = 0
    for v in torch.as_tensor(code).reshape(-1).tolist():
        value |= int(v)
    if not value:
        return
    bad = _decode_bits(value, sites)
    from .. import telemetry

    for s in bad:
        if mode == "repair":
            telemetry.record_guard_repair(s)
        else:
            telemetry.record_guard_violation(s)
    if mode == "check":
        # a tripped guard is a post-mortem moment: dump the serving flight
        # recorder's recent ticks, if any were recorded
        telemetry.get_flight_recorder().trigger("numerical_guard", sites=list(bad))
        raise NumericalGuardError(bad)
