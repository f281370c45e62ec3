"""Capacity planning: users-per-chip at the p99 SLO.

The JAX package's ``fleet/capacity.py``. For each fleet config,
binary-search the highest offered load (mean users arriving per tick)
whose replay still meets the SLO attainment target, then normalize by
chip count — the users-per-chip figure a capacity planner provisions
against. Everything is seeded and tick-denominated, so a curve written
by :func:`write_capacity_curve` (to a path the caller names) is a
deterministic artifact: a real change in serving capacity (a budget
default, an admission rule, a scheduler fix) shows up as a diff.

The search dial is the trace generator's ``rate`` (arrivals/tick, see
:func:`~magiattention_tpu_torch.fleet.workload.scale_rate`); "users" for
the curve is a trace's realized request count over its horizon.
Attainment is scored over OFFERED requests (an unfinished request is a
miss), so saturation — queues growing without bound — fails the SLO
instead of hiding in a drain phase.
"""

from __future__ import annotations

import json

from .autopilot import SLOTargets
from .sim import FleetSimulator
from .workload import generate_trace, scale_rate

CAPACITY_FORMAT = "magi-fleet-capacity/v1"

# the swept fleet shapes: chip count is what users-per-chip divides by
# (1 for the single-chip scheduler, 1 prefill + dp decode for tiered)
DEFAULT_CAPACITY_CONFIGS: tuple[dict, ...] = (
    {"name": "single", "mode": "single", "chips": 1,
     "sim": {"token_budget": 64}},
    {"name": "tiered-dp2", "mode": "tiered", "chips": 3,
     "sim": {"dp": 2, "prefill_budget": 64, "decode_budget": 32}},
    {"name": "tiered-dp4", "mode": "tiered", "chips": 5,
     "sim": {"dp": 4, "prefill_budget": 64, "decode_budget": 32}},
)

# the probe workload: stationary Poisson, moderate sharing, bounded
# tails — rate is the dial the search moves
DEFAULT_TRACE_KWARGS: dict = {
    "seed": 20260807,
    "horizon_ticks": 192,
    "arrival": "poisson",
    "rate": 1.0,
    "prefix_pool": 6,
    "prefix_pages": 1,
    "shared_fraction": 0.7,
    "suffix_len_range": (2, 10),
    "output_len_median": 3.0,
    "output_len_sigma": 0.5,
    "output_len_max": 16,
}


def _attainment_at(
    rate: float,
    *,
    mode: str,
    sim_kwargs: dict,
    trace_kwargs: dict,
    slo: SLOTargets,
) -> tuple[float, int]:
    """(attainment over offered, realized request count) at one rate."""
    kw = scale_rate(trace_kwargs, rate)
    trace = generate_trace(f"capacity-r{rate:g}", **kw)
    sim = FleetSimulator(
        trace, mode=mode, autopilot=None, slo=slo, **sim_kwargs
    )
    report = sim.run()
    return report.attainment_offered, report.offered


def capacity_search(
    *,
    mode: str,
    sim_kwargs: dict | None = None,
    trace_kwargs: dict | None = None,
    slo: SLOTargets | None = None,
    lo_rate: float = 0.25,
    hi_rate: float = 16.0,
    iterations: int = 7,
) -> dict:
    """Binary-search the highest arrival rate that still meets the SLO
    attainment target for one config.

    Returns ``{rate, users, attainment, feasible_lo, infeasible_hi}``:
    ``rate`` is the last FEASIBLE rate probed (attainment >= target),
    ``users`` its realized request count. If even ``lo_rate`` misses
    the target, ``rate`` is 0 — the config cannot hold the SLO at all.
    """
    slo = slo if slo is not None else SLOTargets()
    sim_kwargs = dict(sim_kwargs or {})
    trace_kwargs = dict(trace_kwargs or DEFAULT_TRACE_KWARGS)
    target = slo.attainment_target

    best_rate, best_users, best_att = 0.0, 0, 0.0
    att, users = _attainment_at(
        lo_rate, mode=mode, sim_kwargs=sim_kwargs,
        trace_kwargs=trace_kwargs, slo=slo,
    )
    if att < target:
        return {
            "rate": 0.0, "users": 0, "attainment": att,
            "feasible_lo": None, "infeasible_hi": lo_rate,
        }
    best_rate, best_users, best_att = lo_rate, users, att
    lo, hi = lo_rate, hi_rate
    att, users = _attainment_at(
        hi_rate, mode=mode, sim_kwargs=sim_kwargs,
        trace_kwargs=trace_kwargs, slo=slo,
    )
    if att >= target:
        # the ceiling holds: report it rather than searching past it
        return {
            "rate": hi_rate, "users": users, "attainment": att,
            "feasible_lo": hi_rate, "infeasible_hi": None,
        }
    for _ in range(int(iterations)):
        mid = 0.5 * (lo + hi)
        att, users = _attainment_at(
            mid, mode=mode, sim_kwargs=sim_kwargs,
            trace_kwargs=trace_kwargs, slo=slo,
        )
        if att >= target:
            lo = mid
            best_rate, best_users, best_att = mid, users, att
        else:
            hi = mid
    return {
        "rate": best_rate,
        "users": best_users,
        "attainment": best_att,
        "feasible_lo": lo,
        "infeasible_hi": hi,
    }


def write_capacity_curve(
    path,
    *,
    configs=DEFAULT_CAPACITY_CONFIGS,
    trace_kwargs: dict | None = None,
    slo: SLOTargets | None = None,
    iterations: int = 7,
) -> dict:
    """Sweep every config, write the curve artifact, return it."""
    slo = slo if slo is not None else SLOTargets()
    trace_kwargs = dict(trace_kwargs or DEFAULT_TRACE_KWARGS)
    rows = []
    for cfg in configs:
        found = capacity_search(
            mode=cfg["mode"],
            sim_kwargs=cfg.get("sim"),
            trace_kwargs=trace_kwargs,
            slo=slo,
            iterations=iterations,
        )
        chips = int(cfg["chips"])
        rows.append(
            {
                "name": cfg["name"],
                "mode": cfg["mode"],
                "chips": chips,
                "max_rate_per_tick": found["rate"],
                "users": found["users"],
                "users_per_chip": (
                    found["users"] / chips if chips else 0.0
                ),
                "attainment": found["attainment"],
            }
        )
    curve = {
        "format": CAPACITY_FORMAT,
        "slo": slo.to_json(),
        "trace": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in trace_kwargs.items()
        },
        "iterations": int(iterations),
        "configs": rows,
    }
    with open(path, "w") as f:
        json.dump(curve, f, indent=1, sort_keys=True)
        f.write("\n")
    return curve
