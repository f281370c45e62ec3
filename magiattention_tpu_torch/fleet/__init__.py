"""Fleet layer: production-shaped load over the real serving stack, and
the control loop above it. The JAX package's ``fleet/``.

Everything here runs on a LOGICAL tick clock over the lifecycle
checker's stubbed device layer, so a day of traffic replays in seconds
of host time while every host-side decision (admission, eviction, tier
placement, page streaming, requeue) is made by the REAL
``Scheduler``/``TieredScheduler`` + engine code paths. A subclass of
:class:`FleetSimulator` that overrides its device layer, clock, stack and
requests replays the same loop on the card (``chip_smoke.py``'s
``fleet`` phase).

- :mod:`~magiattention_tpu_torch.fleet.workload` — seeded, serializable
  trace generators (Poisson / bursty-MMPP / diurnal arrivals,
  zipf-shared prefixes, long-tail output lengths) and the
  ``FleetTrace`` JSON artifact format.
- :mod:`~magiattention_tpu_torch.fleet.sim` — the discrete-event
  simulator: replays a trace through the serving stack, emits the
  production ``magi_*`` metrics plus the ``magi_fleet_*`` catalog
  (``REQUIRED_FLEET_METRICS``), and snapshots ``snapshot_delta``
  windows for the autopilot.
- :mod:`~magiattention_tpu_torch.fleet.autopilot` — the closed-loop SLO
  controller: consumes windows, retunes live scheduler knobs through
  ``Scheduler.apply_knobs`` with hysteresis, per-knob cooldown and
  bounded steps so a chaos-degraded fleet is never oscillated.
- :mod:`~magiattention_tpu_torch.fleet.capacity` — the capacity
  planner: binary-searches users-per-chip at the p99 SLO per config and
  writes the curve to a path the caller names.
"""

from .autopilot import (  # noqa: F401
    Autopilot,
    AutopilotDecision,
    KnobSpec,
    SLOTargets,
    default_knob_specs,
    find_oscillations,
)
from .capacity import (  # noqa: F401
    DEFAULT_CAPACITY_CONFIGS,
    capacity_search,
    write_capacity_curve,
)
from .sim import (  # noqa: F401
    FleetReport,
    FleetSimulator,
    TickClock,
)
from .workload import (  # noqa: F401
    FLEET_TRACE_FORMAT,
    FleetTrace,
    TraceRequest,
    generate_trace,
)

__all__ = [
    "Autopilot",
    "AutopilotDecision",
    "DEFAULT_CAPACITY_CONFIGS",
    "FLEET_TRACE_FORMAT",
    "FleetReport",
    "FleetSimulator",
    "FleetTrace",
    "KnobSpec",
    "SLOTargets",
    "TickClock",
    "TraceRequest",
    "capacity_search",
    "default_knob_specs",
    "find_oscillations",
    "generate_trace",
    "write_capacity_curve",
]
