"""Closed-loop SLO autopilot.

The JAX package's ``fleet/autopilot.py``, over the port's env readers and
``record_fleet_*`` recorders. It consumes ``snapshot_delta`` windows
(``telemetry/exposition.py``) and decides bounded retunes of the live
scheduler knobs that ``Scheduler.apply_knobs`` /
``TieredScheduler.apply_knobs`` expose. The
controller is deliberately a RULE system, not an optimizer: every
decision is explainable from one window's numbers, and the
anti-oscillation contract is structural —

- **hysteresis**: no action while SLO attainment sits inside
  ``±hysteresis`` of the target band;
- **per-knob cooldown**: a knob that moved is frozen for
  ``cooldown_windows`` evaluation windows (``MAGI_ATTENTION_FLEET_
  COOLDOWN``);
- **bounded steps**: each action moves one knob by exactly one
  :class:`KnobSpec` step, clamped to ``[lo, hi]``;
- **reversal suppression**: a knob may not reverse direction within
  ``2 * cooldown_windows`` of its last move — the classic limit cycle
  (up, down, up, down...) is structurally impossible;
- **fault hold**: a window that saw tier faults (chaos or organic) is
  never acted on — retuning a degraded fleet on fault-polluted numbers
  is how controllers oscillate (a ``decode_fault`` chaos tick injects
  exactly this);
- **one action per window**: at most one knob moves per evaluation,
  so causality between an action and the next window's numbers stays
  readable.

:func:`find_oscillations` checks the contract on a finished run's action
log: a chaos scenario must show zero oscillation, and a deliberately
oscillating controller planted against it must be caught.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .. import env
from ..telemetry.collectors import (
    M_FLEET_SLO_ATTAINMENT,
    M_KVCACHE_FREE,
    M_SCHED_BUDGET_UTIL,
    M_SCHED_QUEUE_DEPTH,
    M_TIER_FAULTS,
    record_fleet_autopilot_action,
    record_fleet_autopilot_hold,
)

HOLD_REASONS = (
    "steady", "cooldown", "hysteresis", "fault", "bounds", "reversal",
)


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Declarative SLO: tick-denominated latency bounds plus the
    fraction of finished requests that must meet BOTH (the attainment
    the autopilot regulates). Defaults come from the fleet env flags
    (``MAGI_ATTENTION_FLEET_SLO_TTFT`` / ``_TOKLAT``)."""

    ttft_p99_ticks: float = dataclasses.field(
        default_factory=env.fleet_slo_ttft_ticks
    )
    toklat_p99_ticks: float = dataclasses.field(
        default_factory=env.fleet_slo_toklat_ticks
    )
    attainment_target: float = 0.95

    def __post_init__(self):
        if self.ttft_p99_ticks <= 0 or self.toklat_p99_ticks <= 0:
            raise ValueError(
                f"SLO tick bounds must be positive: ttft="
                f"{self.ttft_p99_ticks}, toklat={self.toklat_p99_ticks}"
            )
        if not 0.0 < self.attainment_target <= 1.0:
            raise ValueError(
                f"attainment_target={self.attainment_target} must be "
                "in (0, 1]"
            )

    def met_by(self, ttft_ticks: float, toklat_ticks: float) -> bool:
        """One request's SLO verdict (the simulator's per-finish call)."""
        return (
            ttft_ticks <= self.ttft_p99_ticks
            and toklat_ticks <= self.toklat_p99_ticks
        )

    def to_json(self) -> dict:
        return {
            "ttft_p99_ticks": self.ttft_p99_ticks,
            "toklat_p99_ticks": self.toklat_p99_ticks,
            "attainment_target": self.attainment_target,
        }


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """Bounds + step size of one retunable knob. ``default`` is the
    value the scale-down path recovers toward when the fleet is
    comfortably inside SLO."""

    name: str
    lo: float
    hi: float
    step: float
    default: float
    integer: bool = True

    def __post_init__(self):
        if not self.lo <= self.default <= self.hi:
            raise ValueError(
                f"knob {self.name}: default {self.default} outside "
                f"[{self.lo}, {self.hi}]"
            )
        if self.step <= 0:
            raise ValueError(
                f"knob {self.name}: step {self.step} must be positive"
            )

    def clamp(self, v: float) -> float:
        v = min(max(v, self.lo), self.hi)
        return int(round(v)) if self.integer else v


def default_knob_specs(mode: str = "tiered") -> tuple[KnobSpec, ...]:
    """The stock knob catalog per scheduler kind. Budgets scale
    capacity directly; the admission watermark sheds load under page
    pressure. The catalog is ordered: the controller offers an action
    to the FIRST spec whose trigger fires."""
    if mode == "tiered":
        return (
            KnobSpec("decode_budget", lo=8, hi=512, step=16,
                     default=32),
            KnobSpec("prefill_budget", lo=16, hi=1024, step=32,
                     default=64),
            KnobSpec("admission_watermark", lo=0, hi=32, step=2,
                     default=0),
        )
    if mode == "single":
        return (
            KnobSpec("token_budget", lo=16, hi=1024, step=32,
                     default=64),
            KnobSpec("admission_watermark", lo=0, hi=32, step=2,
                     default=0),
        )
    raise ValueError(f"unknown scheduler mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class AutopilotDecision:
    """What one window evaluation decided: at most one action
    (``{knob: new_value}``), plus every hold with its reason — the
    controller's *inaction* is as observable as its actions."""

    window: int
    actions: dict
    holds: tuple[tuple[str, str], ...]  # (knob-or-"*", reason)
    facts: dict  # the window numbers the decision was made from

    @property
    def acted(self) -> bool:
        return bool(self.actions)


def _window_counter_total(window: dict, name: str) -> float:
    """Sum every labeled series of a counter in a snapshot_delta."""
    total = 0.0
    for key, v in (window.get("counters") or {}).items():
        if key == name or key.startswith(name + "{"):
            total += float(v)
    return total


class Autopilot:
    """The closed-loop controller. Drive it with
    :meth:`evaluate`(window, current=scheduler.knobs()) once per
    evaluation window; apply ``decision.actions`` through
    ``scheduler.apply_knobs``. Stateless apart from its own action
    history (cooldown / reversal bookkeeping)."""

    def __init__(
        self,
        slo: SLOTargets | None = None,
        *,
        knob_specs: Sequence[KnobSpec] | None = None,
        mode: str = "tiered",
        cooldown_windows: int | None = None,
        hysteresis: float = 0.02,
        util_high: float = 0.85,
        util_low: float = 0.5,
        free_low: float = 0.25,
    ):
        self.slo = slo if slo is not None else SLOTargets()
        self.specs = tuple(
            knob_specs if knob_specs is not None
            else default_knob_specs(mode)
        )
        self.cooldown_windows = (
            int(cooldown_windows) if cooldown_windows is not None
            else env.fleet_cooldown_windows()
        )
        if self.cooldown_windows < 1:
            raise ValueError(
                f"cooldown_windows={cooldown_windows} must be >= 1"
            )
        self.hysteresis = float(hysteresis)
        self.util_high = float(util_high)
        self.util_low = float(util_low)
        self.free_low = float(free_low)
        self._window = 0
        self._last_move: dict[str, int] = {}  # knob -> window index
        self._last_dir: dict[str, int] = {}  # knob -> +1 / -1
        self.history: list[AutopilotDecision] = []

    # -- the policy ------------------------------------------------------

    def _facts(self, window: dict) -> dict:
        g = window.get("gauges") or {}
        free_pages = g.get(M_KVCACHE_FREE)
        return {
            "attainment": float(
                g.get(M_FLEET_SLO_ATTAINMENT, 1.0)
            ),
            "budget_util": float(g.get(M_SCHED_BUDGET_UTIL, 0.0)),
            "queue_depth": float(g.get(M_SCHED_QUEUE_DEPTH, 0.0)),
            "free_pages": (
                float(free_pages) if free_pages is not None else None
            ),
            "tier_faults": _window_counter_total(window, M_TIER_FAULTS),
        }

    def _blocked(self, name: str, direction: int) -> str | None:
        """Why this knob may not move this window (None = free)."""
        last = self._last_move.get(name)
        if last is not None:
            if self._window - last < self.cooldown_windows:
                return "cooldown"
            if (
                self._last_dir.get(name, direction) != direction
                and self._window - last < 2 * self.cooldown_windows
            ):
                return "reversal"
        return None

    def _propose(self, facts: dict, current: dict) -> list[tuple[str, int]]:
        """Ordered (knob, direction) candidates for this window's
        numbers; empty = the fleet is steady."""
        target = self.slo.attainment_target
        att = facts["attainment"]
        under = att < target - self.hysteresis
        over = att > min(target + self.hysteresis, 1.0) or att >= 1.0
        out: list[tuple[str, int]] = []
        if under:
            saturated = (
                facts["budget_util"] >= self.util_high
                or facts["queue_depth"] > 0
            )
            pressured = (
                facts["free_pages"] is not None
                and facts["free_pages"] <= self._free_low_pages(current)
            )
            for spec in self.specs:
                if spec.name == "admission_watermark":
                    if pressured:
                        out.append((spec.name, +1))
                elif saturated:
                    out.append((spec.name, +1))
            if not out:
                # under SLO with no clear bottleneck signal: still
                # prefer more capacity on the first budget knob
                out.append((self.specs[0].name, +1))
        elif over and facts["budget_util"] <= self.util_low:
            # comfortable: relax toward defaults (cheapest config that
            # still meets SLO — the capacity planner's operating point)
            for spec in self.specs:
                cur = float(current.get(spec.name, spec.default))
                if cur > spec.default:
                    out.append((spec.name, -1))
                elif cur < spec.default:
                    out.append((spec.name, +1))
        return out

    def _free_low_pages(self, current: dict) -> float:
        # free-page pressure threshold in PAGES: free_low is a fraction
        # of the pool, but the controller only sees the free gauge — the
        # simulator passes pool size through current["__num_pages"]
        pool = float(current.get("__num_pages", 0.0) or 0.0)
        return self.free_low * pool

    def evaluate(self, window: dict, *, current: dict) -> AutopilotDecision:
        """Evaluate one snapshot_delta window against the SLO targets.

        ``current`` is ``scheduler.knobs()`` (plus the optional
        ``__num_pages`` hint); returns the decision — the caller
        applies ``decision.actions`` via ``apply_knobs``. Telemetry
        (action/hold counters, knob gauges) is recorded here.
        """
        facts = self._facts(window)
        holds: list[tuple[str, str]] = []
        actions: dict = {}

        if facts["tier_faults"] > 0:
            # never retune on fault-polluted numbers
            holds.append(("*", "fault"))
        else:
            proposals = self._propose(facts, current)
            if not proposals:
                att = facts["attainment"]
                target = self.slo.attainment_target
                reason = (
                    "steady"
                    if abs(att - target) <= self.hysteresis
                    or att >= target
                    else "hysteresis"
                )
                holds.append(("*", reason))
            for name, direction in proposals:
                if actions:
                    break  # one action per window
                spec = next(s for s in self.specs if s.name == name)
                why = self._blocked(name, direction)
                if why is not None:
                    holds.append((name, why))
                    continue
                cur = float(current.get(name, spec.default))
                new = spec.clamp(cur + direction * spec.step)
                if new == cur:
                    holds.append((name, "bounds"))
                    continue
                actions[name] = new
                self._last_move[name] = self._window
                self._last_dir[name] = direction
                record_fleet_autopilot_action(
                    name, "up" if direction > 0 else "down", new
                )
        for _knob, reason in holds:
            record_fleet_autopilot_hold(reason)
        decision = AutopilotDecision(
            window=self._window,
            actions=actions,
            holds=tuple(holds),
            facts=facts,
        )
        self.history.append(decision)
        self._window += 1
        return decision

    # -- introspection ---------------------------------------------------

    @property
    def actions_taken(self) -> list[tuple[int, str, float]]:
        """(window, knob, new_value) for every action in history."""
        return [
            (d.window, k, float(v))
            for d in self.history
            for k, v in d.actions.items()
        ]


def find_oscillations(
    actions: Sequence[tuple[int, str, float]],
    *,
    cooldown_windows: int,
) -> list[str]:
    """The anti-oscillation checker, run on a finished run's action log (``autopilot.actions_taken`` shape: (window, knob,
    new_value)). Violations:

    - a knob acted twice within one cooldown span (< cooldown_windows
      windows apart), or
    - a knob reversed direction within 2*cooldown_windows.

    Returns human-readable violations; [] = the contract held. A
    controller that alternates a knob up/down every window must be
    flagged.
    """
    cooldown = int(cooldown_windows)
    if cooldown < 1:
        raise ValueError(f"cooldown_windows={cooldown_windows} must be >= 1")
    errs: list[str] = []
    by_knob: dict[str, list[tuple[int, float]]] = {}
    for window, knob, value in sorted(actions):
        by_knob.setdefault(knob, []).append((int(window), float(value)))
    for knob, moves in by_knob.items():
        for (w0, v0), (w1, v1) in zip(moves, moves[1:]):
            gap = w1 - w0
            if gap < cooldown:
                errs.append(
                    f"knob {knob}: actions at windows {w0} and {w1} are "
                    f"{gap} windows apart (< cooldown {cooldown})"
                )
        # direction reversals need three points: v1-v0 vs v2-v1
        for (w0, v0), (w1, v1), (w2, v2) in zip(
            moves, moves[1:], moves[2:]
        ):
            d01 = math.copysign(1.0, v1 - v0) if v1 != v0 else 0.0
            d12 = math.copysign(1.0, v2 - v1) if v2 != v1 else 0.0
            if d01 and d12 and d01 != d12 and (w2 - w1) < 2 * cooldown:
                errs.append(
                    f"knob {knob}: direction reversal at window {w2} "
                    f"only {w2 - w1} windows after the move at {w1} "
                    f"(< {2 * cooldown})"
                )
    return errs
