"""Seeded, serializable fleet workload traces.

The JAX package's ``fleet/workload.py``: numpy only, so a trace's JSON is
byte-identical to the JAX package's for the same arguments.

A :class:`FleetTrace` is the unit of replay: a named, seeded list of
:class:`TraceRequest` arrivals on a logical tick timeline, with enough
shape (shared prefixes, long-tail output lengths) to exercise every
serving-stack path the fleet cares about — the prefix trie + CoW
sharing, chunked prefill, continuous-batching decode, admission
backpressure. Traces are plain JSON (``FLEET_TRACE_FORMAT``), so a
regression scenario is a checked-in artifact, not a code path.

Generators (:func:`generate_trace`):

- **poisson** — stationary Poisson arrivals at ``rate`` requests/tick:
  the baseline "healthy fleet" shape.
- **mmpp** — a 2-state Markov-modulated Poisson process: calm ticks at
  ``rate``, burst ticks at ``burst_rate``, with geometric dwell times
  (``burst_prob`` to enter, ``calm_prob`` to leave). The adversarial
  burst-arrival scenario the autopilot is held to.
- **diurnal** — a sinusoidal load curve (period ``diurnal_period``
  ticks, amplitude 0..1 of ``rate``): the capacity planner's
  peak-vs-trough shape.

Prefix sharing is zipf-distributed over a pool of ``prefix_pool``
distinct page-aligned system prompts: a heavy-head zipf (most users on
a handful of prompts) is exactly the regime cascade decode + trie
sharing win in, and the long tail still forces misses. Output lengths
are lognormal — most generations are short, a heavy tail runs 10x the
median (the requests that dominate decode-tier residency).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

FLEET_TRACE_FORMAT = "magi-fleet-trace/v1"

ARRIVAL_KINDS = ("poisson", "mmpp", "diurnal")


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival: the host-visible shape of a request (token ids +
    how many tokens it will generate), placed on the tick timeline."""

    rid: int
    arrival_tick: int
    prompt_tokens: tuple[int, ...]
    output_len: int
    priority: int = 0
    prefix_id: int = -1  # which shared prompt it drew (-1 = unshared)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    def to_json(self) -> dict:
        return {
            "rid": self.rid,
            "arrival_tick": self.arrival_tick,
            "prompt_tokens": list(self.prompt_tokens),
            "output_len": self.output_len,
            "priority": self.priority,
            "prefix_id": self.prefix_id,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TraceRequest":
        return cls(
            rid=int(d["rid"]),
            arrival_tick=int(d["arrival_tick"]),
            prompt_tokens=tuple(int(t) for t in d["prompt_tokens"]),
            output_len=int(d["output_len"]),
            priority=int(d.get("priority", 0)),
            prefix_id=int(d.get("prefix_id", -1)),
        )


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """A named, seeded arrival schedule — the simulator's replay unit.

    ``horizon_ticks`` is the arrival horizon only; the simulator keeps
    ticking past it until the backlog drains (or its own cap). ``meta``
    records the generator parameters so an artifact is self-describing
    and regenerable."""

    name: str
    seed: int
    horizon_ticks: int
    page_size: int
    requests: tuple[TraceRequest, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_requests(self) -> int:
        return len(self.requests)

    def arrivals_by_tick(self) -> dict[int, list[TraceRequest]]:
        out: dict[int, list[TraceRequest]] = {}
        for r in self.requests:
            out.setdefault(r.arrival_tick, []).append(r)
        return out

    def offered_per_tick(self) -> np.ndarray:
        """Arrival counts on [0, horizon_ticks) — the offered-load curve."""
        counts = np.zeros(self.horizon_ticks, np.int64)
        for r in self.requests:
            if 0 <= r.arrival_tick < self.horizon_ticks:
                counts[r.arrival_tick] += 1
        return counts

    def to_json(self) -> dict:
        return {
            "format": FLEET_TRACE_FORMAT,
            "name": self.name,
            "seed": self.seed,
            "horizon_ticks": self.horizon_ticks,
            "page_size": self.page_size,
            "meta": dict(self.meta),
            "requests": [r.to_json() for r in self.requests],
        }

    @classmethod
    def from_json(cls, d: dict) -> "FleetTrace":
        fmt = d.get("format")
        if fmt != FLEET_TRACE_FORMAT:
            raise ValueError(
                f"not a fleet trace: format {fmt!r} != "
                f"{FLEET_TRACE_FORMAT!r}"
            )
        return cls(
            name=str(d["name"]),
            seed=int(d["seed"]),
            horizon_ticks=int(d["horizon_ticks"]),
            page_size=int(d["page_size"]),
            requests=tuple(
                TraceRequest.from_json(r) for r in d["requests"]
            ),
            meta=dict(d.get("meta") or {}),
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "FleetTrace":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _zipf_choice(rng: np.random.Generator, n: int, alpha: float) -> int:
    """Bounded zipf over [0, n): rank r with weight (r+1)^-alpha."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-float(alpha))
    return int(rng.choice(n, p=w / w.sum()))


def _rate_curve(
    kind: str,
    rng: np.random.Generator,
    horizon: int,
    *,
    rate: float,
    burst_rate: float,
    burst_prob: float,
    calm_prob: float,
    diurnal_period: int,
    diurnal_amplitude: float,
) -> np.ndarray:
    """Per-tick Poisson intensity lambda(t) for each arrival kind."""
    if kind == "poisson":
        return np.full(horizon, float(rate))
    if kind == "mmpp":
        lam = np.empty(horizon)
        bursting = False
        for t in range(horizon):
            # geometric dwell in each state: the classic 2-state MMPP
            if bursting:
                if rng.random() < calm_prob:
                    bursting = False
            else:
                if rng.random() < burst_prob:
                    bursting = True
            lam[t] = float(burst_rate) if bursting else float(rate)
        return lam
    if kind == "diurnal":
        t = np.arange(horizon, dtype=np.float64)
        curve = 1.0 + float(diurnal_amplitude) * np.sin(
            2.0 * np.pi * t / max(int(diurnal_period), 1)
        )
        return np.maximum(float(rate) * curve, 0.0)
    raise ValueError(
        f"unknown arrival kind {kind!r}; one of {ARRIVAL_KINDS}"
    )


def generate_trace(
    name: str,
    *,
    seed: int,
    horizon_ticks: int,
    arrival: str = "poisson",
    rate: float = 1.0,
    burst_rate: float | None = None,
    burst_prob: float = 0.02,
    calm_prob: float = 0.2,
    diurnal_period: int = 128,
    diurnal_amplitude: float = 0.8,
    page_size: int = 8,
    prefix_pool: int = 8,
    prefix_pages: int = 1,
    zipf_alpha: float = 1.2,
    shared_fraction: float = 0.75,
    suffix_len_range: tuple[int, int] = (2, 12),
    output_len_median: float = 4.0,
    output_len_sigma: float = 0.6,
    output_len_max: int = 64,
    vocab: int = 4096,
    priority_levels: int = 1,
) -> FleetTrace:
    """Generate a seeded trace (deterministic for a given argument set).

    ``shared_fraction`` of requests draw a zipf-ranked shared prefix of
    ``prefix_pages`` full pages from a pool of ``prefix_pool`` distinct
    prompts (page-aligned so the trie registers whole pages and cascade
    groups form); the rest are unshared cold prompts. Output lengths
    are ``round(lognormal(median, sigma))`` clipped to
    ``[1, output_len_max]`` — the long tail.
    """
    if horizon_ticks < 1:
        raise ValueError(f"horizon_ticks={horizon_ticks} must be >= 1")
    if not 0.0 <= shared_fraction <= 1.0:
        raise ValueError(
            f"shared_fraction={shared_fraction} must be in [0, 1]"
        )
    rng = np.random.default_rng(seed)
    if burst_rate is None:
        burst_rate = 8.0 * rate
    lam = _rate_curve(
        arrival, rng, horizon_ticks,
        rate=rate, burst_rate=burst_rate, burst_prob=burst_prob,
        calm_prob=calm_prob, diurnal_period=diurnal_period,
        diurnal_amplitude=diurnal_amplitude,
    )
    # the shared-prompt pool: distinct page-aligned token prefixes
    prefix_len = int(prefix_pages) * int(page_size)
    prefixes = [
        tuple(
            int(t)
            for t in rng.integers(0, vocab, prefix_len)
        )
        for _ in range(int(prefix_pool))
    ]
    requests: list[TraceRequest] = []
    rid = 0
    lo, hi = suffix_len_range
    for tick in range(horizon_ticks):
        for _ in range(int(rng.poisson(lam[tick]))):
            if prefixes and rng.random() < shared_fraction:
                pid = _zipf_choice(rng, len(prefixes), zipf_alpha)
                head = prefixes[pid]
            else:
                pid = -1
                head = ()
            suffix_len = int(rng.integers(lo, hi + 1))
            suffix = tuple(
                int(t) for t in rng.integers(0, vocab, suffix_len)
            )
            out_len = int(
                np.clip(
                    round(
                        float(
                            rng.lognormal(
                                np.log(float(output_len_median)),
                                float(output_len_sigma),
                            )
                        )
                    ),
                    1,
                    int(output_len_max),
                )
            )
            requests.append(
                TraceRequest(
                    rid=rid,
                    arrival_tick=tick,
                    prompt_tokens=head + suffix,
                    output_len=out_len,
                    priority=int(rng.integers(0, max(priority_levels, 1))),
                    prefix_id=pid,
                )
            )
            rid += 1
    return FleetTrace(
        name=name,
        seed=int(seed),
        horizon_ticks=int(horizon_ticks),
        page_size=int(page_size),
        requests=tuple(requests),
        meta={
            "arrival": arrival,
            "rate": float(rate),
            "burst_rate": float(burst_rate),
            "burst_prob": float(burst_prob),
            "calm_prob": float(calm_prob),
            "diurnal_period": int(diurnal_period),
            "diurnal_amplitude": float(diurnal_amplitude),
            "prefix_pool": int(prefix_pool),
            "prefix_pages": int(prefix_pages),
            "zipf_alpha": float(zipf_alpha),
            "shared_fraction": float(shared_fraction),
            "suffix_len_range": list(suffix_len_range),
            "output_len_median": float(output_len_median),
            "output_len_sigma": float(output_len_sigma),
            "output_len_max": int(output_len_max),
            "vocab": int(vocab),
            "priority_levels": int(priority_levels),
            "num_requests": len(requests),
        },
    )


def scale_rate(trace_kwargs: dict, rate: float) -> dict:
    """A copy of generator kwargs with the base rate replaced (burst
    rate rescaled proportionally when it was explicit) — the capacity
    planner's load dial."""
    out = dict(trace_kwargs)
    old = float(out.get("rate", 1.0))
    out["rate"] = float(rate)
    if out.get("burst_rate") is not None and old > 0:
        out["burst_rate"] = float(out["burst_rate"]) * (rate / old)
    return out


def validate_trace(trace: FleetTrace) -> list[str]:
    """Structural lint of a trace artifact (run it on a scenario before
    replay): returns human-readable problems, [] when clean."""
    errs: list[str] = []
    seen: set[int] = set()
    for r in trace.requests:
        if r.rid in seen:
            errs.append(f"duplicate rid {r.rid}")
        seen.add(r.rid)
        if not 0 <= r.arrival_tick < trace.horizon_ticks:
            errs.append(
                f"rid {r.rid}: arrival_tick {r.arrival_tick} outside "
                f"[0, {trace.horizon_ticks})"
            )
        if r.output_len < 1:
            errs.append(f"rid {r.rid}: output_len {r.output_len} < 1")
        if r.prompt_len < 1:
            errs.append(f"rid {r.rid}: empty prompt")
        if r.prefix_id >= 0 and r.prompt_len <= trace.page_size:
            errs.append(
                f"rid {r.rid}: claims shared prefix {r.prefix_id} but "
                f"prompt ({r.prompt_len} tokens) does not extend past "
                f"one page ({trace.page_size})"
            )
    return errs
