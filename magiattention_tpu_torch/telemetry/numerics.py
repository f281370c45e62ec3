"""Numerics oracle: error budgets, divergence reports and the host census.

The port's copy of the host-side part of the JAX package's
``telemetry/numerics.py``. :func:`divergence_report` scores a test array
against a reference per position: absolute, relative and ulp error (the
bit-pattern distance in the test dtype's own grid), with out-vs-lse
attribution when both components are given. The arrays are numpy arrays or
torch tensors (a tensor is read on the host; bfloat16, which numpy lacks,
is scored on its own bit patterns). :class:`ErrorBudget` is the composable
policy (per-dtype defaults in :data:`DEFAULT_BUDGETS`; ``&`` = the
strictest of two budgets, ``|`` = the loosest), and
:func:`assert_within_budget` is the gate the parity tests share.

:class:`NumericsCensus` is the host state every flight-recorder dump embeds
as its ``numerics`` section: the serving engine's shadow checks
(``MAGI_ATTENTION_SHADOW_SAMPLE_RATE``) land there, and so does the value
census of ``MAGI_ATTENTION_NUMERICS=census``: each guard site's partial
reduced to a few values on the device (:func:`site_summary`), the merge's
softmax-mass deviation (:func:`mass_deviation`), packed into one vector
(:func:`pack_census`) and read to the host once a call
(:func:`consume_census`). The port has no jit boundary: the values are
consumed where ``DistAttnRuntimeMgr.calc_attn`` and the decode entry points
return. Off, none of it runs.
"""

from __future__ import annotations

import dataclasses
import threading

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


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch")


def _grid(x, like=None) -> tuple[np.ndarray, np.ndarray, str]:
    """``x`` (numpy or torch) on ``like``'s dtype grid (its own by default):
    its values as float64 and its bit patterns as ordered int64, on the
    host, and the grid's dtype name. A tensor is read through its integer
    view, so bfloat16 needs no numpy dtype."""
    if like is not None and not _is_tensor(like):
        like = np.asarray(like)
        if _is_tensor(x):  # onto a numpy grid; numpy has no bfloat16
            import torch

            x = x.detach().cpu()
            x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        a = np.asarray(x).astype(like.dtype)
        return a.astype(np.float64), _ordered_ints(a), str(a.dtype)
    if like is not None and not _is_tensor(x):
        import torch

        x = torch.from_numpy(np.asarray(x))
    if not _is_tensor(x):
        a = np.asarray(x)
        return a.astype(np.float64), _ordered_ints(a), str(a.dtype)
    import torch

    t = x.detach() if like is None else x.detach().to(like.dtype)
    ints = t.view(getattr(torch, f"int{t.element_size() * 8}")).cpu().numpy()
    i = ints.astype(np.int64)
    ordered = np.where(i >= 0, i, np.iinfo(ints.dtype).min - i)
    return t.double().cpu().numpy(), ordered, str(t.dtype).removeprefix("torch.")


def ulp_distance(ref, test) -> np.ndarray:
    """Per-position ulp distance between ``ref`` and ``test`` in
    ``test``'s dtype grid (``ref`` is rounded onto it first: the honest
    comparison of a low-precision path with an f32 oracle). Agreeing NaNs
    count 0; any other non-finite disagreement shows as the huge
    bit-pattern distance it is."""
    t64, t_ord, _ = _grid(test)
    r64, r_ord, _ = _grid(ref, like=test)
    d = np.abs(t_ord - r_ord)
    return np.where(np.isnan(t64) & np.isnan(r64), 0, d)


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
    t64, _, dtype = _grid(test)
    r64, _, _ = _grid(ref)
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
        rl = _grid(ref_lse)[0]
        tl = _grid(test_lse)[0]
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
        dtype=dtype,
        shape=tuple(int(s) for s in t64.shape),
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


# ---------------------------------------------------------------------------
# the value census (device reductions, read once a call)
# ---------------------------------------------------------------------------

# per-site values, in packed order; "final/mass_dev" closes each call
CENSUS_STATS = ("logit_max", "lse_min", "lse_max", "out_max_abs")
MASS_DEV_KEY = "final/mass_dev"


def census_active() -> bool:
    """Whether ``MAGI_ATTENTION_NUMERICS=census``: off (the default), no
    emitter below runs and the outputs are unchanged."""
    from .. import env

    return env.numerics_mode() == "census"


def site_summary(out, lse, logits_max=None) -> list:
    """One (out, lse) partial reduced to f32 scalars on its device, in
    ``CENSUS_STATS`` order. ``logits_max``: the kernel's max logits where
    the caller has them, else max lse stands in (max logit <= lse <= max
    logit + log n). Uncovered rows (lse -inf) are masked by equality; no
    ``isfinite``, which stays the guards' marker."""
    import torch

    lse32 = lse.float()
    logit_max = (logits_max.float() if logits_max is not None else lse32).amax()
    lse_min = torch.where(torch.isneginf(lse32), torch.full_like(lse32, float("inf")),
                          lse32).amin()
    return [logit_max, lse_min, lse32.amax(), out.float().abs().amax()]


def mass_deviation(partial_lses, merged_lse):
    """The softmax-mass deviation of an LSE merge: the partial masses
    sum_i exp(lse_i - lse_merged) make exactly 1 in exact arithmetic, so
    the largest deviation over positions measures the merge's rounding (and
    explodes on a corrupted finite partial). Uncovered rows count 0."""
    import torch

    merged = merged_lse.float()
    uncovered = torch.isneginf(merged)
    safe = torch.where(uncovered, torch.zeros_like(merged), merged)
    mass = None
    for l_i in partial_lses:
        l32 = l_i.float()
        term = torch.where(torch.isneginf(l32), torch.zeros_like(l32), torch.exp(l32 - safe))
        mass = term if mass is None else mass + term
    dev = torch.where(uncovered, torch.zeros_like(mass), (mass - 1.0).abs())
    return dev.amax()


def census_keys(sites) -> tuple[str, ...]:
    """The packed order for a call's guard-site names, shared by the
    emitter and :func:`consume_census`."""
    keys = [f"{s}/{stat}" for s in sites for stat in CENSUS_STATS]
    keys.append(MASS_DEV_KEY)
    return tuple(keys)


def pack_census(values):
    """The emitted scalars as one f32 vector on their device."""
    import torch

    return torch.stack([v.float().reshape(()) for v in values])


def consume_census(values, keys, *, layer: str) -> None:
    """Land a packed census (``[S]``, or ``[R, S]`` over ranks) in the
    ``magi_numerics_*`` series and the host :class:`NumericsCensus`: one
    device-to-host copy. Over ranks, a minimum stays a minimum and every
    other value takes the worst (largest) rank, as in the JAX package."""
    if values is None:
        return
    if not isinstance(values, np.ndarray):
        values = values.detach().cpu().numpy()
    arr = np.asarray(values, np.float64).reshape(-1, len(keys))
    site_stats: dict[str, dict[str, float]] = {}
    for j, key in enumerate(keys):
        site, _, stat = key.rpartition("/")
        col = arr[:, j]
        val = float(np.min(col) if stat == "lse_min" else np.max(col))
        site_stats.setdefault(site, {})[stat] = val
    from . import collectors

    for site, stats in site_stats.items():
        collectors.record_numerics_census(layer, site, stats)
    get_numerics_census().note_sites(layer, site_stats)


# ---------------------------------------------------------------------------
# host-side census state (the flight dump's `numerics` section)
# ---------------------------------------------------------------------------


class NumericsCensus:
    """Last-consumed census per (layer, site) + a bounded ring of
    shadow-check scores — the host state every flight dump embeds as its
    ``numerics`` section (registered with the flight recorder as a weakly
    held source). Independent of the telemetry flag, like the flight
    recorder itself."""

    SHADOW_RING = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: dict[str, dict[str, dict[str, float]]] = {}
        self._shadow: list[dict] = []
        self._shadow_checks = 0
        self._shadow_breaches = 0

    def note_sites(self, layer: str, site_stats: dict[str, dict[str, float]]) -> None:
        with self._lock:
            self._sites.setdefault(layer, {}).update(
                {s: dict(v) for s, v in site_stats.items()})

    def note_shadow(self, record: dict, *, breached: bool) -> None:
        with self._lock:
            self._shadow_checks += 1
            if breached:
                self._shadow_breaches += 1
            self._shadow.append(dict(record))
            if len(self._shadow) > self.SHADOW_RING:
                del self._shadow[: len(self._shadow) - self.SHADOW_RING]

    def numerics_snapshot(self) -> dict:
        """JSON-safe snapshot (the flight recorder's source contract)."""
        with self._lock:
            return {
                "census": {layer: {s: dict(v) for s, v in sites.items()}
                           for layer, sites in self._sites.items()},
                "shadow": [dict(r) for r in self._shadow],
                "shadow_checks": self._shadow_checks,
                "shadow_breaches": self._shadow_breaches,
            }


_census: NumericsCensus | None = None
_census_lock = threading.Lock()
# the flight recorder the census last registered with: a
# reset_flight_recorder() swaps the global recorder, so registration
# re-arms lazily on the next note (and eagerly at engine construction)
_registered_with = None


def get_numerics_census() -> NumericsCensus:
    """The process-global census (made on first use; registered as a
    flight-recorder ``numerics`` source so dumps carry it)."""
    global _census
    if _census is None:
        with _census_lock:
            if _census is None:
                _census = NumericsCensus()
    ensure_flight_registration()
    return _census


def ensure_flight_registration() -> None:
    """(Re-)attach the census to the CURRENT flight recorder — called
    lazily by :func:`get_numerics_census` and eagerly by the serving
    engine, so a ``reset_flight_recorder()`` never silently drops the
    ``numerics`` section from later dumps."""
    global _registered_with
    if _census is None:
        return
    from .trace import get_flight_recorder

    fr = get_flight_recorder()
    with _census_lock:
        if _registered_with is fr:
            return
        _registered_with = fr
    fr.register_numerics_source("census", _census)


def reset_numerics_census() -> NumericsCensus:
    """A fresh census (tests); registered with the current recorder."""
    global _census, _registered_with
    with _census_lock:
        _census = NumericsCensus()
        _registered_with = None
    return get_numerics_census()
