"""Deterministic, seedable fault injection (``MAGI_ATTENTION_CHAOS``).

The JAX package's ``resilience/chaos.py`` on torch tensors. Every failure
mode the runtime claims to survive is injectable here, addressed by site
(guard site, rank, hop), so a chaos run is reproducible bit for bit. Off by
default: with the flag unset every hook is one host-side predicate and no
tensor op runs. The spec is validated by ``env.chaos_spec()`` and folded
into ``flags_fingerprint``.

Grammar: one clause per injector, ``kind:key=value,...``, clauses joined by
``;``. Same kinds, parameters, domains and messages as the JAX package's,
so a spec the reference refuses is refused here with the same
``ValueError``.

- Exception injectors (:func:`maybe_fail`): ``alloc_fail`` and
  ``pool_exhaust`` (``serving/kv_cache.py``), ``prefill_error``
  (``serving/engine.py``), ``decode_fault`` (``serving/distributed.py``),
  ``plan_error`` (``parallel/dist_attn.py``), ``hops_build_error``
  (``comm/group_collective.py``). Each fires at most ``times`` times per
  process (default 1, 0 = every time); :func:`reset_chaos` rearms them.
  ``cache_io_error`` parses and raises the OSError flavour, but has no site
  in the port until its tuning cache is ported.
- Value injectors, out of place (``clone`` and index assignment), on every
  matching call: :func:`corrupt_partial` on a kernel partial (out, lse) at
  a guard site, :func:`corrupt_cast_payload` on a cast's received rows,
  :func:`corrupt_reduce_payload` on a reduce's partial rows, and
  :func:`straggler_delay` on a hop of a hop-scheduled cast. The JAX
  package gates a clause's ``rank=`` on the traced axis index; here the
  caller passes its rank in the flat cp group (``rank=None``: every rank,
  as the JAX package does for a hierarchical plan).
"""

from __future__ import annotations

import dataclasses


class ChaosInjectedError(RuntimeError):
    """An injected (not organic) failure, raised by an exception injector."""


class ChaosInjectedIOError(ChaosInjectedError, OSError):
    """An injected disk fault: an ``OSError`` too, so that it takes the
    path a real disk fault would."""


_VALUES = ("nan", "inf")
_FIELDS = ("out", "lse", "both")
_OPS = ("load", "store")

# kind -> the parameters it takes
_KINDS: dict[str, set[str]] = {
    "corrupt_partial": {"site", "field", "value", "rank", "seed"},
    "corrupt_cast": {"value", "rank", "seed"},
    "permute_cast": {"rank"},
    "corrupt_reduce": {"value", "rank", "seed"},
    "straggler": {"hop", "delay"},
    "pool_exhaust": set(),
    "alloc_fail": {"times"},
    "prefill_error": {"times"},
    "decode_fault": {"times"},
    "plan_error": {"times"},
    "hops_build_error": {"times"},
    "cache_io_error": {"op", "times"},
}
_INT_PARAMS = {"rank", "seed", "hop", "delay", "times"}


@dataclasses.dataclass(frozen=True)
class ChaosClause:
    """One parsed injector clause."""

    kind: str
    site: str | None = None  # guard-site name for corrupt_partial
    field: str = "both"  # out | lse | both
    value: str = "nan"  # nan | inf | finite:<scale>
    rank: int = -1  # -1 = every rank
    seed: int = 0
    hop: int = 1  # straggler hop shift
    delay: int = 32  # straggler loop iterations
    op: str = "load"  # cache_io_error: load | store
    times: int = 1  # exception injectors: max fires (0 = unlimited)

    @property
    def fill(self) -> float:
        """The planted value: nan, inf, or the literal scale of
        ``finite:<scale>`` (validated positive and finite at parse time)."""
        if self.value == "nan":
            return float("nan")
        if self.value == "inf":
            return float("inf")
        return float(self.value.partition(":")[2])


def _params(kind: str, raw: str, rest: str) -> dict:
    params: dict = {}
    for item in rest.split(","):
        key, eq, value = item.partition("=")
        key, value = key.strip(), value.strip()
        if not eq or not key or not value:
            raise ValueError(f"MAGI_ATTENTION_CHAOS: malformed param {item!r} in clause {raw!r} "
                             "(want key=value)")
        if key not in _KINDS[kind]:
            raise ValueError(f"MAGI_ATTENTION_CHAOS: {kind} takes {sorted(_KINDS[kind])}, "
                             f"not {key!r}")
        if key in _INT_PARAMS:
            try:
                params[key] = int(value)
            except ValueError:
                raise ValueError(f"MAGI_ATTENTION_CHAOS: {key}={value!r} must be an "
                                 "integer") from None
        else:
            params[key] = value
    return params


def _check_value(value: str) -> None:
    if value in _VALUES:
        return
    head, sep, scale = value.partition(":")
    if head != "finite" or not sep:
        raise ValueError(f"MAGI_ATTENTION_CHAOS: value={value!r} must be one of {_VALUES} or "
                         "finite:<scale>")
    try:
        scale_f = float(scale)
    except ValueError:
        raise ValueError(f"MAGI_ATTENTION_CHAOS: finite scale {scale!r} must be a number "
                         "(e.g. value=finite:8.0)") from None
    if not scale_f > 0 or scale_f == float("inf"):
        raise ValueError(f"MAGI_ATTENTION_CHAOS: finite scale {scale!r} must be a positive "
                         "finite number (a non-positive or non-finite plant would be inert or "
                         "trip the nan/inf guards instead of the shadow sentinel)")


def parse_chaos_spec(spec: str) -> tuple[ChaosClause, ...]:
    """Parse and validate a chaos spec; ``ValueError`` on bad grammar,
    unknown kinds or parameters, or values out of their domain."""
    clauses: list[ChaosClause] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, _, rest = raw.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(f"MAGI_ATTENTION_CHAOS: unknown injector {kind!r} "
                             f"(known: {sorted(_KINDS)})")
        clause = ChaosClause(kind=kind, **(_params(kind, raw, rest) if rest.strip() else {}))
        if kind == "corrupt_partial" and clause.site is None:
            raise ValueError("MAGI_ATTENTION_CHAOS: corrupt_partial requires site= "
                             "(host | merged | stageN | splitN) — a site-less clause matches "
                             "no guard site and would be silently inert")
        _check_value(clause.value)
        if clause.field not in _FIELDS:
            raise ValueError(f"MAGI_ATTENTION_CHAOS: field={clause.field!r} must be one of "
                             f"{_FIELDS}")
        if clause.op not in _OPS:
            raise ValueError(f"MAGI_ATTENTION_CHAOS: op={clause.op!r} must be one of {_OPS}")
        if clause.delay < 1 or clause.times < 0 or clause.hop < 0:
            raise ValueError(f"MAGI_ATTENTION_CHAOS: bad numeric range in {raw!r}")
        clauses.append(clause)
    return tuple(clauses)


# the parsed spec, keyed on the raw string (tests flip the flag per case),
# and the exception injectors' fire counts
_parsed: tuple[str, tuple[ChaosClause, ...]] = ("", ())
_fire_counts: dict[tuple[str, int], int] = {}

# a straggler's device spin per iteration of its ``delay``, in clock cycles
# (torch.cuda._sleep): about 55 us at the H100's 1.8 GHz
STRAGGLER_CYCLES_PER_ITER = 100_000


def get_chaos() -> tuple[ChaosClause, ...]:
    """The active injector clauses (empty when chaos is off)."""
    global _parsed
    from .. import env

    spec = env.chaos_spec()
    if spec != _parsed[0]:
        _parsed = (spec, parse_chaos_spec(spec))
    return _parsed[1]


def enabled() -> bool:
    return bool(get_chaos())


def reset_chaos() -> None:
    """Rearm the exception injectors."""
    _fire_counts.clear()


def _matching(kind: str, **want) -> list[tuple[int, ChaosClause]]:
    return [(i, cl) for i, cl in enumerate(get_chaos())
            if cl.kind == kind and all(getattr(cl, k) == v for k, v in want.items())]


def _should_fire(index: int, cl: ChaosClause) -> bool:
    """Consume one fire of a bounded exception injector."""
    if cl.times == 0:
        return True
    key = (_parsed[0], index)
    fired = _fire_counts.get(key, 0)
    if fired >= cl.times:
        return False
    _fire_counts[key] = fired + 1
    return True


# -- exception injectors (host) ---------------------------------------------------


def maybe_fail(kind: str, **want) -> None:
    """Raise :class:`ChaosInjectedError` when a matching exception injector
    is armed (``cache_io_error`` raises the OSError flavour)."""
    for i, cl in _matching(kind, **want):
        if _should_fire(i, cl):
            exc = ChaosInjectedIOError if kind == "cache_io_error" else ChaosInjectedError
            raise exc(f"chaos: injected {kind} ({_parsed[0]!r})")


def pool_exhausted() -> bool:
    """Is the page pool chaos-exhausted? (``PageAllocator`` asks in
    ``can_admit`` / ``allocate`` / ``can_fork`` / ``fork`` / ``extend``.)"""
    return bool(_matching("pool_exhaust"))


# -- value injectors (tensors, out of place; positions from the seed) ---------------


def _targets(cl: ChaosClause, rank: int | None) -> bool:
    """Whether a clause's ``rank=`` selects this caller: rank < 0 in the
    clause, or no rank given, means every rank."""
    return cl.rank < 0 or rank is None or rank == cl.rank


def corrupt_partial(out, lse, site: str, *, rank: int | None = None):
    """Plant the clause's value into a kernel partial at guard site
    ``site``: ``out`` [..., t, h, d] at (r0, h0, 0), ``lse`` [..., t, h] at
    (r0, h0), with r0 = seed % t and h0 = (seed // 7) % h, so a re-run
    plants the same fault. Returns new tensors (the inputs are not
    written)."""
    for _, cl in _matching("corrupt_partial", site=site):
        if not _targets(cl, rank):
            continue
        t, h = lse.shape[-2], lse.shape[-1]
        r0, h0 = cl.seed % t, (cl.seed // 7) % h
        if cl.field in ("out", "both"):
            out = out.clone()
            out[..., r0, h0, 0] = cl.fill
        if cl.field in ("lse", "both"):
            lse = lse.clone()
            lse[..., r0, h0] = cl.fill
    return out, lse


def corrupt_cast_payload(x, *, rank: int | None = None):
    """Apply the ``corrupt_cast`` clauses (row seed % R set to the value) and
    the ``permute_cast`` clauses (rows reversed) to a cast's received rows
    ``x`` [R, ...]."""
    for _, cl in _matching("corrupt_cast"):
        if _targets(cl, rank):
            x = x.clone()
            x[cl.seed % x.shape[0]] = cl.fill
    for _, cl in _matching("permute_cast"):
        if _targets(cl, rank):
            x = x.flip(0)
    return x


def corrupt_reduce_payload(x, *, rank: int | None = None):
    """Apply the ``corrupt_reduce`` clauses (row seed % R set to the value)
    to a partial row buffer fed to a group reduce (an out or lse payload)."""
    for _, cl in _matching("corrupt_reduce"):
        if _targets(cl, rank):
            x = x.clone()
            x[cl.seed % x.shape[0]] = cl.fill
    return x


def straggler_delay(x, hop_shift: int):
    """The ``straggler`` clauses of hop ``hop_shift``: hold this hop's
    received rows back by ``delay`` iterations, leaving them bit for bit as
    they were. On a CUDA tensor each iteration spins the current stream for
    :data:`STRAGGLER_CYCLES_PER_ITER` clock cycles (``torch.cuda._sleep``),
    so the work after the hop waits on the device; on the CPU each is one
    identity copy."""
    clauses = _matching("straggler", hop=hop_shift)
    if not clauses:
        return x
    delay = max(cl.delay for _, cl in clauses)
    if x.is_cuda:
        import torch

        with torch.cuda.device(x.device):
            torch.cuda._sleep(delay * STRAGGLER_CYCLES_PER_ITER)
        return x
    for _ in range(delay):
        x = x.clone()
    return x
