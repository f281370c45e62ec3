"""The ``MAGI_ATTENTION_CHAOS`` grammar, as the JAX package's
``resilience/chaos.py`` parses it: one clause per injector,
``kind:key=value,...``, clauses joined by ``;``. Same kinds, parameters,
domains and messages, so a spec the reference refuses is refused here with
the same ``ValueError``."""

from __future__ import annotations

import dataclasses

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
