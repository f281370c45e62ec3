"""FlagCombGenerator: iterate legal combinations of the port's flags.

The counterpart of the JAX package's ``testing/flag_generator.py``: a
constrained cartesian product over flag values with sequential, random and
heuristic (one value changed at a time) modes. :data:`PORT_FLAG_SPACE`
names the port's behaviour flags and their values, and :func:`is_legal`
refuses the combinations that ``api.check_flag_comb`` refuses for a flat cp
group (hierarchical comm needs a ``HierCpGroups``)."""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Iterator, Mapping, Sequence

# the port's behaviour flags (``env.py``), defaults first
PORT_FLAG_SPACE: dict[str, tuple[str, ...]] = {
    "MAGI_ATTENTION_KERNEL_BACKEND": ("cuda", "torch", "torch_online"),
    "MAGI_ATTENTION_GROUP_COLL_IMPL": ("auto", "a2a", "hops"),
    "MAGI_ATTENTION_QO_COMM": ("0", "1"),
    "MAGI_ATTENTION_HIERARCHICAL_COMM": ("0", "1"),
    "MAGI_ATTENTION_AUTO_RANGE_MERGE": ("0", "1"),
    "MAGI_ATTENTION_PLAN_REUSE": ("off", "bucket"),
    "MAGI_ATTENTION_CPP_BACKEND": ("1", "0"),
}


def is_legal(combo: Mapping[str, str]) -> bool:
    """False for what ``api.check_flag_comb`` refuses on a flat cp group."""
    return combo.get("MAGI_ATTENTION_HIERARCHICAL_COMM", "0") != "1"


class FlagCombGenerator:
    """Iterate dicts over a cartesian flag space, skipping illegal ones.

    ``mode``: 'sequential' (the full product), 'random' (``num_samples``
    distinct draws from ``seed``), or 'heuristic' (the first value of every
    flag, then each other value of each flag alone: every value once, linear
    in the space's size)."""

    def __init__(self, space: Mapping[str, Sequence[Any]] | None = None,
                 is_legal: Callable[[dict], bool] | None = None, mode: str = "heuristic",
                 num_samples: int = 16, seed: int = 0):
        if mode not in ("sequential", "random", "heuristic"):
            raise ValueError(f"unknown mode {mode!r}")
        self.space = dict(PORT_FLAG_SPACE if space is None else space)
        self.is_legal = is_legal or (lambda c: True)
        self.mode = mode
        self.num_samples = num_samples
        self.seed = seed

    def __iter__(self) -> Iterator[dict]:
        keys = list(self.space)
        if self.mode == "sequential":
            for vals in itertools.product(*(self.space[k] for k in keys)):
                combo = dict(zip(keys, vals))
                if self.is_legal(combo):
                    yield combo
        elif self.mode == "random":
            rng = random.Random(self.seed)
            seen = set()
            trials = 0
            while len(seen) < self.num_samples and trials < 100 * self.num_samples:
                trials += 1
                combo = {k: rng.choice(list(self.space[k])) for k in keys}
                key = tuple(combo[k] for k in keys)
                if key in seen or not self.is_legal(combo):
                    continue
                seen.add(key)
                yield combo
        else:
            base = {k: self.space[k][0] for k in keys}
            if self.is_legal(base):
                yield dict(base)
            for k in keys:
                for v in self.space[k][1:]:
                    combo = dict(base)
                    combo[k] = v
                    if self.is_legal(combo):
                        yield combo
