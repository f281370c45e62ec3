"""DistAttnConfig: the dispatch and overlap configuration of a keyed
distributed-attention runtime (the JAX package's ``config.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta.solver.dispatch_solver import DispatchConfig
from .meta.solver.overlap_solver import OverlapConfig


@dataclass(frozen=True)
class DistAttnConfig:
    dispatch_config: DispatchConfig = field(default_factory=DispatchConfig)
    overlap_config: OverlapConfig = field(default_factory=OverlapConfig)
