"""Request-shape plan resolution riding the scheduler tick.

The counterpart of the JAX package's ``serving/plan_probe.py``: the real
request shapes of a :class:`~.scheduler.Scheduler`'s ticks go through the
keyed planner (``api.magi_attn_flex_key`` / ``magi_attn_varlen_key``), so
that the plan cache's hit rate is read on serving traffic.

Shape policy (as JAX's):

- **Prefill**: a chunk ``[lo, hi)`` of a prompt attends causally over
  ``[0, hi)``: a flex key with ``q=[lo, hi)``, ``k=[0, hi)``, CAUSAL,
  ``total=hi``.
- **Decode**: the tick's batch as one packed varlen-causal mask, each
  context capped at ``decode_window`` and sorted longest first, the batch
  padded up to a power of two with window-length dummies, so that batch
  sizes within one octave resolve the same key.

The probe plans on the CPU over a one-rank group and never touches the
engine's device state or the scheduler's launch census. With no process
group initialised it makes the default group itself, one gloo rank over a
``HashStore``; otherwise the caller passes ``cp_group`` (a one-rank group
is what the JAX package's private one-device mesh is).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PlanProbeStats", "PlanReuseProbe"]


@dataclasses.dataclass
class PlanProbeStats:
    """What the probe resolved."""

    prefill_resolutions: int = 0
    decode_resolutions: int = 0
    ticks: int = 0

    @property
    def total_resolutions(self) -> int:
        return self.prefill_resolutions + self.decode_resolutions


class PlanReuseProbe:
    """Resolve real runtime keys for each scheduler tick's shapes: attach as
    ``Scheduler(engine, plan_probe=PlanReuseProbe())``. ``chunk_size`` is
    the keys' dispatch chunk, a multiple of the kernels' 64-row tile (the
    JAX package's default of 16 is a multiple of its TPU tile)."""

    def __init__(
        self,
        *,
        decode_window: int = 32,
        chunk_size: int = 64,
        num_heads: tuple[int, int] = (2, 2),
        head_dim: int = 32,
        cp_group=None,
    ):
        if decode_window < 1:
            raise ValueError(f"decode_window={decode_window} must be >= 1")
        self.decode_window = int(decode_window)
        self.chunk_size = int(chunk_size)
        self.num_heads = tuple(num_heads)
        self.head_dim = int(head_dim)
        self.stats = PlanProbeStats()
        self._group = cp_group

    def _cp_group(self):
        """The caller's group, else the default group, made here as one gloo
        rank when none is initialised."""
        if self._group is None:
            import torch.distributed as dist

            if not dist.is_initialized():
                dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
            elif dist.get_world_size() != 1:
                raise ValueError(
                    "PlanReuseProbe: the default process group has "
                    f"{dist.get_world_size()} ranks; pass cp_group= (the probe plans over one "
                    "rank, as the JAX package's private one-device mesh)")
            self._group = dist.group.WORLD
        return self._group

    def _flex_kwargs(self) -> dict:
        return dict(num_heads=self.num_heads, head_dim=self.head_dim,
                    chunk_size=self.chunk_size, out_dtype=torch.float32, device="cpu")

    # -- scheduler hooks --

    def note_prefill(self, rid: int, lo: int, hi: int) -> None:
        """A prefill chunk ``[lo, hi)`` of request ``rid`` ran this tick."""
        if hi <= lo:
            return
        from ..api.interface import magi_attn_flex_key

        magi_attn_flex_key([(lo, hi)], [(0, hi)], "causal", hi, hi, self._cp_group(),
                           **self._flex_kwargs())
        self.stats.prefill_resolutions += 1

    def note_decode(self, states) -> None:
        """A batched decode step over ``states`` ran this tick; each
        context is the prompt plus the tokens decoded so far and this one,
        capped at the window."""
        if not states:
            return
        from ..api.interface import magi_attn_varlen_key

        contexts = sorted((min(st.request.prompt_len + st.tokens_done + 1, self.decode_window)
                           for st in states), reverse=True)
        target = 1 << (len(contexts) - 1).bit_length()
        contexts = [self.decode_window] * (target - len(contexts)) + contexts
        cu = np.cumsum([0] + contexts)
        magi_attn_varlen_key([int(v) for v in cu], int(cu[-1]), self._cp_group(), causal=True,
                             **self._flex_kwargs())
        self.stats.decode_resolutions += 1

    def on_step_end(self, report) -> None:
        """End-of-tick hook: counts the tick."""
        self.stats.ticks += 1
