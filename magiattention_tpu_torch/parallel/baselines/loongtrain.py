"""LoongTrain-style double-ring context-parallel attention baseline.

The counterpart of the JAX package's ``parallel/baselines/loongtrain.py``
(reference ``exps/dist_attn/baselines/loongtrain.py``, 2D-Attention): the
sequence ring is factored into (outer x inner) rings. Inner rotations ride
the fast links while the K/V block crosses the slow level only once per
inner cycle. The per-(rank, step) tables are the plain ring's scheme; only
the rotation schedule differs:

    step s = so * r_in + si visits src rank (o - so, i - si + so) (mod each),
    every step but a cycle's first rotates the inner ring, and every cycle
    but the first starts with one outer rotation.

The rings are a ``comm.HierCpGroups`` (``comm.make_hier_cp_groups(group,
outer, inner)``): its inter level is the outer ring, its intra level the
inner one, so rank ``r = o * inner + i`` holds token block r, as JAX's
``P((ring_out, ring_in))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...comm.group_collective import group_rank
from ...comm.primitives import ring_shift
from ...utils.instrument import named_scope
from ...ops.block_meta import Run, build_block_meta_general
from ...ops.correction import correct_attn_out_lse
from ...ops.flex_attn import FlexAttnParams, flex_attn_headmajor
from ..dist_attn import StageTables, _hm, _kv_buffer, _round_up, _seq
from .ring import _check_params, _tile, step_tables


@dataclasses.dataclass(frozen=True, eq=False)
class DoubleRingPlan:
    ring_outer: int
    ring_inner: int
    shard_len: int
    shard_q_pad: int
    shard_k_pad: int
    block_q: int
    block_k: int
    steps: tuple[StageTables, ...]  # one per (so, si) step

    @property
    def cp_size(self) -> int:
        return self.ring_outer * self.ring_inner


def build_double_ring_plan(slices: np.ndarray, total_seqlen: int, ring_outer: int,
                           ring_inner: int, *, block_q: int | None = None,
                           block_k: int | None = None, head_dim: int = 128) -> DoubleRingPlan:
    """Contiguous sharding in (outer, inner) rank order: the JAX builder,
    byte for byte at the same tile."""
    block_q, block_k = _tile(head_dim, block_q, block_k)
    cp = ring_outer * ring_inner
    if total_seqlen % cp:
        raise ValueError(f"total {total_seqlen} does not split over cp={cp}")
    slices = np.asarray(slices, dtype=np.int64)
    shard = total_seqlen // cp
    shard_q_pad = _round_up(shard, block_q)
    shard_k_pad = _round_up(shard, block_k)
    steps = []
    for so in range(ring_outer):
        for si in range(ring_inner):
            metas = []
            for r in range(cp):
                o, i = divmod(r, ring_inner)
                # the inner ring is not reset between outer cycles: at step
                # (so, si) it has turned so * (ring_inner - 1) + si times
                src = ((o - so) % ring_outer) * ring_inner + ((i - si + so) % ring_inner)
                metas.append(build_block_meta_general(
                    slices, [Run(0, r * shard, shard)], [Run(0, src * shard, shard)],
                    shard_q_pad, shard_k_pad, block_q=block_q, block_k=block_k))
            steps.append(StageTables.from_rank_metas(metas, shard_k_pad))
    return DoubleRingPlan(ring_outer=ring_outer, ring_inner=ring_inner, shard_len=shard,
                          shard_q_pad=shard_q_pad, shard_k_pad=shard_k_pad, block_q=block_q,
                          block_k=block_k, steps=tuple(steps))


def double_ring_attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           plan: DoubleRingPlan, params: FlexAttnParams, groups):
    """This rank's contiguous shards -> (out, lse), the K/V rotating over
    ``groups.intra`` (inner) and ``groups.inter`` (outer)."""
    _check_params(params, "double-ring")
    rank = group_rank(groups.inter) * plan.ring_inner + group_rank(groups.intra)
    tabs = step_tables(plan, rank, str(q.device))
    fp32 = dataclasses.replace(params, out_dtype=torch.float32)
    qh = _hm(q, plan.shard_q_pad)
    kv = torch.stack([k, v], dim=1)
    out = lse = None
    step = 0
    for so in range(plan.ring_outer):
        if so > 0:  # once per inner cycle: the inner ring is back where it started
            with named_scope("magi_loongtrain_outer_ppermute"):
                kv = ring_shift(kv, groups.inter)
        for si in range(plan.ring_inner):
            if si > 0:
                with named_scope("magi_loongtrain_inner_ppermute"):
                    kv = ring_shift(kv, groups.intra)
            ftab, btab, kv_pad = tabs[step]
            buf = _kv_buffer((kv,), kv_pad, k)
            out_h, lse_h, _ = flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab, fp32)
            out_i, lse_i = _seq(out_h, lse_h, plan.shard_len)
            out, lse = ((out_i, lse_i) if out is None
                        else correct_attn_out_lse(out, lse, out_i, lse_i))
            step += 1
    return out.to(params.out_dtype), lse


def make_double_ring_attn_fn(plan: DoubleRingPlan, groups, params: FlexAttnParams):
    """``fn(q, k, v) -> (out, lse)`` on this rank's contiguous shards over
    the (outer, inner) ``HierCpGroups`` (the JAX ``make_double_ring_attn_fn``
    over ``P((ring_out, ring_in))``)."""
    if tuple(groups.shape) != (plan.ring_outer, plan.ring_inner):
        raise ValueError(f"the groups' (outer, inner) layout {tuple(groups.shape)} is not the "
                         f"plan's {(plan.ring_outer, plan.ring_inner)}")

    def fn(q, k, v):
        return double_ring_attn_local(q, k, v, plan, params, groups)

    return fn
