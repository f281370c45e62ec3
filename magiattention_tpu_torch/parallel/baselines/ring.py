"""Ring context-parallel attention baseline.

The counterpart of the JAX package's ``parallel/baselines/ring.py``
(reference ``exps/dist_attn/baselines/ring_attn.py``): the classic ring-P2P
cp scheme every cp method is benchmarked against. K/V rotate around the cp
group with ``comm.ring_shift`` (one ``exchange`` a step, the JAX
``lax.ppermute``; its backward the reverse shift); each step computes the
local Q shard's partial attention against the visiting K/V shard with the
flex kernels (per-(rank, step) host tables in global coordinates, as
``parallel.dist_attn`` builds them), merged by the LSE correction in f32,
whose lse cotangent reaches the kernels' backward.

Contiguous sharding (rank r holds tokens ``[r shard, (r+1) shard)``). A step
whose visiting shard is wholly masked still rotates; its table is empty,
so its kernel call does no work.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...comm.group_collective import group_rank, group_size
from ...comm.primitives import ring_shift
from ...ops.block_meta import Run, build_block_meta_general
from ...ops.correction import correct_attn_out_lse
from ...ops.flex_attn import FlexAttnParams, flex_attn_headmajor, resolve_tile
from ..dist_attn import StageTables, _hm, _kv_buffer, _rank_kernel_tables, _round_up, _seq


@dataclasses.dataclass(frozen=True, eq=False)
class RingAttnPlan:
    cp_size: int
    shard_len: int
    shard_q_pad: int
    shard_k_pad: int
    block_q: int
    block_k: int
    steps: tuple[StageTables, ...]  # one per ring step (0 = own shard)


def _tile(head_dim: int, block_q, block_k) -> tuple[int, int]:
    """The plan builders' tile: the caller's, else the port's kernel tile
    (``resolve_tile``; JAX's builders default to 128 x 128, which the
    flex kernels do not take)."""
    return resolve_tile(head_dim, block_q, block_k)


def build_ring_attn_plan(
    slices: np.ndarray,  # [S, 5] global (qs, qe, ks, ke, type)
    total_seqlen: int,
    cp_size: int,
    *,
    block_q: int | None = None,
    block_k: int | None = None,
    head_dim: int = 128,
) -> RingAttnPlan:
    """Plan ring attention for a contiguously sharded mask: the JAX
    builder, step for step and byte for byte at the same tile."""
    block_q, block_k = _tile(head_dim, block_q, block_k)
    if total_seqlen % cp_size:
        raise ValueError(f"total {total_seqlen} does not split over cp={cp_size}")
    slices = np.asarray(slices, dtype=np.int64)
    shard = total_seqlen // cp_size
    shard_q_pad = _round_up(shard, block_q)
    shard_k_pad = _round_up(shard, block_k)
    steps = []
    for s in range(cp_size):
        metas = []
        for r in range(cp_size):
            src = (r - s) % cp_size  # whose K/V shard visits rank r at step s
            metas.append(build_block_meta_general(
                slices, [Run(0, r * shard, shard)], [Run(0, src * shard, shard)],
                shard_q_pad, shard_k_pad, block_q=block_q, block_k=block_k))
        steps.append(StageTables.from_rank_metas(metas, shard_k_pad))
    return RingAttnPlan(cp_size=cp_size, shard_len=shard, shard_q_pad=shard_q_pad,
                        shard_k_pad=shard_k_pad, block_q=block_q, block_k=block_k,
                        steps=tuple(steps))


@functools.lru_cache(maxsize=64)
def step_tables(plan, rank: int, device: str) -> tuple:
    """``rank``'s (ftab, btab, kv_pad) of every step of a ring-family plan
    on ``device``, copied once per (plan, rank, device)."""
    return tuple(_rank_kernel_tables(st, rank, plan.shard_q_pad, plan.block_q, plan.block_k,
                                     device) for st in plan.steps)


def _check_params(params: FlexAttnParams, name: str) -> None:
    if params.has_sink:
        raise ValueError(f"attention sink is not supported by the {name} baseline")


def ring_attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: RingAttnPlan,
                    params: FlexAttnParams, group):
    """This rank's shards q [shard, hq, d], k / v [shard, hk, d] -> (out
    [shard, hq, d] in ``params.out_dtype``, lse [shard, hq] f32): the K/V
    rotate around ``group``, each step's partial merged into the running
    one. Every rank of the group calls it. Differentiable in q, k, v."""
    _check_params(params, "ring")
    tabs = step_tables(plan, group_rank(group), str(q.device))
    fp32 = dataclasses.replace(params, out_dtype=torch.float32)
    qh = _hm(q, plan.shard_q_pad)
    kv = torch.stack([k, v], dim=1)  # one payload: [shard, 2, hk, d]
    out = lse = None
    for s, (ftab, btab, kv_pad) in enumerate(tabs):
        if s > 0:
            kv = ring_shift(kv, group)
        buf = _kv_buffer((kv,), kv_pad, k)
        out_h, lse_h, _ = flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab, fp32)
        out_i, lse_i = _seq(out_h, lse_h, plan.shard_len)
        out, lse = (out_i, lse_i) if out is None else correct_attn_out_lse(out, lse, out_i, lse_i)
    return out.to(params.out_dtype), lse


def make_ring_attn_fn(plan: RingAttnPlan, group, params: FlexAttnParams):
    """``fn(q, k, v) -> (out, lse)`` on this rank's contiguous shards: the
    torch meaning of the JAX ``make_ring_attn_fn``, whose function takes the
    global arrays sharded ``P(cp)``."""
    if plan.cp_size != group_size(group):
        raise ValueError(f"the plan is for cp={plan.cp_size}, the group has "
                         f"{group_size(group)} ranks")

    def fn(q, k, v):
        return ring_attn_local(q, k, v, plan, params, group)

    return fn
