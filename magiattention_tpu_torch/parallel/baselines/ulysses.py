"""Ulysses (head-sharded all-to-all) sequence-parallel attention baseline.

The counterpart of the JAX package's ``parallel/baselines/ulysses.py``
(reference ``exps/dist_attn/baselines/ulysess.py``): an all-to-all swaps
the sharding from tokens to heads (``comm.seq_to_heads``), each rank runs
whole-sequence flex attention for its head block on one global table (any
flex mask), and the inverse all-to-all swaps back. Both all-to-alls are
differentiable (each the other's backward). Needs cp to divide both head
counts.
"""

from __future__ import annotations

import dataclasses

import torch

from ...comm.group_collective import group_size
from ...comm.primitives import heads_to_seq, seq_to_heads
from ...utils.instrument import named_scope
from ...ops.block_meta import FlexAttnBlockMeta, build_block_meta
from ...ops.flex_attn import FlexAttnParams, bwd_tables, flex_attn_headmajor, fwd_tables
from ..dist_attn import _hm, _seq
from .ring import _check_params, _tile


@dataclasses.dataclass(frozen=True, eq=False)
class UlyssesPlan:
    cp_size: int
    total_seqlen: int
    meta: FlexAttnBlockMeta  # global-mask tables, shared by all ranks


def build_ulysses_plan(q_ranges, k_ranges, attn_type_map, total_seqlen: int, cp_size: int, *,
                       block_q: int | None = None, block_k: int | None = None,
                       head_dim: int = 128) -> UlyssesPlan:
    block_q, block_k = _tile(head_dim, block_q, block_k)
    meta = build_block_meta(q_ranges, k_ranges, attn_type_map, total_seqlen, total_seqlen,
                            block_q=block_q, block_k=block_k)
    return UlyssesPlan(cp_size=cp_size, total_seqlen=total_seqlen, meta=meta)


def check_heads(hq: int, hk: int, cp: int, name: str = "Ulysses") -> None:
    if hq % cp or hk % cp:
        raise ValueError(f"{name} needs heads divisible by cp: hq={hq} hk={hk} cp={cp}")


def ulysses_attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: UlyssesPlan,
                       params: FlexAttnParams, group):
    """This rank's token shards [t_loc, h, d] -> (out [t_loc, hq, d] in
    ``params.out_dtype``, lse [t_loc, hq] f32): all-to-all to a head block
    of the whole sequence, one flex call, all-to-all back."""
    _check_params(params, "ulysses")
    cp, t_loc = plan.cp_size, q.shape[0]
    if t_loc * cp != plan.total_seqlen:
        raise ValueError(f"{t_loc} rows a rank over cp={cp} is not the plan's "
                         f"{plan.total_seqlen} tokens")
    check_heads(q.shape[1], k.shape[1], cp)
    with named_scope("magi_ulysses_seq_to_heads_a2a"):
        qg, kg, vg = (seq_to_heads(x, group) for x in (q, k, v))  # [total, h / cp, d]
    meta = plan.meta
    tqp, tkp = meta.num_q_blocks * meta.block_q, meta.num_k_blocks * meta.block_k
    dev = str(q.device)
    out_h, lse_h, _ = flex_attn_headmajor(
        _hm(qg, tqp), _hm(kg, tkp), _hm(vg, tkp), fwd_tables(meta, dev), bwd_tables(meta, dev),
        dataclasses.replace(params, out_dtype=torch.float32))
    out_g, lse_g = _seq(out_h, lse_h, plan.total_seqlen)
    with named_scope("magi_ulysses_heads_to_seq_a2a"):
        out = heads_to_seq(out_g, group).to(params.out_dtype)
        lse = heads_to_seq(lse_g[..., None], group)[..., 0]
    return out, lse


def make_ulysses_attn_fn(plan: UlyssesPlan, group, params: FlexAttnParams):
    """``fn(q, k, v) -> (out, lse)`` on this rank's contiguous token shards
    (the JAX ``make_ulysses_attn_fn`` over ``P(cp)``)."""
    if plan.cp_size != group_size(group):
        raise ValueError(f"the plan is for cp={plan.cp_size}, the group has "
                         f"{group_size(group)} ranks")

    def fn(q, k, v):
        return ulysses_attn_local(q, k, v, plan, params, group)

    return fn
