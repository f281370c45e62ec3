"""USP: unified sequence parallelism (Ulysses x ring) baseline.

The counterpart of the JAX package's ``parallel/baselines/usp.py``
(reference ``exps/dist_attn/baselines/usp.py``): heads are all-to-all
sharded over one subgroup (Ulysses, typically inside a node) while the
sequence rings over the other (typically across nodes). The two subgroups
are a ``comm.HierCpGroups`` (``comm.make_hier_cp_groups(group, ring,
ulysses)``): its inter level is the ring, its intra level Ulysses, so rank
``r = ring_idx * ulysses + ulysses_idx`` holds token block r, as JAX's
``P((ring, ulysses))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops.flex_attn import FlexAttnParams
from .ring import RingAttnPlan, build_ring_attn_plan, ring_attn_local
from ...comm.primitives import heads_to_seq, seq_to_heads
from .ulysses import check_heads


@dataclasses.dataclass(frozen=True, eq=False)
class USPPlan:
    ulysses_size: int
    ring_plan: RingAttnPlan  # over the ring subgroup, sequence length = total


def build_usp_plan(slices: np.ndarray, total_seqlen: int, ulysses_size: int, ring_size: int, *,
                   block_q: int | None = None, block_k: int | None = None,
                   head_dim: int = 128) -> USPPlan:
    ring_plan = build_ring_attn_plan(slices, total_seqlen, ring_size, block_q=block_q,
                                     block_k=block_k, head_dim=head_dim)
    return USPPlan(ulysses_size=ulysses_size, ring_plan=ring_plan)


def usp_attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: USPPlan,
                   params: FlexAttnParams, groups):
    """This rank's token shard [total / (u r), h, d] -> (out, lse): the
    Ulysses all-to-all over ``groups.intra``, ring attention over
    ``groups.inter`` on the head block, the inverse all-to-all."""
    check_heads(q.shape[1], k.shape[1], plan.ulysses_size, "USP")
    qg, kg, vg = (seq_to_heads(x, groups.intra) for x in (q, k, v))  # [total / r, h / u, d]
    out_g, lse_g = ring_attn_local(qg, kg, vg, plan.ring_plan, params, groups.inter)
    out = heads_to_seq(out_g, groups.intra)
    lse = heads_to_seq(lse_g[..., None], groups.intra)[..., 0]
    return out, lse


def make_usp_attn_fn(plan: USPPlan, groups, params: FlexAttnParams):
    """``fn(q, k, v) -> (out, lse)`` on this rank's token shard, over the
    (ring, ulysses) ``HierCpGroups`` (the JAX ``make_usp_attn_fn`` over
    ``P((ring, ulysses))``). Raises when the groups' layout is not the
    plan's."""
    if tuple(groups.shape) != (plan.ring_plan.cp_size, plan.ulysses_size):
        raise ValueError(f"the groups' (ring, ulysses) layout {tuple(groups.shape)} is not the "
                         f"plan's {(plan.ring_plan.cp_size, plan.ulysses_size)}")

    def fn(q, k, v):
        return usp_attn_local(q, k, v, plan, params, groups)

    return fn
