"""Shared model helpers (one copy for every model family)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def masked_ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of next-token CE over positions with label >= 0, count of them).

    ``logits`` [t, vocab] float32, ``labels`` [t]. The single definition of
    the loss, as in the JAX package."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    tok_loss = -logp.gather(1, safe[:, None])[:, 0]
    return torch.where(valid, tok_loss, 0.0).sum(), valid.sum().to(torch.float32)


class ParallelGroups(NamedTuple):
    """This rank's subgroups of a (pp, dp, cp, tp) layout of the ranks
    (:func:`make_parallel_groups`); an axis of size 1 has no group (None).
    ``cp`` is a flat group, or a ``comm.HierCpGroups`` for an (n_inter,
    n_intra) cp. ``dpcp`` spans the dp x cp ranks of this (pp, tp) cell
    (the loss count and the gradient sum of a stage), ``ppdpcp`` the pp x
    dp x cp ranks of this tp rank (the pipeline's loss and its replicated
    weights). ``sizes`` and ``coords`` are the (pp, dp, cp, tp) extents and
    this rank's place in them."""

    pp: object
    dp: object
    cp: object
    tp: object
    dpcp: object
    ppdpcp: object
    sizes: tuple[int, int, int, int]
    coords: tuple[int, int, int, int]


def make_parallel_groups(*, pp: int = 1, dp: int = 1, cp=1, tp: int = 1,
                         group=None) -> ParallelGroups:
    """The subgroups of the ranks of ``group`` (default: the default group)
    laid out row-major over (pp, dp, cp, tp): rank r is JAX mesh device r
    of ``Mesh(devices.reshape(pp, dp, cp, tp), ("pp", "dp", "cp", "tp"))``,
    so a rank and a JAX device hold the same shard. ``cp`` is a size, or an
    (n_inter, n_intra) pair for hierarchical cp (cp rank c is node ``c //
    n_intra``, as ``comm.make_hier_cp_groups`` lays it out).

    ``dist.new_group`` must be called by every rank of the default group
    for every subgroup, in one order: every rank of the default group calls
    this once, with the same arguments, and ``group`` spans it."""
    import itertools

    import torch.distributed as dist

    from ..comm.hier import HierCpGroups

    hier = tuple(int(c) for c in cp) if isinstance(cp, (tuple, list)) else None
    sizes = (int(pp), int(dp), hier[0] * hier[1] if hier else int(cp), int(tp))
    world = dist.get_world_size(group)
    if min(sizes) < 1 or sizes[0] * sizes[1] * sizes[2] * sizes[3] != world:
        raise ValueError(f"(pp, dp, cp, tp) = {sizes} does not lay out the group's {world} ranks")
    if world != dist.get_world_size():
        raise ValueError("make_parallel_groups needs a group that spans the default group: "
                         "every rank of the default group creates the subgroups")
    ranks = [dist.get_global_rank(group, r) for r in range(world)] if group is not None \
        else list(range(world))
    me = dist.get_rank(group)
    coords = tuple(int(c) for c in np.unravel_index(me, sizes))

    def flat_rank(c):
        return ranks[int(np.ravel_multi_index(c, sizes))]

    def axes_group(axes):
        """Every rank creates each group over ``axes`` (the others fixed,
        row-major); this rank keeps its own. None when the group is one rank."""
        if int(np.prod([sizes[a] for a in axes])) == 1:
            return None
        rest = [a for a in range(4) if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
            members = []
            for var in itertools.product(*(range(sizes[a]) for a in axes)):
                c = [0] * 4
                for a, v in zip(rest, fixed):
                    c[a] = v
                for a, v in zip(axes, var):
                    c[a] = v
                members.append(flat_rank(c))
            g = dist.new_group(members)
            if all(coords[a] == v for a, v in zip(rest, fixed)):
                mine = g
        return mine

    pp_g, dp_g, cp_g, tp_g = (axes_group((a,)) for a in range(4))
    dpcp = cp_g if sizes[1] == 1 else dp_g if sizes[2] == 1 else axes_group((1, 2))
    ppdpcp = dpcp if sizes[0] == 1 else axes_group((0, 1, 2))
    if hier is not None and cp_g is not None:
        # the (n_inter, n_intra) subgroups of every cp group, in one order
        n_inter, n_intra = hier
        inter = intra = None
        for fixed in itertools.product(range(sizes[0]), range(sizes[1]), range(sizes[3])):
            cp_ranks = [flat_rank((fixed[0], fixed[1], c, fixed[2])) for c in range(sizes[2])]
            inters = [dist.new_group([cp_ranks[n * n_intra + i] for n in range(n_inter)])
                      for i in range(n_intra)]
            intras = [dist.new_group([cp_ranks[n * n_intra + i] for i in range(n_intra)])
                      for n in range(n_inter)]
            if fixed == (coords[0], coords[1], coords[3]):
                node, i = divmod(coords[2], n_intra)
                inter, intra = inters[i], intras[node]
        cp_g = HierCpGroups(cp_g, inter, intra, n_inter, n_intra)
    return ParallelGroups(pp_g, dp_g, cp_g, tp_g, dpcp, ppdpcp, sizes, coords)


def make_model_train_step(model, optimizer: torch.optim.Optimizer):
    """A train step over a model exposing ``loss(*batch)`` (the Llama
    trainers' ``(tokens, labels, pos)``, the DiT's ``(noised, target_v,
    t_chunk, pos, text)``): ``step(*batch)`` runs forward, backward and one
    ``optimizer`` update in place, and returns the loss (a detached float32
    scalar on the model's device). The counterpart of the JAX
    ``make_model_train_step``, whose state is functional; here it lives in
    the model and the optimizer.

    Under a parallel layout (each rank passes its shard of the batch)
    ``model.loss`` is this rank's share of the global loss. After the
    backward each gradient is summed over the groups of
    ``model.grad_groups()`` (the psums of the JAX model's ``shard_map``),
    so that every rank takes the update the one-card model takes on the
    whole batch, and the returned loss is the sum of the shares over
    ``model.sum_groups``."""
    import torch.distributed as dist

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(*batch)
        loss.backward()
        for params, grp in model.grad_groups():
            sum_grads(params, grp)
        loss = loss.detach().clone()
        for grp in model.sum_groups:
            dist.all_reduce(loss, group=grp)
        optimizer.step()
        return loss.detach()

    return step


def sum_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in place. A parameter
    this rank's loss did not reach (a pipeline stage's unused embedding)
    takes a zero gradient first: every rank joins every all-reduce."""
    import torch.distributed as dist

    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    works = [dist.all_reduce(p.grad, group=group, async_op=True) for p in params]
    for w in works:
        w.wait()


def check_tp(cfg, tp: int) -> None:
    """Raise unless ``tp`` divides both head counts (the JAX
    ``plan_flex_attn``'s check)."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={cfg.n_heads} and "
                         f"n_kv_heads={cfg.n_kv_heads}")


def resolve_harness_blocking(cfg, q_naive, k_naive, attn_type_map, total_seqlen, cp_size: int,
                             block_q: int | None, block_k: int | None, *, group=None,
                             device=None, tp: int = 1) -> tuple[int, int, int]:
    """(block_q, block_k, head_block) for a model-harness plan: the JAX
    ``models/_common.resolve_harness_blocking``, one policy for every model
    builder at any cp size. Heads are the per-tp-rank counts the kernels
    run (``n_heads // tp``, ``n_kv_heads // tp``).

    - The caller's ``block_q``/``block_k``: the legacy harness blocking.
    - Else the autotuner's row-major decision (``tuning.
      resolve_block_config``: the cp kernels run that grid; tiles no wider
      than a rank's shard of ``total_seqlen``; rank 0's decision broadcast
      over ``group``), head_block G on the fitted model.
    - Where the tuner steps aside (a ``MAGI_ATTENTION_BLOCK_Q/_K`` pin,
      ``MAGI_ATTENTION_AUTOTUNE=off``): the legacy harness blocking, the
      caller's tile, else the env's, else ``HOPPER_TILES``; head_block 1,
      or ``MAGI_ATTENTION_HEAD_BLOCK`` snapped (``pin_head_block``)."""
    from ..ops.flex_attn import pin_head_block, resolve_tile

    hq, hk = max(cfg.n_heads // tp, 1), max(cfg.n_kv_heads // tp, 1)
    if block_q is None and block_k is None:
        from ..tuning import resolve_block_config

        tuned = resolve_block_config(q_naive, k_naive, tuple(int(t) for t in attn_type_map),
                                     total_seqlen, total_seqlen, cp_size, hq, hk, cfg.head_dim,
                                     str(cfg.dtype), group=group, device=device)
        if tuned is not None:
            return tuned
    return (*resolve_tile(cfg.head_dim, block_q, block_k), pin_head_block(1, hq, hk))


def plan_flex_attn(cfg, total_seqlen, q_ranges, k_ranges, attn_type_map, *, chunk_size: int,
                   cp_size: int, block_q: int | None = None, block_k: int | None = None,
                   overlap_config=None, cp_mesh_shape: tuple[int, int] | None = None,
                   group=None, device=None, tp: int = 1):
    """Shared builder tail of the context-parallel model bundles: the
    dispatch meta and the cp plan for one self-attention mask, and the
    kernels' parameters at the harness's blocking. Returns (plan,
    attn_params, dispatch_meta), as the JAX ``plan_flex_attn``.
    ``overlap_config`` forces the overlap degree (default: degree 0, one
    merged cast and one kernel call per layer). ``cp_mesh_shape`` (n_inter,
    n_intra) plans hierarchical two-level comm over that layout of the
    ranks (the JAX ``cp_axis`` pair). ``group`` and ``device``: the flat cp
    group whose rank 0 decides the tuned blocking, and the card it is tuned
    for (``resolve_harness_blocking``). ``tp``: the tensor-parallel size,
    which must divide both head counts (raises ``ValueError`` as the JAX
    builder does); the blocking is resolved at the per-rank heads."""
    from ..common.enum import AttnMaskType
    from ..common.ranges import AttnRanges
    from ..meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from ..parallel.dist_attn import build_dist_attn_plan, make_attn_params

    check_tp(cfg, tp)
    qr = q_ranges if isinstance(q_ranges, AttnRanges) else AttnRanges.from_ranges(q_ranges)
    kr = k_ranges if isinstance(k_ranges, AttnRanges) else AttnRanges.from_ranges(k_ranges)
    types = [int(t) for t in attn_type_map]
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        qr, kr, [AttnMaskType(t) for t in types], total_seqlen, total_seqlen,
        chunk_size=chunk_size, cp_size=cp_size,
    )
    bq, bk, hb = resolve_harness_blocking(cfg, qr.to_naive_ranges(), kr.to_naive_ranges(), types,
                                          total_seqlen, cp_size, block_q, block_k, group=group,
                                          device=device, tp=tp)
    plan = build_dist_attn_plan(mq, bucket, block_q=bq, block_k=bk,
                                overlap_config=overlap_config, cp_mesh_shape=cp_mesh_shape)
    attn_params = make_attn_params(plan, cfg.head_dim, out_dtype=cfg.torch_dtype, head_block=hb)
    return plan, attn_params, mq
