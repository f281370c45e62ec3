"""Shared model helpers (one copy for every model family)."""

from __future__ import annotations

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


def make_model_train_step(model, optimizer: torch.optim.Optimizer):
    """A train step over a model exposing ``loss(tokens, labels, pos)``:
    ``step(tokens, labels, pos)`` runs forward, backward and one
    ``optimizer`` update in place, and returns the loss (a detached float32
    scalar on the model's device). The counterpart of the JAX
    ``make_model_train_step``, whose state is functional; here it lives in
    the model and the optimizer.

    Under context parallelism (a model with a ``group``: each rank passes
    its dispatched shard) ``model.loss`` is this rank's share of the global
    loss; after the backward every parameter gradient is summed over the
    group (the psums of the JAX model's ``shard_map``), so the replicated
    parameters take the same update on every rank, and the returned loss
    is the sum of the shares."""
    import torch.distributed as dist

    group = getattr(model, "group", None)

    def step(tokens, labels, pos):
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(tokens, labels, pos)
        loss.backward()
        if group is not None:
            sum_grads_over_group(model, group)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
        optimizer.step()
        return loss.detach()

    return step


def sum_grads_over_group(model, group) -> None:
    """Sum every parameter gradient over ``group`` in place: the cp ranks
    hold replicated parameters, each with the gradient of its own shard's
    share of the loss."""
    import torch.distributed as dist

    works = [dist.all_reduce(p.grad, group=group, async_op=True)
             for p in model.parameters() if p.grad is not None]
    for w in works:
        w.wait()


def resolve_harness_blocking(cfg, q_naive, k_naive, attn_type_map, total_seqlen, cp_size: int,
                             block_q: int | None, block_k: int | None, *, group=None,
                             device=None) -> tuple[int, int, int]:
    """(block_q, block_k, head_block) for a model-harness plan: the tp=1
    counterpart of the JAX ``models/_common.resolve_harness_blocking``,
    one policy for every model builder at any cp size.

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

    hq, hk = cfg.n_heads, cfg.n_kv_heads
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
                   group=None, device=None):
    """Shared builder tail of the context-parallel model bundles: the
    dispatch meta and the cp plan for one self-attention mask, and the
    kernels' parameters at the harness's blocking. Returns (plan,
    attn_params, dispatch_meta), as the JAX ``plan_flex_attn``.
    ``overlap_config`` forces the overlap degree (default: degree 0, one
    merged cast and one kernel call per layer). ``cp_mesh_shape`` (n_inter,
    n_intra) plans hierarchical two-level comm over that layout of the
    ranks (the JAX ``cp_axis`` pair). ``group`` and ``device``: the flat cp
    group whose rank 0 decides the tuned blocking, and the card it is tuned
    for (``resolve_harness_blocking``)."""
    from ..common.enum import AttnMaskType
    from ..common.ranges import AttnRanges
    from ..meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from ..parallel.dist_attn import build_dist_attn_plan, make_attn_params

    qr = q_ranges if isinstance(q_ranges, AttnRanges) else AttnRanges.from_ranges(q_ranges)
    kr = k_ranges if isinstance(k_ranges, AttnRanges) else AttnRanges.from_ranges(k_ranges)
    types = [int(t) for t in attn_type_map]
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        qr, kr, [AttnMaskType(t) for t in types], total_seqlen, total_seqlen,
        chunk_size=chunk_size, cp_size=cp_size,
    )
    bq, bk, hb = resolve_harness_blocking(cfg, qr.to_naive_ranges(), kr.to_naive_ranges(), types,
                                          total_seqlen, cp_size, block_q, block_k, group=group,
                                          device=device)
    plan = build_dist_attn_plan(mq, bucket, block_q=bq, block_k=bk,
                                overlap_config=overlap_config, cp_mesh_shape=cp_mesh_shape)
    attn_params = make_attn_params(plan, cfg.head_dim, out_dtype=cfg.torch_dtype, head_block=hb)
    return plan, attn_params, mq
