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
    """A single-device train step over a model exposing ``loss(tokens,
    labels, pos)``: ``step(tokens, labels, pos)`` runs forward, backward and
    one ``optimizer`` update in place, and returns the loss (a detached
    float32 scalar on the model's device). The counterpart of the JAX
    ``make_model_train_step``, whose state is functional; here it lives in
    the model and the optimizer."""

    def step(tokens, labels, pos):
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(tokens, labels, pos)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def resolve_harness_blocking(cfg, q_naive, k_naive, attn_type_map, total_seqlen,
                             block_q: int | None, block_k: int | None) -> tuple[int, int, int]:
    """(block_q, block_k, head_block) for a model-harness plan: the cp=1,
    tp=1 counterpart of the JAX ``models/_common.resolve_harness_blocking``,
    one policy for every model builder.

    - The caller's ``block_q``/``block_k``, or a ``MAGI_ATTENTION_BLOCK_Q/_K``
      pin, or ``MAGI_ATTENTION_AUTOTUNE=off``: the legacy harness blocking
      (the caller's tile, else the env's, else ``HOPPER_TILES``; head_block
      1, or ``MAGI_ATTENTION_HEAD_BLOCK`` snapped by ``_auto_head_block``),
      where the reference's tuner steps aside too.
    - Else ``ops.auto_kernel_config`` restricted to the row-major grid, as
      the reference's harness restricts its tuner (the distributed kernels
      run that grid): head_block G, each K/V tile read once per head pair.

    ``total_seqlen`` is taken for the reference's signature: at cp=1 every
    candidate tile fits the sequence, so it changes nothing here."""
    from .. import env
    from ..ops.flex_attn import _auto_head_block, auto_kernel_config, resolve_tile

    hq, hk = cfg.n_heads, cfg.n_kv_heads
    pinned = env.block_q() is not None or env.block_k() is not None
    if block_q is None and block_k is None and not pinned and env.autotune_mode() != "off":
        bq, bk, hb, _ = auto_kernel_config(
            q_naive, k_naive, hq, hk, attn_type_map=attn_type_map, head_dim=cfg.head_dim,
            dtype=str(cfg.dtype), grid="row_major",
        )
        return bq, bk, hb
    hb_env = env.head_block_override()
    hb = 1 if hb_env is None else _auto_head_block(hb_env, hq, max(hq // max(hk, 1), 1))
    return (*resolve_tile(cfg.head_dim, block_q, block_k), hb)
