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
