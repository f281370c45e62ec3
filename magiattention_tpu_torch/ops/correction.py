"""Out/LSE correction math: merging partial attention results.

Numerically-safe log-sum-exp merging of partial attention outputs computed
over disjoint KV subsets, and the fold of attention sinks into a merged
result. Plain torch elementwise ops, as the JAX package's are plain jnp:
the split-KV decode merges its splits through :func:`merge_partials`, the
qo-comm runtime folds its sink in after the merge through
:func:`correct_attn_out_lse_with_sink`.

Convention: a partial result is (out, lse) where out rows with no coverage
are 0 and their lse is -inf; merging is associative and commutative. The
all-``-inf`` corner (routine in paged decode: a split past a sequence's end)
stays exactly ``-inf`` with a zero payload, even when the uncovered
payload is garbage (NaN/inf).
"""

from __future__ import annotations

import math

import torch

NEG_INF = float("-inf")


def _where_neginf(x: torch.Tensor, fill: float, other: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isneginf(x), torch.full_like(other, fill), other)


def safe_lse_merge(lse1: torch.Tensor, lse2: torch.Tensor) -> torch.Tensor:
    """logaddexp that is -inf-safe: every ``exp`` argument is pre-masked so
    no ``-inf - (-inf)`` subtraction is ever evaluated."""
    m = torch.maximum(lse1, lse2)
    m_safe = _where_neginf(m, 0.0, m)
    d1 = _where_neginf(lse1, NEG_INF, lse1 - m_safe)
    d2 = _where_neginf(lse2, NEG_INF, lse2 - m_safe)
    s = torch.exp(d1) + torch.exp(d2)
    return torch.where(
        s > 0, m_safe + torch.log(s.clamp_min(1e-38)), torch.full_like(s, NEG_INF)
    )


def correct_attn_lse(lse1: torch.Tensor, lse2: torch.Tensor) -> torch.Tensor:
    """Merged lse of two partials (the explicit spelling of
    :func:`safe_lse_merge`)."""
    return safe_lse_merge(lse1, lse2)


def correct_attn_out(
    out1: torch.Tensor,  # [..., h, d]
    lse1: torch.Tensor,  # [..., h]
    out2: torch.Tensor,
    lse2: torch.Tensor,
    lse: torch.Tensor,
) -> torch.Tensor:
    """Merge two partial outs given the already-merged ``lse``:
    exp(lse_i - lse)-weighted sum, f32 internally; rows covered by neither
    stay 0. A zero-coverage partial (lse_i = -inf) contributes nothing even
    when its payload is garbage: the payload is masked out, not just
    zero-weighted (0 * NaN would be NaN)."""
    lse_safe = _where_neginf(lse, 0.0, lse)
    w1 = torch.exp(_where_neginf(lse1, NEG_INF, lse1 - lse_safe))
    w2 = torch.exp(_where_neginf(lse2, NEG_INF, lse2 - lse_safe))
    zero = torch.zeros((), dtype=torch.float32, device=out1.device)
    o1 = torch.where(torch.isneginf(lse1)[..., None], zero, out1.float())
    o2 = torch.where(torch.isneginf(lse2)[..., None], zero, out2.float())
    out = w1[..., None] * o1 + w2[..., None] * o2
    return out.to(out1.dtype)


def correct_attn_out_lse(
    out1: torch.Tensor,  # [t, h, d]
    lse1: torch.Tensor,  # [t, h]
    out2: torch.Tensor,
    lse2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial (out, lse) pairs over disjoint KV sets:
    out = exp(lse1 - lse) * out1 + exp(lse2 - lse) * out2; rows covered by
    neither stay (0, -inf). f32 internally.

    Under ``MAGI_ATTENTION_GUARD=repair`` each input partial is quarantined
    first (``resilience.guards.quarantine_if_repair``, site
    ``"correction"``): rows with a NaN or +inf lse or a non-finite out merge
    as (0, -inf) no-ops, in every merge tree built on this function (the
    decode splits, the cascade's levels, the tick's pairs, cp decode, the cp
    stages). ``off`` and ``check`` add no op."""
    from ..resilience.guards import quarantine_if_repair

    out1, lse1 = quarantine_if_repair(out1, lse1, "correction")
    out2, lse2 = quarantine_if_repair(out2, lse2, "correction")
    lse = safe_lse_merge(lse1, lse2)
    return correct_attn_out(out1, lse1, out2, lse2, lse), lse


def merge_partials(
    outs: list[torch.Tensor],  # each [..., h, d] (f32 recommended)
    lses: list[torch.Tensor],  # each [..., h]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Associative binary-tree merge of N partial ``(out, lse)`` pairs, in
    the same pairing order as the JAX package's ``merge_partials``."""
    if not outs or len(outs) != len(lses):
        raise ValueError(
            f"merge_partials: {len(outs)} outs and {len(lses)} lses "
            "(need the same non-zero count)"
        )
    while len(outs) > 1:
        next_o, next_l = [], []
        for i in range(0, len(outs) - 1, 2):
            o, l = correct_attn_out_lse(outs[i], lses[i], outs[i + 1], lses[i + 1])
            next_o.append(o)
            next_l.append(l)
        if len(outs) % 2:
            next_o.append(outs[-1])
            next_l.append(lses[-1])
        outs, lses = next_o, next_l
    return outs[0], lses[0]


SINK_LAYOUTS = ("sh", "ssh", "shd")


def exp_where_finite(x: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """exp(arg), 0 where ``x`` is -inf; the masked entries' ``arg`` (which
    may be NaN there) never reaches the exp or its gradient."""
    return torch.exp(torch.where(torch.isneginf(x), torch.full_like(arg, NEG_INF), arg))


def _sink_lse(sink: torch.Tensor, sink_layout: str, tq: int) -> torch.Tensor:
    """Per-(row, head) log-denominator contribution of the sink tokens:
    ``sh`` = [S, hq] logits shared by every q row; ``ssh`` = [tq, S, hq]
    per-row logits; ``shd`` = [S, hq, head_dim] sinks with logit 0 that
    carry a value (each adds log(S) to the denominator, whatever q is)."""
    s = sink.float()
    if sink_layout == "sh":
        if s.ndim != 2:
            raise ValueError(f"sh sink must be [S, hq], got {tuple(s.shape)}")
        return torch.logsumexp(s, dim=0)[None, :]  # [1, hq]
    if sink_layout == "ssh":
        if s.ndim != 3 or s.shape[0] != tq:
            raise ValueError(f"ssh sink must be [tq, S, hq], got {tuple(s.shape)} (tq={tq})")
        return torch.logsumexp(s, dim=1)  # [tq, hq]
    if sink_layout == "shd":
        if s.ndim != 3:
            raise ValueError(f"shd sink must be [S, hq, d], got {tuple(s.shape)}")
        n = s.shape[0]
        return torch.full((1, s.shape[1]), math.log(n) if n else NEG_INF, device=s.device)
    raise ValueError(f"sink_layout={sink_layout!r}: expected one of {SINK_LAYOUTS}")


def correct_attn_lse_with_sink(
    lse: torch.Tensor, sink: torch.Tensor, sink_layout: str = "sh"
) -> torch.Tensor:
    """lse' = logaddexp(lse, the sink's lse)."""
    return safe_lse_merge(lse, _sink_lse(sink, sink_layout, lse.shape[0]).expand(lse.shape))


def correct_attn_out_with_sink(
    out: torch.Tensor, lse: torch.Tensor, sink: torch.Tensor, sink_layout: str = "sh"
) -> torch.Tensor:
    """out' = out * exp(lse - lse'): the sink joins the softmax denominator
    exactly once; uncovered rows (lse = -inf) stay 0. An ``shd`` sink's
    values also join the numerator."""
    return correct_attn_out_lse_with_sink(out, lse, sink, sink_layout)[0]


def correct_attn_out_lse_with_sink(
    out: torch.Tensor,  # [t, h, d]
    lse: torch.Tensor,  # [t, h]
    sink: torch.Tensor,
    sink_layout: str = "sh",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out', lse') with the sink folded in once. ``sh`` / ``ssh`` sinks are
    pure logits: they rescale ``out`` by exp(lse - lse'). ``shd`` sinks carry
    values: each of the S sink tokens attends with logit 0 and value
    sink[s, h, :], so out' = exp(lse - lse') * out + exp(-lse') * sum_s
    sink[s]. Differentiable in out, lse and sink, with finite gradients on
    uncovered rows."""
    lse_tot = correct_attn_lse_with_sink(lse, sink, sink_layout)
    w = exp_where_finite(lse, lse - lse_tot)
    out32 = out.float() * w[..., None]
    if sink_layout == "shd":
        # lse' = -inf only when S = 0 and the row is uncovered: it stays 0
        w_sink = exp_where_finite(lse_tot, -lse_tot)
        out32 = out32 + w_sink[..., None] * sink.float().sum(dim=0)[None]
    return out32.to(out.dtype), lse_tot
