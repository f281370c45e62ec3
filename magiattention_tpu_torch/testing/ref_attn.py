"""Dense reference attention over (q_range, k_range, mask_type) slices.

The ground-truth oracle for the port's kernels and plain versions: dense-mask
attention with GQA, softcap, attention sink, LSE and max-logits outputs,
computed in float64 by default. Runs wherever its tensors are.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..common.mask import make_attn_mask_from_ranges

NEG_INF = float("-inf")


def ref_attn(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,  # [tk, hk, d]
    mask,  # [tq, tk] bool (numpy or tensor)
    *,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,  # [hq] per-head sink logit
    compute_dtype: torch.dtype = torch.float64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-mask attention. Returns (out [tq,hq,d], lse [tq,hq], max_logits [hq]).

    - lse is the natural-log softmax denominator per (q, head), including the
      sink term when ``sink`` is given; fully-masked rows give lse=-inf (or
      lse=sink with a sink) and out=0.
    - max_logits is the per-head max of masked scaled (and softcapped) logits.
    """
    tq, hq, d = q.shape
    hk = k.shape[1]
    assert hq % hk == 0, f"GQA requires hq % hk == 0, got {hq=} {hk=}"
    group = hq // hk
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))

    qf = q.to(compute_dtype)
    kf = k.to(compute_dtype).repeat_interleave(group, dim=1)  # [tk, hq, d]
    vf = v.to(compute_dtype).repeat_interleave(group, dim=1)
    s = torch.einsum("qhd,khd->hqk", qf, kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    mask_t = torch.as_tensor(np.asarray(mask), dtype=torch.bool).to(q.device)
    s = s.masked_fill(~mask_t[None], NEG_INF)

    max_logits = s.amax(dim=(1, 2))  # [hq]
    m = s.amax(dim=-1)  # [hq, tq]
    if sink is not None:
        m = torch.maximum(m, sink.to(compute_dtype)[:, None])
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])  # masked entries: exp(-inf) = 0
    l = p.sum(dim=-1)
    if sink is not None:
        l = l + torch.exp(sink.to(compute_dtype)[:, None] - m_safe)
    lse = torch.where(
        l > 0, m_safe + torch.log(l.clamp_min(1e-300)), torch.full_like(l, NEG_INF)
    )
    denom = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("hqk,khd->qhd", p / denom[..., None], vf)
    return o, lse.transpose(0, 1), max_logits


def ref_attn_from_ranges(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges: Sequence[Sequence[int]],
    k_ranges: Sequence[Sequence[int]],
    attn_type_map: Sequence[int],
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ref_attn` with the mask materialized from attention slices."""
    mask = make_attn_mask_from_ranges(
        q_ranges, k_ranges, attn_type_map, q.shape[0], k.shape[0]
    )
    return ref_attn(q, k, v, mask, **kwargs)


def ref_attn_online(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,
    mask,  # [tq, tk] bool (numpy or tensor)
    *,
    scale: float | None = None,
    block: int = 128,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-wise online-softmax reference (the JAX ``ref_attn_online``):
    the streaming-softmax recurrence over ``block`` keys at a time, a second
    opinion on the kernels' math beside the dense :func:`ref_attn`, at
    O(tq * block) scores. Returns (out [tq, hq, d], lse [tq, hq])."""
    tq, hq, d = q.shape
    tk, hk, _ = k.shape
    group = hq // hk
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    kf = k.to(compute_dtype).repeat_interleave(group, dim=1)
    vf = v.to(compute_dtype).repeat_interleave(group, dim=1)
    qf = q.to(compute_dtype)
    mask_t = torch.as_tensor(np.asarray(mask), dtype=torch.bool).to(q.device)
    m = torch.full((tq, hq), NEG_INF, dtype=compute_dtype, device=q.device)
    l = torch.zeros((tq, hq), dtype=compute_dtype, device=q.device)
    acc = torch.zeros((tq, hq, d), dtype=compute_dtype, device=q.device)
    for s0 in range(0, tk, block):
        s1 = min(s0 + block, tk)
        sblk = torch.einsum("qhd,khd->qhk", qf, kf[s0:s1]) * scale
        sblk = sblk.masked_fill(~mask_t[:, None, s0:s1], NEG_INF)
        m_new = torch.maximum(m, sblk.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        p = torch.exp(sblk - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("qhk,khd->qhd", p, vf[s0:s1])
        m = m_new
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-300)), NEG_INF)
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out, lse
