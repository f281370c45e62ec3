"""Attention-sink wrapper for standard (single-device) attention.

The counterpart of the JAX package's ``extensions/sink_attention.py``: a
drop-in for a batched flash-attention call that adds learned attention
sinks (GPT-OSS / StreamingLLM style), in the three layouts of
``ops/correction.py``:

- ``sh``: [seqlen_sink, hq] (or [hq]) logits shared by every row;
- ``ssh``: [b, sq, seqlen_sink, hq] (or [sq, seqlen_sink, hq]) per-row logits;
- ``shd``: [seqlen_sink, hq, d] zero-logit sinks that carry a value.

One logit per head (``sh`` as [hq] or [1, hq]) rides the kernels' own sink;
the other layouts run the kernels without one and fold the sink in after
(``correct_attn_out_lse_with_sink``, differentiable). The batch runs as one
packed call: each sequence's slices are offset onto its own rows of the
[b * s] token axis, so one launch serves the batch where a loop over it
would launch b times (the JAX package gets its one launch from vmap). The
kernel configuration is what ``auto_kernel_config`` picks for one
sequence's mask, as each of the JAX package's per-sequence calls picks it.
"""

from __future__ import annotations

import torch

from ..ops.correction import correct_attn_out_lse_with_sink
from ..ops.flex_attn import auto_kernel_config, flex_flash_attn_func


def flash_attention_with_sink(
    q: torch.Tensor,  # [batch, seqlen, hq, d]
    k: torch.Tensor,  # [batch, seqlen, hk, d]
    v: torch.Tensor,
    sink: torch.Tensor,
    *,
    sink_layout: str = "sh",
    causal: bool = False,
    window: int | None = None,  # causal sliding window of this many keys
    softcap: float = 0.0,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Batched attention with attention sinks, differentiable in q, k, v and
    sink. ``window`` gives causal sliding-window attention
    (``api.functools.infer_attn_mask_from_sliding_window``). A zero ``sh``
    sink of one token is plain attention with one more term in the
    denominator; a zero ``shd`` sink of one token is softmax-off-by-one.
    Returns out [b, s, hq, d], and lse [b, s, hq] with ``return_lse``."""
    if q.ndim != 4:
        raise ValueError(f"flash_attention_with_sink expects q as [b, s, h, d], got "
                         f"{tuple(q.shape)}")
    b, t, hq, d = q.shape
    hk = k.shape[2]
    _check_sink_layout(sink, sink_layout, b, t, hq, d)
    if window is not None:
        from ..api.functools import infer_attn_mask_from_sliding_window

        qr, kr, ts = infer_attn_mask_from_sliding_window(t, window)
        qr, kr, ts = qr.to_naive_ranges(), kr.to_naive_ranges(), [int(x) for x in ts]
    else:
        qr, kr, ts = [(0, t)], [(0, t)], [1 if causal else 0]
    # one logit per head: the kernels' own sink
    kernel_sink = None
    if sink_layout == "sh" and (sink.ndim == 1 or sink.shape[0] == 1):
        kernel_sink = sink.reshape(hq)
    bq, bk, hb, grid = auto_kernel_config(qr, kr, hq, hk, attn_type_map=ts, head_dim=d)
    pqr = [(s + i * t, e + i * t) for i in range(b) for s, e in qr]
    pkr = [(s + i * t, e + i * t) for i in range(b) for s, e in kr]
    out, lse = flex_flash_attn_func(
        q.reshape(b * t, hq, d), k.reshape(b * t, hk, d), v.reshape(b * t, hk, d), pqr, pkr,
        ts * b, scale=scale, softcap=softcap, sink=kernel_sink, block_q=bq, block_k=bk,
        head_block=hb, grid=grid)
    if kernel_sink is None:
        rows = sink
        if sink_layout == "ssh":  # per-row logits, one row of them per token of the batch
            rows = (sink if sink.ndim == 4 else sink[None].expand(b, *sink.shape))
            rows = rows.reshape(b * t, *sink.shape[-2:])
        out, lse = correct_attn_out_lse_with_sink(out, lse, rows, sink_layout)
    out, lse = out.reshape(b, t, hq, d), lse.reshape(b, t, hq)
    return (out, lse) if return_lse else out


def _check_sink_layout(sink: torch.Tensor, sink_layout: str, b: int, t: int, hq: int,
                       d: int) -> None:
    """Raise ``ValueError`` on a sink whose shape the layout does not take
    (the JAX ``_check_sink_layout``)."""
    if sink_layout == "sh":
        ok = tuple(sink.shape) == (hq,) or (sink.ndim == 2 and sink.shape[1] == hq)
    elif sink_layout == "ssh":
        ok = ((sink.ndim == 4 and sink.shape[0] == b and sink.shape[1] == t
               and sink.shape[3] == hq)
              or (sink.ndim == 3 and sink.shape[0] == t and sink.shape[2] == hq))
    elif sink_layout == "shd":
        ok = sink.ndim == 3 and sink.shape[1] == hq and sink.shape[2] == d
    else:
        raise ValueError(f"Invalid sink_layout {sink_layout!r}")
    if not ok:
        raise ValueError(f"{sink_layout!r} sink shape {tuple(sink.shape)} invalid for "
                         f"(b={b}, t={t}, hq={hq}, d={d})")
