"""Context-parallel decode: merge per-rank split-KV partials across a
process group.

The counterpart of the JAX package's ``serving/cp_decode.py``. When a
sequence's KV history was dispatched across cp ranks, each rank holds a
contiguous shard of it in its local paged cache, and decode runs two layers
of the same associative reduction (``ops/correction``):

1. on each rank, :func:`~.decode_attn.decode_attn_paged` over its shard
   (the ``paged_decode`` kernel on the card) in float32;
2. across ranks, ``comm.primitives.all_gather_v`` of every rank's partial
   and the log-depth ``merge_partials`` tree.

A rank whose shard holds nothing for a sequence (slot length 0) contributes
``(0, -inf)`` and drops out of the merge exactly. ``cp_size == 1`` builds
no collective. The gather is an all-gather (gloo takes CUDA tensors for it;
no send/recv).
"""

from __future__ import annotations

import torch

from ..comm.primitives import all_gather_v
from ..ops.correction import merge_partials
from ..utils.instrument import named_scope
from .decode_attn import decode_attn_paged
from .kv_cache import PagedKVCache


def cp_merge_partials(
    out: torch.Tensor,  # [b, hq, d] this rank's partial (f32)
    lse: torch.Tensor,  # [b, hq] f32
    *,
    group,
    cp_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LSE-weighted tree reduce of the ranks' decode partials over
    ``group``; every rank returns the merged ``(out, lse)``."""
    if cp_size == 1:
        return out, lse
    b = out.shape[0]
    with named_scope("magi_cp_decode_gather"):
        flat_o = all_gather_v(out, [b] * cp_size, group)
        flat_l = all_gather_v(lse, [b] * cp_size, group)
    outs = [flat_o[r * b:(r + 1) * b] for r in range(cp_size)]
    lses = [flat_l[r * b:(r + 1) * b] for r in range(cp_size)]
    with named_scope("magi_cp_decode_merge"):
        return merge_partials(outs, lses)


def cp_decode_attn(
    q: torch.Tensor,  # [b, hq, head_dim], the same on every rank
    local_cache: PagedKVCache,  # this rank's KV shard
    slots: torch.Tensor,  # [b] slots into the local cache
    *,
    group,
    cp_size: int,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Context-parallel decode: local split-KV attention over this rank's
    shard (``local_cache.seq_lens[slot]`` = the tokens it holds), then the
    cross-rank merge. Returns ``(out [b, hq, d] in out_dtype (q's by
    default), lse [b, hq] f32)`` on every rank."""
    out, lse = decode_attn_paged(q, local_cache, slots, num_splits=num_splits, scale=scale,
                                 softcap=softcap, out_dtype=torch.float32)
    out, lse = cp_merge_partials(out, lse, group=group, cp_size=cp_size)
    return out.to(out_dtype if out_dtype is not None else q.dtype), lse
