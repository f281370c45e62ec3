"""DSA-style top-k sparse attention (DeepSeek Sparse Attention's shape).

The counterpart of the JAX package's ``extensions/dsa.py``: a cheap indexer
scores candidate key regions for each query block, the top-k survive, and
attention runs over the selection only. The indexer works at (block_q x
block_k) tile granularity: mean-pooled q and k block embeddings score the
tiles, and each q block keeps its top-k k blocks, which drive
``ops.index_attn.index_attn_func`` (the block-sparse driver, on the flex
kernels). The plan is built on the host, so the selection is a host value
(one small [num_q_blocks, topk] copy from the device) and each distinct
selection plans once (cached): a selection made once per sequence and
reused across layers or steps (``kv_block_indices=``) plans once.
"""

from __future__ import annotations

import numpy as np
import torch


def dsa_topk_blocks(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    topk: int,
    *,
    block_q: int = 128,
    block_k: int = 128,
    causal: bool = True,
) -> np.ndarray:
    """The indexer: score (q-block, k-block) tiles by the dot product of the
    blocks' mean-pooled embeddings (over tokens and heads, zero-padded
    tokens included, in float32 on the tensors' device) and keep the
    ``topk`` best k blocks of each q block.

    Returns host int64 [num_q_blocks, topk], -1 where fewer than ``topk``
    blocks are visible. Under ``causal`` (bottom-right, ``k <= q + tk -
    tq``) the k blocks wholly above a q block's last row are invisible and
    its diagonal block is always kept, unless the q block sees no key."""
    tq, hq, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    nq, nk = -(-tq // block_q), -(-tk // block_k)
    qp = torch.nn.functional.pad(q.float(), (0, 0, 0, 0, 0, nq * block_q - tq))
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, nk * block_k - tk))
    qb = qp.reshape(nq, block_q, hq, d).mean(dim=(1, 2))  # [nq, d]
    kb = kp.reshape(nk, block_k, hk, d).mean(dim=(1, 2))  # [nk, d]
    s = (qb @ kb.T).cpu().numpy()  # [nq, nk]
    if causal:
        q_hi = np.minimum((np.arange(nq) + 1) * block_q, tq) - 1 + (tk - tq)
        s[np.arange(nk)[None, :] * block_k > q_hi[:, None]] = -np.inf
        sees = q_hi >= 0  # a q block that sees no key keeps no diagonal block
        s[np.flatnonzero(sees), np.minimum(q_hi[sees] // block_k, nk - 1)] = np.inf
    kk = min(topk, nk)
    idx = np.argsort(-s, axis=1)[:, :kk]
    sel = np.where(np.take_along_axis(s, idx, axis=1) == -np.inf, -1, idx).astype(np.int64)
    if kk < topk:
        sel = np.pad(sel, ((0, 0), (0, topk - kk)), constant_values=-1)
    return sel


def dsa_attn_func(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,
    *,
    topk: int,
    causal: bool = True,
    kv_block_indices: np.ndarray | None = None,  # a selection to reuse
    block_q: int = 128,
    block_k: int = 128,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
):
    """Top-k block-sparse attention: indexer -> selection -> the
    block-sparse kernels. Pass ``kv_block_indices`` to reuse a selection
    across layers or steps; otherwise the indexer runs on this call's (q,
    k). Differentiable in q, k, v and sink (not through the selection).
    Returns (out [tq, hq, d], lse [tq, hq])."""
    from ..ops.index_attn import index_attn_func

    if kv_block_indices is None:
        kv_block_indices = dsa_topk_blocks(q.detach(), k.detach(), topk, block_q=block_q,
                                           block_k=block_k, causal=causal)
    return index_attn_func(q, k, v, kv_block_indices, causal=causal, block_q=block_q,
                           block_k=block_k, scale=scale, softcap=softcap, sink=sink,
                           out_dtype=out_dtype)
