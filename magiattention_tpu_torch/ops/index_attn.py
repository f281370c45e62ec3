"""Index-list and sparse-load attention.

The counterpart of the JAX package's ``ops/index_attn.py``: attention over a
selected subset of the keys, chosen per q block (NSA-style top-k block
selection, :func:`index_attn_func`) or as global key ranges loaded into a
compact buffer (:func:`sparse_load_attn_func`). Neither needs a kernel of
its own:

- a per-q-block selection becomes a block mask for the block-sparse driver
  (``ops/block_sparse.py``), whose plan the kernel walks at its own tile;
- a range selection becomes the entry table's runs: the compact buffer is
  described by (local window, local -> global offset) runs, so the kernels
  evaluate the original global mask, causal against global positions
  included, on the compact buffer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .block_meta import FlexAttnBlockMeta, Run, build_block_meta_general


def index_block_mask(kv_block_indices, num_q_blocks: int, num_k_blocks: int) -> np.ndarray:
    """The [num_q_blocks, num_k_blocks] bool mask of a per-q-block selection
    (``kv_block_indices[i]`` lists the k blocks q block i attends; entries
    < 0 are padding). Raises on a row count or a block index out of range."""
    idx = np.asarray(kv_block_indices, dtype=np.int64)
    if idx.ndim != 2 or idx.shape[0] != num_q_blocks:
        raise ValueError(f"kv_block_indices has shape {idx.shape}: need [{num_q_blocks} q "
                         "blocks, topk]")
    bm = np.zeros((num_q_blocks, num_k_blocks), dtype=bool)
    for i in range(num_q_blocks):
        sel = idx[i][idx[i] >= 0]
        if (sel >= num_k_blocks).any():
            raise ValueError(f"kv_block_indices row {i} selects k block "
                             f"{int(sel.max())} of {num_k_blocks}")
        bm[i, sel] = True
    return bm


def index_attn_func(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,
    kv_block_indices: np.ndarray,  # [num_q_blocks, topk] host int, -1 = none
    *,
    causal: bool = False,
    block_q: int = 128,
    block_k: int = 128,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    head_block: int = 1,
):
    """Per-q-block k-block selection (NSA-style selected-block attention):
    q block i (of ``block_q`` rows) attends the k blocks (of ``block_k``
    keys) ``kv_block_indices[i]`` lists. The selection becomes a block mask
    for :func:`~.block_sparse.block_sparse_attn_func`. Differentiable in q,
    k, v and sink; returns (out [tq, hq, d], lse [tq, hq])."""
    from .block_sparse import block_sparse_attn_func

    tq, tk = int(q.shape[0]), int(k.shape[0])
    bm = index_block_mask(kv_block_indices, -(-tq // block_q), -(-tk // block_k))
    return block_sparse_attn_func(q, k, v, bm, causal=causal, scale=scale, softcap=softcap,
                                  sink=sink, out_dtype=out_dtype, block_q=block_q,
                                  block_k=block_k, head_block=head_block)


@functools.lru_cache(maxsize=64)
def _sparse_load_plan(ranges_b: bytes, n_ranges: int, tq: int, causal: bool, bq: int,
                      bk: int) -> tuple[np.ndarray, FlexAttnBlockMeta]:
    """(gather indices, the plan over the compact buffer) of the selected
    global k ranges (sorted here, disjoint), at the blocking (bq, bk)."""
    ranges = np.frombuffer(ranges_b, dtype=np.int64).reshape(n_ranges, 2)
    ranges = ranges[np.argsort(ranges[:, 0], kind="stable")]
    k_runs: list[Run] = []
    slices: list[tuple[int, int, int, int, int]] = []
    pos = 0
    for ks, ke in ranges.tolist():
        if ke <= ks:
            raise ValueError(f"sparse_load: empty selected range ({ks}, {ke})")
        if k_runs and ks < k_runs[-1].global_end:
            raise ValueError("sparse_load: the selected k ranges must be disjoint")
        k_runs.append(Run(local_start=pos, global_start=ks, length=ke - ks))
        pos += ke - ks
        if not causal:
            slices.append((0, tq, ks, ke, 0))
        # causal against GLOBAL positions, k <= q: the diagonal leaves the
        # range by its bottom or its right edge
        elif ks > tq - 1:
            continue  # wholly above the diagonal
        elif ke - 1 <= 0:
            slices.append((0, tq, ks, ke, 0))
        elif ke >= tq:
            slices.append((0, tq, ks, tq, 1))
        else:
            slices.append((0, ke, ks, ke, 1))
            slices.append((ke, tq, ks, ke, 0))
    gather = (np.concatenate([np.arange(ks, ke, dtype=np.int32) for ks, ke in ranges.tolist()])
              if len(ranges) else np.empty(0, np.int32))
    sl = np.asarray(slices, dtype=np.int64) if slices else np.empty((0, 5), dtype=np.int64)
    meta = build_block_meta_general(sl, [Run(0, 0, tq)],
                                    k_runs if k_runs else [Run(0, 0, max(pos, 1))], tq,
                                    max(pos, 1), block_q=bq, block_k=bk)
    return gather, meta


def sparse_load_plan(selected_k_ranges, tq: int, tk: int, head_dim: int, *,
                     causal: bool = False) -> tuple[np.ndarray, FlexAttnBlockMeta]:
    """(gather indices, the kernel-tile plan) :func:`sparse_load_attn_func`
    runs, checked and cached per unique selection."""
    from .flex_attn import resolve_tile

    ranges = np.ascontiguousarray(np.asarray(selected_k_ranges, dtype=np.int64).reshape(-1, 2))
    if ranges.shape[0] == 0:
        raise ValueError("sparse_load needs at least one k range")
    bad = (ranges[:, 0] < 0) | (ranges[:, 1] > tk)
    if bad.any():
        raise ValueError(f"selected k ranges must lie within [0, {tk}): got "
                         f"{ranges[bad].tolist()}")
    tile_q, tile_k = resolve_tile(head_dim, None, None)
    return _sparse_load_plan(ranges.tobytes(), int(ranges.shape[0]), int(tq), bool(causal),
                             tile_q, tile_k)


def sparse_load_attn_func(
    q: torch.Tensor,  # [tq, hq, d]
    k: torch.Tensor,  # [tk, hk, d]
    v: torch.Tensor,
    selected_k_ranges,  # [R, 2] host ranges of global k rows to load
    *,
    causal: bool = False,
    scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
    head_block: int = 1,
):
    """Sparse-load attention: gather the selected global k ranges into a
    compact K/V buffer and attend it. The mask, ``causal`` against global
    positions (k <= q) included, is evaluated on the compact buffer through
    the entry table's runs, so no dense-length buffer is built; the plan is
    built at the kernel tile. Differentiable in q, k, v and sink (the gather
    carries the k/v gradients back); returns (out [tq, hq, d], lse [tq, hq])."""
    from .flex_attn import flex_attn_with_meta

    gather, meta = sparse_load_plan(selected_k_ranges, int(q.shape[0]), int(k.shape[0]),
                                    int(q.shape[2]), causal=causal)
    idx = torch.from_numpy(gather).to(device=k.device, dtype=torch.long)
    return flex_attn_with_meta(q, k.index_select(0, idx), v.index_select(0, idx), meta,
                               scale=scale, softcap=softcap, sink=sink, out_dtype=out_dtype,
                               head_block=head_block)
