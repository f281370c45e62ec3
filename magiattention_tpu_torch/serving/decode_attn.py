"""Split-KV decode attention over the paged cache.

One query token per sequence attends over its whole paged history. Each of
``num_splits`` KV splits computes a partial ``(out, lse)`` masked to the
sequence's true length, and the partials merge with the associative
LSE-corrected reduction of ``ops/correction.py`` — the JAX package's
``serving/decode_attn.py`` design.

Where it runs follows its tensors: on CUDA the ``paged_decode`` kernel
(``csrc/decode.cu``) computes every split's partial in one launch; on the
CPU the plain version :func:`_decode_torch` gathers each split's pages and
computes the same partials densely. A split with no coverage (the sequence
ends before it starts) reports ``(out=0, lse=-inf)`` and merges as a no-op.

Split-count resolution: explicit argument > ``MAGI_ATTENTION_DECODE_SPLITS``
> the Hopper heuristic of :func:`resolve_num_splits`, always clamped to a
divisor of the block-table width.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import csrc
from ..ops.correction import merge_partials
from ..ops.flex_attn import on_card
from .kv_cache import PagedKVCache

NEG_INF = float("-inf")

# the kernel's build and limits (csrc/decode.cu)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_MAX_GROUP = 8
# SMs of an H100 SXM: the split heuristic's target parallelism
HOPPER_SMS = 132


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """Static decode parameters."""

    scale: float
    softcap: float
    num_splits: int
    out_dtype: torch.dtype


def _split_partial_torch(q, k, v, pos0: int, valid_len, scale: float, softcap: float):
    """One KV split's partial (out, lse), plain torch.

    q [b, hq, d]; k/v [b, L, hk, d] (this split's gathered tokens, at global
    positions pos0 + arange(L)); valid_len [b] true lengths. Returns (out
    [b, hq, d] f32, lse [b, hq] f32) with the uncovered convention (0, -inf).
    """
    b, hq, d = q.shape
    hk = k.shape[2]
    group = hq // hk
    L = k.shape[1]
    qr = q.float().reshape(b, hk, group, d)
    z = torch.einsum("bhgd,blhd->bhgl", qr, k.float()) * scale
    if softcap > 0.0:
        z = softcap * torch.tanh(z / softcap)
    pos = pos0 + torch.arange(L, device=q.device)
    mask = pos[None, :] < valid_len[:, None].long()  # [b, L]
    s = z.masked_fill(~mask[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)  # [b, hk, g]
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgl,blhd->bhgd", p, v.float())
    covered = l > 0.0
    inv = torch.where(covered, 1.0 / torch.where(covered, l, 1.0), 0.0)
    out = (acc * inv[..., None]).reshape(b, hq, d)
    lse = torch.where(
        covered, m_safe + torch.log(torch.where(covered, l, 1.0)), NEG_INF
    ).reshape(b, hq)
    return out, lse


def _decode_torch(q, cache: PagedKVCache, bt, seq_lens, params: DecodeParams):
    """Plain version: gather each split's pages densely, compute its partial,
    tree-merge. ``bt`` [b, W] / ``seq_lens`` [b] are the batch's
    block-table rows and true lengths. Returns f32 (out [b, hq, d], lse
    [b, hq])."""
    b = q.shape[0]
    ps = cache.page_size
    s = params.num_splits
    pps = bt.shape[1] // s
    outs, lses = [], []
    for i in range(s):
        pages = bt[:, i * pps : (i + 1) * pps].long()  # [b, pps]
        shape = (b, pps * ps, cache.num_kv_heads, cache.head_dim)
        k = cache.k_pages[pages].reshape(shape)
        v = cache.v_pages[pages].reshape(shape)
        o, l = _split_partial_torch(
            q, k, v, i * pps * ps, seq_lens, params.scale, params.softcap
        )
        outs.append(o)
        lses.append(l)
    return merge_partials(outs, lses)


def _decode_partials_kernel(q, cache: PagedKVCache, bt, seq_lens, params: DecodeParams):
    """The ``paged_decode`` Hopper kernel: every split's partial in one
    launch. Returns (out_parts [b, s, hq, d] f32, lse_parts [b, s, hq] f32).
    Raises on what the kernel does not take."""
    b, hq, d = q.shape
    hk = cache.num_kv_heads
    if q.requires_grad:
        raise NotImplementedError(
            "paged_decode has no backward, as the TPU decode kernel has none: "
            "decode serves, it does not train; pass a tensor that does not "
            "require grad"
        )
    if cache.k_pages.dtype not in KERNEL_DTYPES or q.dtype != cache.k_pages.dtype:
        raise TypeError(
            f"paged_decode takes q and pages of one dtype in {KERNEL_DTYPES}; "
            f"got q {q.dtype}, pages {cache.k_pages.dtype}"
        )
    if d not in KERNEL_HEAD_DIMS or hq // hk > KERNEL_MAX_GROUP:
        raise ValueError(
            f"paged_decode is built for head_dim in {KERNEL_HEAD_DIMS} and at "
            f"most {KERNEL_MAX_GROUP} q heads per kv head; got head_dim {d}, "
            f"{hq // hk}"
        )
    s = params.num_splits
    mpp = bt.shape[1]
    q = q.contiguous()
    bt = bt.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    out_parts = torch.empty((b, s, hq, d), dtype=torch.float32, device=q.device)
    lse_parts = torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
    csrc.launch(
        "paged_decode",
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        bt.data_ptr(), seq_lens.data_ptr(),
        out_parts.data_ptr(), lse_parts.data_ptr(),
        b, hq, hk, d, cache.page_size, mpp, s,
        int(q.dtype == torch.float32), float(params.scale), float(params.softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out_parts, lse_parts


def _decode(q, cache: PagedKVCache, bt, seq_lens, params: DecodeParams):
    """Split-KV decode where the tensors are: f32 (out [b, hq, d], lse [b, hq])."""
    if not on_card(q, cache.k_pages, bt):
        return _decode_torch(q, cache, bt, seq_lens, params)
    out_parts, lse_parts = _decode_partials_kernel(q, cache, bt, seq_lens, params)
    s = params.num_splits
    return merge_partials(
        [out_parts[:, i] for i in range(s)], [lse_parts[:, i] for i in range(s)]
    )


def _clamp_splits(num_splits: int, width: int) -> int:
    """Largest divisor of the table width not above the ask (at least 1)."""
    width = max(int(width), 1)
    n = max(1, min(int(num_splits), width))
    while width % n:
        n -= 1
    return n


def resolve_num_splits(
    num_splits: int | None,
    cache: PagedKVCache,
    batch: int,
    *,
    mpp: int | None = None,
) -> int:
    """Explicit arg > ``MAGI_ATTENTION_DECODE_SPLITS`` > a Hopper heuristic,
    clamped to a divisor of the table width: ``max_pages_per_seq``, or an
    explicit ``mpp`` (the cascade resolves each phase on its own table:
    the shared prefix's pages, then each member's suffix pages).

    The heuristic, a first guess in place of the JAX package's tuner: the
    kernel runs one thread block per (sequence, split, kv head), so ask for
    enough splits that ``batch * kv_heads * splits`` covers the card's 132
    SMs twice. It cannot see the sequences' lengths; splits past a
    sequence's end cost one empty thread block each and merge as no-ops.
    """
    from .. import env

    if num_splits is None:
        num_splits = env.decode_splits()
    if num_splits is None:
        blocks = max(int(batch), 1) * cache.num_kv_heads
        num_splits = -(-2 * HOPPER_SMS // blocks)
    return _clamp_splits(num_splits, cache.max_pages_per_seq if mpp is None else mpp)


def _check_q(q, cache: PagedKVCache, where: str) -> None:
    b, hq, d = q.shape
    if d != cache.head_dim or hq % cache.num_kv_heads:
        raise ValueError(
            f"{where}: q {tuple(q.shape)} is incompatible with the cache's "
            f"[pages={cache.num_pages}, page_size={cache.page_size}, "
            f"kv_heads={cache.num_kv_heads}, head_dim={cache.head_dim}] "
            f"layout: need head_dim {d} == {cache.head_dim} and hq {hq} "
            f"divisible by kv_heads {cache.num_kv_heads}"
        )


def decode_partials_for_tables(
    q: torch.Tensor,  # [b, hq, head_dim]
    cache: PagedKVCache,
    bt: torch.Tensor,  # [b, W] page-id rows (any width W >= 1)
    seq_lens: torch.Tensor,  # [b] covered tokens WITHIN these tables
    *,
    num_splits: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-KV attention over EXPLICIT page tables (positions are
    table-relative). Returns f32 ``(out [b, hq, d], lse [b, hq])`` in the
    uncovered convention (rows with ``seq_lens == 0`` are ``(0, -inf)``)."""
    _check_q(q, cache, "decode_partials_for_tables")
    d = q.shape[2]
    params = DecodeParams(
        scale=float(scale if scale is not None else 1.0 / math.sqrt(d)),
        softcap=float(softcap),
        num_splits=_clamp_splits(num_splits, bt.shape[1]),
        out_dtype=torch.float32,
    )
    return _decode(q, cache, bt, seq_lens.to(torch.int32), params)


def decode_reference(
    q: torch.Tensor,  # [b, hq, head_dim]
    cache: PagedKVCache,
    bt: torch.Tensor,  # [b, W] page-id rows
    seq_lens: torch.Tensor,  # [b] true lengths within these tables
    *,
    scale: float | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-split f32 plain decode over explicit tables, on any device —
    the oracle the kernel is held against. Returns f32 ``(out [b, hq, d],
    lse [b, hq])``."""
    b, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    W = bt.shape[1]
    shape = (b, W * cache.page_size, cache.num_kv_heads, cache.head_dim)
    k = cache.k_pages[bt.long()].reshape(shape)
    v = cache.v_pages[bt.long()].reshape(shape)
    return _split_partial_torch(q, k, v, 0, seq_lens, float(scale), float(softcap))


def decode_attn_paged(
    q: torch.Tensor,  # [b, hq, head_dim] one query token per sequence
    cache: PagedKVCache,
    slots: torch.Tensor,  # [b] int cache slots
    *,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-KV decode attention over the paged cache.

    Each query attends to its sequence's first ``seq_lens[slot]`` cached
    tokens (append the step's own KV first for standard causal decode).
    Returns ``(out [b, hq, head_dim] in out_dtype, lse [b, hq] f32)``.
    """
    _check_q(q, cache, "decode_attn_paged")
    b, hq, d = q.shape
    params = DecodeParams(
        scale=float(scale if scale is not None else 1.0 / math.sqrt(d)),
        softcap=float(softcap),
        num_splits=resolve_num_splits(num_splits, cache, b),
        out_dtype=out_dtype if out_dtype is not None else q.dtype,
    )
    slots = slots.to(device=cache.device, dtype=torch.long)
    bt = cache.block_tables[slots]  # [b, MPP]
    seq_lens = cache.seq_lens[slots]  # [b]
    out, lse = _decode(q, cache, bt, seq_lens, params)
    return out.to(params.out_dtype), lse
