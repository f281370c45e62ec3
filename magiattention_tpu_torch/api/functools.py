"""Mask-construction and padding helpers, the port of the JAX package's
``api/functools.py``.

Pure host-side utilities that turn common training-data descriptions
(batches, cu_seqlens, segment ids, a right-padded [batch, seq] attention
mask, sliding windows) into (q_ranges, k_ranges, mask types), plus padding
helpers on tensors for the chunked layout.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..common.enum import AttnMaskType
from ..common.ranges import AttnRanges


def compute_pad_size(total_seqlen_q: int, cp_size: int, chunk_size: int) -> int:
    """Tokens to append so the sequence splits into whole chunks per rank."""
    block = cp_size * chunk_size
    return (-total_seqlen_q) % block


def pad_at_dim(x: torch.Tensor, dim: int, pad_size: int, value: float = 0.0) -> torch.Tensor:
    """``x`` with ``pad_size`` entries of ``value`` appended along ``dim``."""
    if pad_size <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad_size
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def unpad_at_dim(x: torch.Tensor, dim: int, orig_size: int) -> torch.Tensor:
    """The first ``orig_size`` entries of ``x`` along ``dim``."""
    return x.narrow(dim, 0, orig_size)


def apply_padding(q_ranges: AttnRanges, k_ranges: AttnRanges,
                  attn_mask_type: Sequence[AttnMaskType], total_seqlen: int, pad_size: int):
    """The mask over ``pad_size`` appended tokens: pad rows attend nothing
    (no new slices; the kernels give out=0 / lse=-inf there). Returns
    (q_ranges, k_ranges, types, padded total)."""
    return q_ranges, k_ranges, list(attn_mask_type), total_seqlen + pad_size


def squash_batch_dim(x: torch.Tensor) -> torch.Tensor:
    """[b, s, ...] -> [b * s, ...], token-major packing."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _host_array(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def full_attention_mask(total_seqlen: int):
    q = AttnRanges.from_ranges([(0, total_seqlen)])
    return q, q.clone(), [AttnMaskType.FULL]


def infer_varlen_mask_from_batch(batch_seqlens: Sequence[int], causal: bool = True):
    """Per-sample (self-)attention ranges from a list of sample lengths."""
    cu = np.concatenate([[0], np.cumsum(np.asarray(batch_seqlens))])
    return infer_attn_mask_from_cu_seqlens(cu.tolist(), causal=causal)


def infer_attn_mask_from_segment_ids(segment_ids, causal: bool = True):
    """Slices of a segment-id vector [t] or batch [b, s] (the convention of
    flash attention's ``segment_ids``): each maximal run of one id in a row
    is a sample; ids < 0 mark pad rows that attend nothing. Runs never
    merge across batch rows (row ``i`` is offset by ``i * s`` into the
    squashed [b * s] coordinates)."""
    seg = _host_array(segment_ids)
    if seg.ndim not in (1, 2):
        raise ValueError(f"segment_ids must be [t] or [b, s], got shape {seg.shape}")
    rows = seg[None, :] if seg.ndim == 1 else seg
    s = rows.shape[1]
    ranges = []
    for i, row in enumerate(rows):
        if s == 0:
            continue
        starts = np.concatenate(([0], np.flatnonzero(np.diff(row) != 0) + 1, [s]))
        ranges.extend((i * s + int(a), i * s + int(b)) for a, b in zip(starts, starts[1:])
                      if row[a] >= 0)
    q = AttnRanges.from_ranges(ranges)
    mt = AttnMaskType.CAUSAL if causal else AttnMaskType.FULL
    return q, q.clone(), [mt] * len(q)


def infer_varlen_mask_from_padded_batch(attention_mask, causal: bool = True):
    """Slices of a right-padded [batch, seq] 0/1 attention mask (the
    Hugging Face convention), for use after :func:`squash_batch_dim`:
    sample ``i`` holds rows ``[i * s, i * s + valid_i)``; pad rows attend
    nothing. A row with a hole is refused: it is not one varlen sample."""
    am = _host_array(attention_mask)
    if am.ndim != 2:
        raise ValueError(f"attention_mask must be [batch, seq], got shape {am.shape}")
    b, s = am.shape
    lens = am.astype(bool).sum(axis=1)
    for i in range(b):
        if not am[i, : lens[i]].all():
            raise ValueError(f"attention_mask row {i} is not right-padded (holes are not "
                             "expressible as one varlen sample); build explicit ranges instead")
    q = AttnRanges.from_ranges([(i * s, i * s + int(n)) for i, n in enumerate(lens) if n > 0])
    mt = AttnMaskType.CAUSAL if causal else AttnMaskType.FULL
    return q, q.clone(), [mt] * len(q)


def infer_window_mask_per_range(
    q_range: Sequence[int],
    k_range: Sequence[int],
    window_size: tuple[int, int],
    global_window_size: int = 0,
):
    """Decompose one bidirectional sliding-window region into exact slices.

    The same decomposition as the JAX package's helper of this name, in
    the slice conventions of ``common/mask.py``.

    Semantics (flash-attn window convention, bottom-right aligned): with
    ``Lq = min(len(q_range), len(k_range))`` valid trailing query rows
    (earlier rows attend nothing), row ``r`` sits at key-local position
    ``pk = Lk - Lq + r`` and attends keys ``[pk - wl, pk + wr]``
    intersected with the key range; ``-1`` means unbounded on that side.
    ``global_window_size`` additionally lets every row attend the first
    ``G`` keys of the range, capped at ``pk - wl`` per row so no key ahead
    of the row's own window leaks in (reference leakage guard
    ``min(G, i + wr + 1)`` — the two caps coincide because the band
    already covers ``[pk - wl, pk + wr]``).

    The band is at most three slices — a CAUSAL head while the lower edge
    clips at the range start, a BICAUSAL (or FULL, when the window spans
    the whole range) middle, an INVCAUSAL tail while the upper edge clips
    at the range end — plus at most two more for the global prefix.
    """
    qs, qe = int(q_range[0]), int(q_range[1])
    ks, ke = int(k_range[0]), int(k_range[1])
    lk = ke - ks
    lq = min(qe - qs, lk)
    out_q, out_k, out_t = [], [], []
    if lq <= 0 or lk <= 0:
        return out_q, out_k, out_t
    q0 = qe - lq  # first valid query row (global)
    wl, wr = window_size
    wl = lk if (wl == -1 or wl >= lk - 1) else int(wl)
    wr = lk if (wr == -1 or wr >= lk - 1) else int(wr)
    assert wl >= 0 and wr >= 0, f"bad window {window_size}"
    # key-local visible interval of row r: [max(0, a + r), min(lk, b + r))
    a = lk - lq - wl
    b = lk - lq + wr + 1

    def clamp(x, lo, hi):
        return max(lo, min(x, hi))

    r1 = clamp(-a, 0, lq)  # rows below r1: lower edge clipped to 0
    r2 = clamp(lk - b + 1, 0, lq)  # rows from r2 on: upper edge clipped

    def emit(r_lo, r_hi, k_lo, k_hi, mt):
        if r_hi > r_lo and k_hi > k_lo:
            out_q.append((q0 + r_lo, q0 + r_hi))
            out_k.append((ks + k_lo, ks + k_hi))
            out_t.append(mt)

    if r1 <= r2:
        # causal head: rows [max(0, 1-b), r1), keys [0, b + r - 1 .. )
        ra = clamp(1 - b, 0, r1)
        emit(ra, r1, 0, b + r1 - 1, AttnMaskType.CAUSAL)
        emit(r1, r2, a + r1, b + r2 - 1, AttnMaskType.BICAUSAL)
        emit(r2, lq, a + r2, lk, AttnMaskType.INVCAUSAL)
    else:
        ra = clamp(1 - b, 0, r2)
        emit(ra, r2, 0, b + r2 - 1, AttnMaskType.CAUSAL)
        emit(r2, r1, 0, lk, AttnMaskType.FULL)
        emit(r1, lq, a + r1, lk, AttnMaskType.INVCAUSAL)

    g = min(int(global_window_size), lk)
    if g > 0:
        # extra prefix for rows whose band lower edge is past the start:
        # row r adds keys [0, min(g, a + r)) — the a + r cap subsumes the
        # reference's min(G, pk + wr + 1) guard since a < b
        rg0 = clamp(max(r1, 1 - a), 0, lq)
        rg1 = clamp(g - a, rg0, lq)
        emit(rg0, rg1, 0, a + rg1 - 1, AttnMaskType.CAUSAL)
        emit(rg1, lq, 0, g, AttnMaskType.FULL)
    return out_q, out_k, out_t


def infer_attn_mask_from_cu_seqlens(
    cu_seqlens: Sequence[int],
    causal: bool = True,
    *,
    cu_seqlens_k: Sequence[int] | None = None,
    window_size: tuple[int, int] = (-1, -1),
    global_window_size: int = 0,
):
    """(q_ranges, k_ranges, types) for a packed varlen batch.

    ``cu_seqlens_k`` supports varlen cross-attention (per-sample q/k
    lengths may differ);
    ``window_size=(left, right)`` applies a bidirectional sliding window
    per sample (requires ``causal=False``), optionally with
    ``global_window_size`` leading keys per sample. Returns the 3-tuple
    only — totals are ``cu_seqlens[-1]`` / ``cu_seqlens_k[-1]``, which the
    caller already has. ``causal`` defaults True."""
    cu_q = [int(c) for c in cu_seqlens]
    cu_k = cu_q if cu_seqlens_k is None else [int(c) for c in cu_seqlens_k]
    assert len(cu_q) == len(cu_k), "cu_seqlens_q/k must pair samples"
    for name, cu in (("cu_seqlens", cu_q), ("cu_seqlens_k", cu_k)):
        if cu[0] != 0 or any(a > b for a, b in zip(cu, cu[1:])):
            raise ValueError(
                f"invalid {name}: must start at 0 and be non-decreasing, "
                f"got {cu}"
            )
    if tuple(window_size) == (-1, -1):
        assert global_window_size == 0, (
            "global_window_size needs a bounded window_size"
        )
        q = AttnRanges.from_ranges(list(zip(cu_q[:-1], cu_q[1:])))
        k = AttnRanges.from_ranges(list(zip(cu_k[:-1], cu_k[1:])))
        mt = AttnMaskType.CAUSAL if causal else AttnMaskType.FULL
        return q, k, [mt] * len(q)
    assert not causal, (
        f"causal must be False with a bounded window, got {window_size=}"
    )
    qr, kr, ts = [], [], []
    for qs, qe, ks, ke in zip(cu_q, cu_q[1:], cu_k, cu_k[1:]):
        sq, sk, st = infer_window_mask_per_range(
            (qs, qe), (ks, ke), tuple(window_size), global_window_size
        )
        qr.extend(sq)
        kr.extend(sk)
        ts.extend(st)
    return (
        AttnRanges.from_ranges(qr),
        AttnRanges.from_ranges(kr),
        ts,
    )


def infer_attn_mask_from_sliding_window(total_seqlen: int, window_size: int, causal: bool = True,
                                        global_tokens: int = 0):
    """Causal sliding-window attention as slices: row q attends keys
    [q - window_size + 1, q] (and the first ``global_tokens`` keys):
    :func:`infer_window_mask_per_range` with ``window = (window_size - 1,
    0)``, at most five slices. For a bidirectional window use that helper
    or ``infer_attn_mask_from_cu_seqlens(window_size=(l, r))``."""
    if not causal:
        raise ValueError("for a bidirectional sliding window use infer_window_mask_per_range "
                         "or infer_attn_mask_from_cu_seqlens(window_size=(l, r))")
    if window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size} (a 0-wide window would "
                         "collide with the -1 'unbounded' sentinel)")
    qr, kr, ts = infer_window_mask_per_range((0, total_seqlen), (0, total_seqlen),
                                             (window_size - 1, 0), global_tokens)
    return AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr), ts
