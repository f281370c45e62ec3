"""Sample packing: variable-length documents -> fixed token-budget streams.

The port's copy of the JAX package's ``utils/packing.py`` (numpy only).
Real corpora need the step before the varlen mask: packing documents of
uneven length into fixed ``capacity``-token streams, so that every stream
is keyed once (the cu_seqlens list is the mask) and has one static shape.
Packing is deterministic; truncation and padding policies are explicit.

Typical use::

    bins = pack_documents(doc_lens, capacity=total)
    for b in bins:
        cu = bin_cu_seqlens(b, doc_lens, capacity=total)
        key = magi_attn_varlen_key(cu, total, cp_group, ...)
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np


def pack_documents(
    doc_lengths: Sequence[int],
    capacity: int,
    *,
    truncate_oversized: bool = True,
) -> list[list[int]]:
    """First-fit-decreasing bin packing of document indices into
    ``capacity``-token streams.

    Returns the bins, each a list of document indices in decreasing
    length (the mask is permutation-invariant, so the order only affects
    locality). Documents longer than ``capacity`` are truncated to fit
    when ``truncate_oversized`` (they still take a bin of their own), else
    raise.
    """
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    order = sorted(range(len(doc_lengths)), key=lambda i: -int(doc_lengths[i]))
    bins: list[list[int]] = []
    space: list[int] = []
    for i in order:
        ln = int(doc_lengths[i])
        if ln <= 0:
            continue
        if ln > capacity:
            if not truncate_oversized:
                raise ValueError(f"document {i} ({ln} tokens) exceeds capacity {capacity}")
            bins.append([i])
            space.append(0)
            continue
        for b, free in enumerate(space):
            if free >= ln:
                bins[b].append(i)
                space[b] = free - ln
                break
        else:
            bins.append([i])
            space.append(capacity - ln)
    return bins


def bin_cu_seqlens(
    bin_docs: Sequence[int],
    doc_lengths: Sequence[int],
    capacity: int,
    *,
    pad_as_doc: bool = True,
) -> list[int]:
    """Cumulative boundaries of one packed stream, clamped to capacity.

    With ``pad_as_doc`` the tail padding becomes one final document (its
    tokens attend only each other; label them -100 so the loss masks
    them), keeping the stream length static at ``capacity``.
    """
    cu = [0]
    for i in bin_docs:
        if int(doc_lengths[i]) <= 0:
            continue  # an empty document: no boundary, later ones still packed
        if cu[-1] >= capacity:
            break  # capacity exhausted
        ln = min(int(doc_lengths[i]), capacity - cu[-1])
        cu.append(cu[-1] + ln)
    if pad_as_doc and cu[-1] < capacity:
        cu.append(capacity)
    return cu


def packing_efficiency(
    bins: Sequence[Sequence[int]],
    doc_lengths: Sequence[int],
    capacity: int,
) -> float:
    """Fraction of stream tokens that are real document tokens."""
    if not bins:
        return 0.0
    used = sum(min(sum(int(doc_lengths[i]) for i in b), capacity) for b in bins)
    return used / (len(bins) * capacity)


def pack_corpus(
    docs: Iterable[np.ndarray],
    capacity: int,
    *,
    pad_token: int = 0,
    flush_incomplete: bool = True,
) -> Iterator[tuple[np.ndarray, list[int]]]:
    """Streaming packer: yields ``(tokens [capacity], cu_seqlens)`` per full
    stream, packing documents greedily in arrival order (online first fit
    over one open stream, for corpora that cannot be sorted whole).

    A document longer than the room left is split across consecutive
    streams; ``cu_seqlens`` marks every piece's boundary, so pieces never
    attend each other across streams.
    """
    # validate at the call site, not on the first iteration
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    return _pack_corpus_gen(docs, capacity, pad_token, flush_incomplete)


def _pack_corpus_gen(
    docs: Iterable[np.ndarray],
    capacity: int,
    pad_token: int,
    flush_incomplete: bool,
) -> Iterator[tuple[np.ndarray, list[int]]]:
    buf = np.full((capacity,), pad_token, dtype=np.int64)
    cu = [0]
    fill = 0
    for doc in docs:
        arr = np.asarray(doc).reshape(-1)
        off = 0
        while off < len(arr):
            take = min(len(arr) - off, capacity - fill)
            buf[fill : fill + take] = arr[off : off + take]
            fill += take
            off += take
            cu.append(fill)
            if fill == capacity:
                yield buf.copy(), list(cu)
                buf[:] = pad_token
                cu = [0]
                fill = 0
    if flush_incomplete and fill > 0:
        cu.append(capacity)  # the padded tail as a document of its own
        yield buf.copy(), list(cu)
