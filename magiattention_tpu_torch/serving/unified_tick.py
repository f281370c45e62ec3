"""One-launch serving tick: a whole tick's prefill chunks and decode steps
as rows of one ``paged_decode`` launch.

The counterpart of the JAX package's ``serving/unified_tick.py``. Every
tick row is one query token over a page-table prefix: a decode step
directly, and token ``i`` of a prefill chunk starting at ``start`` as a row
with ``valid = start + i + 1`` (causal masking is prefix-length masking).
:class:`~..ops.block_sparse.TickEnumeration` composes the rows into one
padded page table, :func:`decode_partials_for_tables` computes every row in
one launch (its plain version on the CPU), and cascade (main, prefix) row
pairs merge through ``ops/correction`` afterwards. The tick needs no flex
plan; in exchange each prefill row reads its own prefix.
"""

from __future__ import annotations

import torch

from ..ops.block_sparse import TickEnumeration
from ..ops.correction import correct_attn_out_lse
from ..utils.instrument import named_scope
from .decode_attn import _clamp_splits, decode_partials_for_tables
from .kv_cache import PagedKVCache


def resolve_tick_splits(num_splits: int | None, cache: PagedKVCache, row_capacity: int,
                        entry_capacity: int, hq: int, *, prefill_rows: int = 0) -> int:
    """Explicit arg > ``MAGI_ATTENTION_DECODE_SPLITS`` > the split tuner
    (``tuning.select_tick_splits``, the ``tick`` fingerprint kind: the
    decode model with the tick's padded rows for the batch), clamped to a
    divisor of the tick's entry capacity. The decode override applies here
    too, as in the JAX package: the tick is the decode kernel at the tick's
    batch. ``prefill_rows`` is a fingerprint axis."""
    from .. import env

    width = max(int(entry_capacity), 1)
    if num_splits is None:
        num_splits = env.decode_splits()
    if num_splits is None:
        from ..tuning import select_tick_splits

        num_splits = select_tick_splits(
            row_capacity, width, cache.page_size, hq, cache.num_kv_heads,
            head_dim=cache.head_dim, dtype=cache.k_pages.dtype, prefill_rows=prefill_rows,
            device=cache.k_pages.device,
        ).head_block  # the record's head_block is the split count
    return _clamp_splits(num_splits, width)


def unified_tick_attn(
    q_rows: torch.Tensor,  # [row_capacity, hq, head_dim] padded q rows
    cache: PagedKVCache,
    tick: TickEnumeration,
    *,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One serving tick's attention in one ``paged_decode`` launch: f32
    ``(out [row_capacity, hq, d], lse [row_capacity, hq])`` with each
    cascade pair merged into its main row. Padding rows (valid 0) come back
    as exact ``(0, -inf)``."""
    rows, entries = tick.finalize()
    if q_rows.shape[0] != rows:
        raise ValueError(
            f"unified_tick_attn: q_rows has {q_rows.shape[0]} rows but the tick enumeration is "
            f"padded to {rows} — pad q to the row capacity bucket (zero rows are fine: valid = 0 "
            "masks them)")
    num_splits = resolve_tick_splits(
        num_splits, cache, rows, entries, q_rows.shape[1],
        prefill_rows=sum(s.num_rows for s in tick.segments if s.kind == "prefill"))
    dev = q_rows.device
    bt = torch.from_numpy(tick.block_tables()).to(dev)
    valid = torch.from_numpy(tick.valid_lens()).to(dev)
    with named_scope("magi_tick_attn"):
        out, lse = decode_partials_for_tables(q_rows, cache, bt, valid, num_splits=num_splits,
                                              scale=scale, softcap=softcap)
    n = tick.num_pairs
    if n:
        # only the real pairs: each main row is written once, so the result
        # does not depend on the order of the writes
        pairs = torch.from_numpy(tick.merge_pairs()[:n]).to(dev).long()
        mains, prefs = pairs[:, 0], pairs[:, 1]
        o_m, l_m = correct_attn_out_lse(out[prefs], lse[prefs], out[mains], lse[mains])
        out = out.index_copy(0, mains, o_m)
        lse = lse.index_copy(0, mains, l_m)
    return out, lse


def demux_tick(tick: TickEnumeration, out: torch.Tensor, lse: torch.Tensor) -> dict:
    """Per-request slices of a tick's rows: ``{segment.key: (out_rows,
    lse_rows)}``, a decode segment ``([1, hq, d], [1, hq])``, a prefill
    segment its chunk's rows in order. Prefix rows were merged into their
    main rows and do not appear."""
    return {seg.key: (out[seg.row_lo:seg.row_hi], lse[seg.row_lo:seg.row_hi])
            for seg in tick.segments}
