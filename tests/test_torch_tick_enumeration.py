"""``ops.block_sparse.TickEnumeration`` against the JAX package's on the
same compositions: decode rows, prefill chunks and cascade pairs in random
mixes from a seed. The padded tables, valid lengths, merge pairs, capacity
buckets, segments and the one ``BlockEnumeration`` must be byte-identical;
the dead-row guarantee and the validation errors as JAX's."""

import numpy as np
import pytest

from magiattention_tpu.ops.block_sparse import TickEnumeration as JaxTick
from magiattention_tpu.ops.block_sparse import _pow2_bucket as jax_pow2
from magiattention_tpu_torch.ops import BlockEnumeration, TickEnumeration, TickSegment
from magiattention_tpu_torch.ops.block_sparse import _pow2_bucket


def _compose(seed: int, page_size: int):
    """The same random composition, as a list of add_* calls."""
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(int(rng.integers(1, 9))):
        kind = rng.choice(["decode", "prefill", "cascade"])
        if kind == "decode":
            n = int(rng.integers(1, 5 * page_size))
            pages = rng.integers(0, 64, -(-n // page_size)).tolist()
            calls.append(("add_decode", (("d", i), pages, n), {}))
        elif kind == "prefill":
            start, t = int(rng.integers(0, 3 * page_size)), int(rng.integers(1, 2 * page_size))
            pages = rng.integers(0, 64, -(-(start + t) // page_size)).tolist()
            calls.append(("add_prefill", (("p", i), pages, start, t), {}))
        else:
            full = int(rng.integers(1, 4))
            suffix = int(rng.integers(1, 2 * page_size))
            pages = rng.integers(0, 64, -(-suffix // page_size)).tolist()
            shared = rng.integers(0, 64, full).tolist()
            calls.append(("add_decode", (("c", i), pages, suffix),
                          dict(prefix_pages=shared, prefix_len=full * page_size)))
    return calls


def _build(cls, calls, page_size, min_rows):
    tick = cls(page_size, min_rows=min_rows)
    segs = [getattr(tick, name)(*args, **kw) for name, args, kw in calls]
    return tick, segs


@pytest.mark.parametrize("min_rows", [1, 8])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("seed", range(12))
def test_tables_byte_identical_to_jax(seed, page_size, min_rows):
    calls = _compose(seed, page_size)
    ref, ref_segs = _build(JaxTick, calls, page_size, min_rows)
    got, segs = _build(TickEnumeration, calls, page_size, min_rows)
    assert got.finalize() == ref.finalize()
    assert (got.row_capacity, got.entry_capacity) == (ref.row_capacity, ref.entry_capacity)
    assert got.num_rows == ref.num_rows
    for name in ("block_tables", "valid_lens", "merge_pairs"):
        a, b = getattr(got, name)(), getattr(ref, name)()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    for s, r in zip(segs, ref_segs):
        assert isinstance(s, TickSegment)
        assert (s.kind, s.key, s.row_lo, s.row_hi, s.prefix_row, s.num_rows) == (
            r.kind, r.key, r.row_lo, r.row_hi, r.prefix_row, r.num_rows)
    assert got.segments == tuple(segs)
    assert got.num_pairs == sum(1 for s in segs if s.prefix_row >= 0)
    for splits in (1, 2):
        if got.entry_capacity % splits:
            continue
        e, r = got.enumeration(splits), ref.enumeration(splits)
        assert isinstance(e, BlockEnumeration) and e.num_rows == r.num_rows
        for field in ("major", "minor", "row_start", "row_count"):
            a, b = np.asarray(getattr(e, field)), np.asarray(getattr(r, field))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_dead_row_guarantee_and_pair_padding():
    """A pair-carrying tick whose rows land exactly on their bucket doubles
    the capacity, so the padding pairs point at a dead row (valid 0)."""
    for cls in (TickEnumeration, JaxTick):
        tick = cls(8, min_rows=2)
        tick.add_decode("c0", (1,), 1, prefix_pages=(2,), prefix_len=8)
        tick.add_decode("c1", (3,), 1, prefix_pages=(4,), prefix_len=8)
        tick.add_decode("c2", (5,), 1, prefix_pages=(6,), prefix_len=8)
        rows, _ = tick.finalize()
        assert tick.num_rows == 6 and rows == 8
        pairs = tick.merge_pairs()
        assert pairs.shape == (4, 2) and pairs[3].tolist() == [rows - 1, rows - 1]
        assert tick.valid_lens()[rows - 1] == 0
        exact = cls(8, min_rows=4)
        exact.add_decode("c", (1,), 1, prefix_pages=(2,), prefix_len=8)
        exact.add_decode("d", (3, 4), 9)
        exact.add_decode("e", (5,), 3)
        assert exact.num_rows == 4 and exact.finalize() == (8, 2)
    assert [_pow2_bucket(n, lo) for n, lo in ((0, 1), (1, 1), (5, 1), (8, 1), (3, 8), (9, 8))] \
        == [jax_pow2(n, lo) for n, lo in ((0, 1), (1, 1), (5, 1), (8, 1), (3, 8), (9, 8))]


@pytest.mark.parametrize("call", [
    ("add_decode", ("d", (3,), 9), {}),
    ("add_decode", ("d", (3,), -1), {}),
    ("add_decode", ("c", (3,), 1), dict(prefix_pages=(1,), prefix_len=9)),
    ("add_prefill", ("p", (3,), 0, 0), {}),
    ("add_prefill", ("p", (3,), 4, 5), {}),
])
def test_validation_errors_as_jax(call):
    name, args, kw = call
    msgs = []
    for cls in (TickEnumeration, JaxTick):
        with pytest.raises(ValueError) as err:
            getattr(cls(8), name)(*args, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_finalize_refreezes_after_an_add():
    tick = TickEnumeration(8)
    tick.add_decode("a", (1,), 3)
    assert tick.finalize() == (8, 1)
    tick.add_decode("b", (1, 2, 3), 17)
    assert tick.finalize() == (8, 4)
