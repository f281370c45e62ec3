"""The port's mask helpers (``api/functools.py``) and range types
(``common/range.py``, ``common/ranges.py``) against the JAX package's, on
the same host inputs: identical slices and types."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.api import functools as jax_ft
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu_torch.api import functools as ft
from magiattention_tpu_torch.common import AttnRange, AttnRanges, RangeError


def _same(port, ref):
    pq, pk, pt = port
    rq, rk, rt = ref
    assert pq.to_naive_ranges() == rq.to_naive_ranges()
    assert pk.to_naive_ranges() == rk.to_naive_ranges()
    assert [int(t) for t in pt] == [int(t) for t in rt]


@pytest.mark.parametrize(
    "cu,kw",
    [
        ([0, 48, 128], {}),
        ([0, 10, 10, 300], {"causal": False}),
        ([0, 100, 300], {"causal": False, "window_size": (10, 5), "global_window_size": 3}),
        ([0, 64, 200], {"causal": False, "window_size": (200, 0)}),
        ([0, 50, 90], {"causal": False, "cu_seqlens_k": [0, 80, 160], "window_size": (7, 7)}),
        ([0, 30, 60], {"cu_seqlens_k": [0, 45, 100]}),
    ],
)
def test_cu_seqlens_mask_matches_jax(cu, kw):
    _same(ft.infer_attn_mask_from_cu_seqlens(cu, **kw),
          jax_ft.infer_attn_mask_from_cu_seqlens(cu, **kw))


@pytest.mark.parametrize("causal", [True, False])
def test_batch_and_full_masks_match_jax(causal):
    _same(ft.infer_varlen_mask_from_batch([4096, 2048, 2048], causal=causal),
          jax_ft.infer_varlen_mask_from_batch([4096, 2048, 2048], causal=causal))
    _same(ft.full_attention_mask(777), jax_ft.full_attention_mask(777))


@pytest.mark.parametrize("window,g", [((5, 2), 0), ((0, 0), 0), ((3, -1), 4), ((-1, 6), 2)])
def test_window_mask_per_range_matches_jax(window, g):
    port = ft.infer_window_mask_per_range((10, 70), (5, 60), window, g)
    ref = jax_ft.infer_window_mask_per_range((10, 70), (5, 60), window, g)
    assert port[0] == ref[0] and port[1] == ref[1]
    assert [int(t) for t in port[2]] == [int(t) for t in ref[2]]


def test_invalid_cu_seqlens_raise():
    with pytest.raises(ValueError, match="non-decreasing"):
        ft.infer_attn_mask_from_cu_seqlens([0, 10, 5])


def test_pad_helpers_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for dim, pad in ((0, 2), (1, 5), (2, 0)):
        got = ft.pad_at_dim(torch.from_numpy(x), dim, pad, value=-1.0)
        ref = jax_ft.pad_at_dim(jnp.asarray(x), dim, pad, value=-1.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(ft.unpad_at_dim(got, dim, x.shape[dim]).numpy(), x)
    for args in ((1000, 4, 64), (1024, 4, 64), (1, 1, 1)):
        assert ft.compute_pad_size(*args) == jax_ft.compute_pad_size(*args)


def _random_ranges(rng, n, hi):
    starts = rng.integers(0, hi, n)
    return [(int(a), int(a + rng.integers(0, 40))) for a in starts]


@pytest.mark.parametrize("seed", range(4))
def test_ranges_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = _random_ranges(rng, 6, 200)
    pa, ja = AttnRanges.from_ranges(a), JaxRanges.from_ranges(a)
    assert pa.to_naive_ranges() == ja.to_naive_ranges() == a
    assert len(pa) == len(ja)
    assert pa[1:4].to_naive_ranges() == ja[1:4].to_naive_ranges()
    assert [r.seqlen for r in pa] == [r.seqlen for r in ja]
    assert pa.clone() == pa and pa.clone() is not pa
    cu = np.concatenate([[0], np.cumsum(rng.integers(0, 30, 5))]).tolist()
    assert (AttnRanges.from_cu_seqlens(cu, cu[-1]).to_naive_ranges()
            == JaxRanges.from_cu_seqlens(cu, cu[-1]).to_naive_ranges())


def test_range_validity():
    with pytest.raises(RangeError):
        AttnRange(5, 3)
    r = AttnRange(2, 9)
    assert AttnRanges.from_ranges([r, (1, 4)])[0] == r and r.seqlen == 7
    assert AttnRanges.from_cu_seqlens([0, 3, 3, 8], 8).to_naive_ranges() == [(0, 3), (3, 3), (3, 8)]
    with pytest.raises(ValueError, match="cu_seqlens"):
        AttnRanges.from_cu_seqlens([0, 3, 2], 2)


def test_apply_padding_matches_jax():
    q = AttnRanges.from_ranges([(0, 100), (100, 250)])
    jq = JaxRanges.from_ranges([(0, 100), (100, 250)])
    got = ft.apply_padding(q, q, ["causal", "full"], 250, 6)
    ref = jax_ft.apply_padding(jq, jq, ["causal", "full"], 250, 6)
    assert got[0].to_naive_ranges() == ref[0].to_naive_ranges()
    assert got[2:] == ref[2:] == (["causal", "full"], 256)


@pytest.mark.parametrize("shape", [(2, 5, 3), (3, 4), (1, 7, 2, 2)])
def test_squash_batch_dim_matches_jax(shape):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = ft.squash_batch_dim(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ft.squash_batch_dim(jnp.asarray(x))))


SEGMENT_IDS = [
    [0, 0, 0, 1, 1, 2, 2, 2, 2, -1, -1],
    [5, 5, -1, 5, 7, 7],
    [-1, -1, -1],
    [[0, 0, 1, 1, 1, -1], [3, 3, 3, 3, 4, 4]],
    [[1, 1, 1], [1, 1, 1]],  # runs never merge across rows
    np.zeros((2, 0), np.int64),
]


@pytest.mark.parametrize("ids", range(len(SEGMENT_IDS)))
@pytest.mark.parametrize("causal", [True, False])
def test_segment_ids_mask_matches_jax(ids, causal):
    seg = np.asarray(SEGMENT_IDS[ids])
    _same(ft.infer_attn_mask_from_segment_ids(seg, causal=causal),
          jax_ft.infer_attn_mask_from_segment_ids(seg, causal=causal))
    _same(ft.infer_attn_mask_from_segment_ids(torch.from_numpy(seg), causal=causal),
          jax_ft.infer_attn_mask_from_segment_ids(seg, causal=causal))


@pytest.mark.parametrize("rows", [[[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]], [[1] * 5] * 3,
                                  [[True, True, False]]])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_batch_mask_matches_jax(rows, causal):
    am = np.asarray(rows)
    _same(ft.infer_varlen_mask_from_padded_batch(am, causal=causal),
          jax_ft.infer_varlen_mask_from_padded_batch(am, causal=causal))


def test_padded_batch_and_segment_ids_refuse_what_jax_refuses():
    hole = np.asarray([[1, 0, 1, 0]])
    with pytest.raises(ValueError, match="not right-padded"):
        ft.infer_varlen_mask_from_padded_batch(hole)
    with pytest.raises(ValueError, match="not right-padded"):
        jax_ft.infer_varlen_mask_from_padded_batch(hole)
    with pytest.raises(ValueError, match="batch, seq"):
        ft.infer_varlen_mask_from_padded_batch(np.ones(4))
    with pytest.raises(ValueError, match=r"\[t\] or \[b, s\]"):
        ft.infer_attn_mask_from_segment_ids(np.zeros((1, 2, 3)))


@pytest.mark.parametrize("total,window,g", [(100, 1, 0), (100, 16, 0), (100, 16, 4), (37, 200, 0),
                                            (256, 64, 64), (64, 63, 1)])
def test_sliding_window_mask_matches_jax(total, window, g):
    _same(ft.infer_attn_mask_from_sliding_window(total, window, global_tokens=g),
          jax_ft.infer_attn_mask_from_sliding_window(total, window, global_tokens=g))


def test_sliding_window_refusals():
    with pytest.raises(ValueError, match="bidirectional"):
        ft.infer_attn_mask_from_sliding_window(64, 8, causal=False)
    with pytest.raises(ValueError, match="window_size must be >= 1"):
        ft.infer_attn_mask_from_sliding_window(64, 0)
