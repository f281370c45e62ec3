"""The port's ``utils/packing.py`` against the JAX package's on the same
host inputs (the cases of ``tests/test_utils/test_packing.py``): FFD bins,
``bin_cu_seqlens`` with and without the pad document, the efficiency, and
the streaming packer's tokens and boundaries, split documents included."""

import numpy as np
import pytest

from magiattention_tpu import utils as jax_utils
from magiattention_tpu_torch import utils


@pytest.mark.parametrize("seed,cap", [(0, 1024), (1, 512), (2, 4096), (3, 100)])
def test_ffd_bins_and_boundaries_match_jax(seed, cap):
    rng = np.random.default_rng(seed)
    lens = rng.integers(-3, 900, 200).tolist()  # empty and oversized documents too
    bins = utils.pack_documents(lens, cap)
    assert bins == jax_utils.pack_documents(lens, cap)
    for b in bins:
        for pad in (True, False):
            assert (utils.bin_cu_seqlens(b, lens, cap, pad_as_doc=pad)
                    == jax_utils.bin_cu_seqlens(b, lens, cap, pad_as_doc=pad))
    assert utils.packing_efficiency(bins, lens, cap) == jax_utils.packing_efficiency(bins, lens, cap)
    assert utils.packing_efficiency([], lens, cap) == 0.0


def test_oversized_and_invalid_inputs_raise_as_jax():
    for mod in (utils, jax_utils):
        with pytest.raises(ValueError, match="exceeds capacity"):
            mod.pack_documents([2048], 1024, truncate_oversized=False)
        with pytest.raises(ValueError, match="capacity must be positive"):
            mod.pack_documents([10], 0)
        with pytest.raises(ValueError, match="capacity must be positive"):
            mod.pack_corpus([np.arange(3)], 0)  # at the call, not on first iteration
    assert utils.bin_cu_seqlens([0], [2048], 1024) == [0, 1024]


@pytest.mark.parametrize("flush", [True, False])
@pytest.mark.parametrize("seed,cap", [(0, 512), (1, 2048), (2, 16384)])
def test_pack_corpus_matches_jax(seed, cap, flush):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, 32000, int(n)) for n in rng.integers(1, 3 * cap // 2, 12)]
    got = list(utils.pack_corpus(docs, cap, pad_token=-7, flush_incomplete=flush))
    ref = list(jax_utils.pack_corpus(docs, cap, pad_token=-7, flush_incomplete=flush))
    assert len(got) == len(ref) > 0
    for (tok, cu), (rtok, rcu) in zip(got, ref):
        assert tok.dtype == rtok.dtype and tok.tobytes() == rtok.tobytes()
        assert cu == rcu and cu[0] == 0 and cu[-1] == cap
    real = np.concatenate(docs)
    flat = np.concatenate([t for t, _ in got])
    np.testing.assert_array_equal(flat[: min(len(real), len(flat))],
                                  real[: min(len(real), len(flat))])
