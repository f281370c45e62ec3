"""The flags that pick a planner or check its inputs: the port honours each
or refuses it, never takes it and plans something else.

``MAGI_ATTENTION_SANITY_CHECK``: ``common.sanity.check_slices_non_overlapping``
accepts and raises where the JAX package's does (random slice sets and a
dense brute force, as ``tests/test_common/test_sanity.py`` draws them), and
the keyed API runs it before planning. ``MAGI_ATTENTION_AUTO_RANGE_MERGE``
and ``MAGI_ATTENTION_HIERARCHICAL_COMM`` (not ported) make the keyed API
raise, the first also ``flex_flash_attn_func``; qo-comm refuses an uneven
shard and hierarchical comm, as JAX's ``check_flag_comb`` does. Each flag
is in ``flags_fingerprint``, so that a qo key and a K/V-comm key never
share a cache entry. The refusals come before any process-group call, so
these tests need no ranks."""

import numpy as np
import pytest
import torch

from magiattention_tpu.common.mask import slice_mask
from magiattention_tpu.common.sanity import check_slices_non_overlapping as jax_check
from magiattention_tpu_torch import api
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.common.sanity import check_slices_non_overlapping
from magiattention_tpu_torch.meta.solver.dispatch_solver import DispatchConfig
from magiattention_tpu_torch.ops import flex_flash_attn_func

SPAN = 64


def _raises(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("seed", range(30))
def test_sanity_check_is_jax_check(seed):
    rng = np.random.default_rng(seed)
    qr, kr, ts = [], [], []
    for _ in range(int(rng.integers(2, 5))):
        qs = int(rng.integers(0, SPAN - 2))
        qe = int(rng.integers(qs + 1, SPAN))
        ks = int(rng.integers(0, SPAN - 2))
        ke = int(rng.integers(ks + 1, SPAN))
        qr.append((qs, qe))
        kr.append((ks, ke))
        ts.append(int(rng.integers(0, 4)))
    acc = sum(slice_mask(q[0], q[1], k[0], k[1], t, SPAN, SPAN).astype(np.int32)
              for q, k, t in zip(qr, kr, ts))
    got, want = _raises(check_slices_non_overlapping, qr, kr, ts), _raises(jax_check, qr, kr, ts)
    assert got == want
    assert (got is not None) == bool((acc > 1).any())


def _key(**kw):
    """A cp key on the CPU; ``cp_group`` is never reached by these cases."""
    return api.magi_attn_flex_key([(0, 256), (64, 192)], [(0, 256), (0, 64)], [1, 0], 256, 256,
                                  None, num_heads=(4, 2), head_dim=64, chunk_size=64,
                                  device="cpu", **kw)


def test_sanity_flag_checks_the_keys_slices(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_SANITY_CHECK", "1")
    with pytest.raises(ValueError, match="double-count"):
        _key()  # (64..192) x (0..64) full lies inside the causal slice


@pytest.mark.parametrize("flag,item", [("MAGI_ATTENTION_AUTO_RANGE_MERGE", "A.4/A.5"),
                                       ("MAGI_ATTENTION_HIERARCHICAL_COMM", "A.7/A.8")])
def test_unported_flags_make_the_key_raise(flag, item, monkeypatch):
    monkeypatch.setenv(flag, "1")
    with pytest.raises(ValueError, match=item):
        _key()


def test_qo_comm_refuses_an_uneven_shard_and_hierarchical_comm(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    with pytest.raises(ValueError, match="uneven"):
        _key(dispatch_config=DispatchConfig(uneven_shard=True))
    monkeypatch.setenv("MAGI_ATTENTION_HIERARCHICAL_COMM", "1")
    with pytest.raises(ValueError, match="hierarchical"):
        interface.check_flag_comb()
    monkeypatch.delenv("MAGI_ATTENTION_QO_COMM")
    with pytest.raises(ValueError, match="A.7/A.8"):
        interface.check_flag_comb()
    monkeypatch.delenv("MAGI_ATTENTION_HIERARCHICAL_COMM")
    interface.check_flag_comb(uneven_shard=True)  # legal without qo-comm


def test_flex_flash_attn_func_refuses_auto_range_merge(monkeypatch):
    q = torch.zeros((64, 2, 64))
    monkeypatch.setenv("MAGI_ATTENTION_AUTO_RANGE_MERGE", "1")
    with pytest.raises(ValueError, match="A.4/A.5"):
        flex_flash_attn_func(q, q, q, [(0, 64)], [(0, 64)], [1])


@pytest.mark.parametrize("flag", ["MAGI_ATTENTION_QO_COMM", "MAGI_ATTENTION_SANITY_CHECK",
                                  "MAGI_ATTENTION_AUTO_RANGE_MERGE",
                                  "MAGI_ATTENTION_HIERARCHICAL_COMM"])
def test_each_flag_is_in_the_fingerprint(flag, monkeypatch):
    before = interface.flags_fingerprint()
    monkeypatch.setenv(flag, "1")
    assert interface.flags_fingerprint() != before
