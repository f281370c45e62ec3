"""The flags that pick a planner or check its inputs: the port honours each
or refuses it, never takes it and plans something else.

``MAGI_ATTENTION_SANITY_CHECK``: ``common.sanity.check_slices_non_overlapping``
accepts and raises where the JAX package's does (random slice sets and a
dense brute force, as ``tests/test_common/test_sanity.py`` draws them), and
the keyed API runs it before planning (``MAGI_ATTENTION_AUTO_RANGE_MERGE``,
honoured since the range merge was ported, has its own tests:
``tests/test_torch_range_merge.py``). ``check_flag_comb`` raises where JAX's does (``tests/test_api/
test_interface.py``): ``MAGI_ATTENTION_HIERARCHICAL_COMM`` with a flat
group, qo-comm with an uneven shard or hierarchical groups, and a
cross-attention key with qo-comm, hierarchical groups or an uneven shard.
Each flag is in ``flags_fingerprint``, so that a qo key and a K/V-comm key
never share a cache entry. The refusals come before any process-group
call, so they need no ranks; one test spawns four to show that the flag
with ``HierCpGroups`` plans the hierarchical comm."""

import numpy as np
import pytest

from magiattention_tpu.common.mask import slice_mask
from magiattention_tpu.common.sanity import check_slices_non_overlapping as jax_check
from magiattention_tpu_torch import api
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.comm import HierCpGroups
from magiattention_tpu_torch.common.sanity import check_slices_non_overlapping
from magiattention_tpu_torch.meta.solver.dispatch_solver import DispatchConfig

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


def _key(cp_group=None, **kw):
    """A cp key on the CPU; ``cp_group`` is never reached by these cases."""
    return api.magi_attn_flex_key([(0, 256), (64, 192)], [(0, 256), (0, 64)], [1, 0], 256, 256,
                                  cp_group, num_heads=(4, 2), head_dim=64, chunk_size=64,
                                  device="cpu", **kw)


def test_sanity_flag_checks_the_keys_slices(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_SANITY_CHECK", "1")
    with pytest.raises(ValueError, match="double-count"):
        _key()  # (64..192) x (0..64) full lies inside the causal slice


def test_qo_comm_refuses_an_uneven_shard_and_hierarchical_comm(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    with pytest.raises(ValueError, match="uneven"):
        _key(dispatch_config=DispatchConfig(uneven_shard=True))
    monkeypatch.setenv("MAGI_ATTENTION_HIERARCHICAL_COMM", "1")
    with pytest.raises(ValueError, match="hierarchical"):
        interface.check_flag_comb()
    with pytest.raises(ValueError, match="hierarchical"):
        interface.check_flag_comb(cp_group=HIER)
    monkeypatch.delenv("MAGI_ATTENTION_QO_COMM")
    with pytest.raises(ValueError, match="two-level cp group"):
        interface.check_flag_comb()
    monkeypatch.delenv("MAGI_ATTENTION_HIERARCHICAL_COMM")
    interface.check_flag_comb(uneven_shard=True)  # legal without qo-comm


# the holder alone: check_flag_comb reads only its type
HIER = HierCpGroups(flat=None, inter=None, intra=None, n_inter=2, n_intra=2)


def test_hierarchical_flag_with_a_flat_group_makes_the_key_raise(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_HIERARCHICAL_COMM", "1")
    with pytest.raises(ValueError, match="make_hier_cp_groups"):
        _key()


@pytest.mark.parametrize("flag", [None, "MAGI_ATTENTION_HIERARCHICAL_COMM"])
def test_hierarchical_groups_pass_the_check_with_or_without_the_flag(flag, monkeypatch):
    """As in JAX, the layout is chosen by the groups (the ``cp_axis`` pair
    there); the flag only insists on it."""
    if flag:
        monkeypatch.setenv(flag, "1")
    interface.check_flag_comb(cp_group=HIER)
    interface.check_flag_comb(cp_group=HIER, uneven_shard=True)


def test_qo_comm_with_hierarchical_groups_raises(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    with pytest.raises(ValueError, match="qo-comm cannot be combined with hierarchical"):
        interface.check_flag_comb(cp_group=HIER)
    with pytest.raises(ValueError, match="qo-comm cannot be combined with hierarchical"):
        _key(cp_group=HIER)


@pytest.mark.parametrize("what", ["qo", "hier", "uneven"])
def test_cross_attention_refuses_self_attention_features(what, monkeypatch):
    kw = {}
    if what == "qo":
        monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    elif what == "hier":
        kw["cp_group"] = HIER
    else:
        kw["uneven_shard"] = True
    with pytest.raises(ValueError, match="cross-attention keys support the flat"):
        interface.check_flag_comb(xattn=True, **kw)
    interface.check_flag_comb(**kw)  # legal for a self-attention key
    with pytest.raises(ValueError, match="cross-attention keys support the flat"):
        api.magi_attn_cross_key(
            [(0, 256)], [(0, 512)], [0], 256, 512, kw.get("cp_group"), num_heads=(2, 2),
            head_dim=64, chunk_size_q=64, chunk_size_k=128, device="cpu",
            dispatch_config=DispatchConfig(uneven_shard=what == "uneven"))


def test_the_flag_with_hierarchical_groups_plans_hierarchical_comm():
    from magiattention_tpu_torch.testing.dist import RankPool

    from . import torch_dist_workers as workers

    with RankPool(4) as pool:
        got = pool.run(workers.hier_flag_key)
    for r in got:
        assert r == {"plan_hier": (2, 2), "key_hier": (2, 2), "flat_plan_hier": None}


@pytest.mark.parametrize("flag", ["MAGI_ATTENTION_QO_COMM", "MAGI_ATTENTION_SANITY_CHECK",
                                  "MAGI_ATTENTION_AUTO_RANGE_MERGE",
                                  "MAGI_ATTENTION_HIERARCHICAL_COMM"])
def test_each_flag_is_in_the_fingerprint(flag, monkeypatch):
    before = interface.flags_fingerprint()
    monkeypatch.setenv(flag, "1")
    assert interface.flags_fingerprint() != before


def test_unified_tick_mode_is_validated_and_in_the_fingerprint(monkeypatch):
    """``MAGI_ATTENTION_UNIFIED_TICK``: JAX's modes and default, a bad value
    raises at read (and so from the key), and each mode re-keys."""
    from magiattention_tpu import env as jax_env
    from magiattention_tpu_torch import env

    assert set(env.UNIFIED_TICK_MODES) == set(jax_env.UNIFIED_TICK_MODES)
    monkeypatch.delenv("MAGI_ATTENTION_UNIFIED_TICK", raising=False)
    assert env.unified_tick_mode() == jax_env.unified_tick_mode() == "off"
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", "bogus")
    with pytest.raises(ValueError, match="MAGI_ATTENTION_UNIFIED_TICK"):
        env.unified_tick_mode()
    with pytest.raises(ValueError, match="MAGI_ATTENTION_UNIFIED_TICK"):
        interface.flags_fingerprint()
    prints = set()
    for mode in ("off", "on", "auto", " ON "):
        monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
        prints.add(interface.flags_fingerprint())
    assert len(prints) == 3


@pytest.mark.parametrize("value", ["1", "true"])
def test_deterministic_mode_is_read_as_jax_reads_it_and_keyed(value, monkeypatch):
    """``MAGI_ATTENTION_DETERMINISTIC_MODE``: the JAX package keys it first in
    its fingerprint, so two keys that differ only in it must differ in the
    port too (the port's kernels are deterministic by construction: the flag
    changes no result, only the key)."""
    from magiattention_tpu import env as jax_env
    from magiattention_tpu_torch import env

    monkeypatch.delenv("MAGI_ATTENTION_DETERMINISTIC_MODE", raising=False)
    before, jax_before = interface.flags_fingerprint(), jax_env.flags_fingerprint()
    assert env.is_deterministic_mode_enabled() is jax_env.is_deterministic_mode_enabled()
    monkeypatch.setenv("MAGI_ATTENTION_DETERMINISTIC_MODE", value)
    assert env.is_deterministic_mode_enabled() is jax_env.is_deterministic_mode_enabled()
    assert jax_env.flags_fingerprint() != jax_before
    assert interface.flags_fingerprint() != before
