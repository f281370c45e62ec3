"""The port's ``meta/plan_fingerprint.py`` against the JAX package's, on
the same host inputs: ``bucket_len``, ``canonicalize_mask`` (segments,
pads, canonical ranges), ``RowMaps`` and ``try_incremental_update``
byte-identical on ``testing/workloads.py``'s masks and on causal, offset,
uncovered-tail, interior-segment and identity cases; the same fingerprint
equality classes over those masks; and ``PlanReuseCache``'s LRU order
(JAX's own cases: ``tests/test_meta/test_plan_fingerprint.py``)."""

import numpy as np
import pytest

from magiattention_tpu.meta import plan_fingerprint as jfp
from magiattention_tpu_torch.meta import plan_fingerprint as pfp
from magiattention_tpu_torch.testing.workloads import DYNSOLVER_WORKLOADS, split_slices

FULL, CAUSAL, INVCAUSAL, BICAUSAL = 0, 1, 2, 3

SPECIAL = {  # name -> (q_ranges, k_ranges, types, total)
    "causal_51": ([(0, 51)], [(0, 51)], [CAUSAL], 51),
    "causal_53": ([(0, 53)], [(0, 53)], [CAUSAL], 53),
    "causal_on_grid": ([(0, 64)], [(0, 64)], [CAUSAL], 64),
    "full_identity": ([(0, 51)], [(0, 51)], [FULL], 51),
    "bicausal_identity": ([(0, 51)], [(0, 51)], [BICAUSAL], 51),
    "full_offset": ([(32, 53)], [(0, 32)], [FULL], 53),
    "invcausal_offset": ([(32, 53)], [(0, 32)], [INVCAUSAL], 53),
    "full_k_tail": ([(0, 51)], [(30, 51)], [FULL], 51),
    "causal_distinct_tails": ([(0, 51)], [(0, 40)], [CAUSAL], 51),
    "bicausal_uncovered_tail": ([(0, 30)], [(0, 30)], [BICAUSAL], 51),
    "varlen_two_docs": ([(0, 21), (21, 51)], [(0, 21), (21, 51)], [CAUSAL, CAUSAL], 51),
    "interior_segment": ([(0, 21), (21, 51)], [(0, 21), (0, 51)], [CAUSAL, CAUSAL], 51),
    "empty_slice": ([(0, 0), (0, 51)], [(0, 51), (0, 51)], [CAUSAL, CAUSAL], 51),
    "out_of_bounds": ([(0, 60)], [(0, 51)], [CAUSAL], 51),
    "bad_type": ([(0, 51)], [(0, 51)], [7], 51),
    "no_slices": ([], [], [], 51),
    "zero_total": ([(0, 51)], [(0, 51)], [CAUSAL], 0),
    "smoke_A": ([(0, 3000), (3000, 8000), (8000, 9500), (9500, 15500)],) * 2
    + ([CAUSAL] * 4, 15500),
    "smoke_F": ([(0, 7000), (7000, 14000), (14000, 16000)],) * 2 + ([CAUSAL] * 3, 16000),
}
WORKLOAD_TOTALS = (51, 300, 1000, 1531, 2048)
MASKS = dict(SPECIAL)
for wname, build in DYNSOLVER_WORKLOADS.items():
    for t in WORKLOAD_TOTALS:
        MASKS[f"{wname}_{t}"] = (*split_slices(build(t)), t)


def test_bucket_len_is_jax():
    for n in range(-2, 5000):
        assert pfp.bucket_len(n) == jfp.bucket_len(n), n
    for n in (8191, 8192, 8193, 15500, 1 << 20, (1 << 20) + 1):
        assert pfp.bucket_len(n) == jfp.bucket_len(n), n


def _maps_bytes(maps):
    return (maps.real_len, maps.canon_total, maps.real_to_canon.tobytes(),
            maps.canon_to_real.tobytes(), maps._real_buf.tobytes())


@pytest.mark.parametrize("name", sorted(MASKS))
def test_canonical_mask_and_row_maps_are_jax(name):
    got, ref = pfp.canonicalize_mask(*MASKS[name]), jfp.canonicalize_mask(*MASKS[name])
    assert (got is None) == (ref is None)
    if ref is None:
        return
    for f in ("q_ranges", "k_ranges", "attn_type_map", "total_seqlen", "segments",
              "real_total", "identity"):
        assert getattr(got, f) == getattr(ref, f), f
    assert _maps_bytes(got.build_row_maps()) == _maps_bytes(ref.build_row_maps())


def test_the_smoke_streams_canonical_documents():
    """The card's request stream: A, B and D share [3072, 5120, 1536, 6144];
    E, those documents themselves, is an identity; F goes to [7168, 7168,
    2048]."""
    def docs(lens):
        cu = np.concatenate([[0], np.cumsum(lens)]).tolist()
        r = list(zip(cu[:-1], cu[1:]))
        return pfp.canonicalize_mask(r, r, [CAUSAL] * len(r), cu[-1])

    canon = [docs(d) for d in ([3000, 5000, 1500, 6000], [2900, 4700, 1400, 5900],
                               [2900, 4700, 1400, 6000])]
    assert {(c.q_ranges, c.total_seqlen) for c in canon} == {
        (((0, 3072), (3072, 8192), (8192, 9728), (9728, 15872)), 15872)}
    assert docs([3072, 5120, 1536, 6144]) is None
    assert docs([7000, 7000, 2000]).q_ranges == ((0, 7168), (7168, 14336), (14336, 16384))


def _sig(mask):
    q, k, t, total = mask
    return (tuple(map(tuple, q)), tuple(map(tuple, k)), tuple(t), total)


EXTENDS = {  # name -> (previous mask, new mask)
    "plus_one": (SPECIAL["causal_51"], ([(0, 52)], [(0, 52)], [CAUSAL], 52)),
    "cross_bucket": (SPECIAL["causal_51"], ([(0, 57)], [(0, 57)], [CAUSAL], 57)),
    "shrink": (SPECIAL["causal_51"], ([(0, 50)], [(0, 50)], [CAUSAL], 50)),
    "same_total": (SPECIAL["causal_51"], SPECIAL["causal_51"]),
    "rolled": (SPECIAL["causal_51"], ([(1, 52)], [(1, 52)], [CAUSAL], 52)),
    "retyped": (SPECIAL["causal_51"], ([(0, 52)], [(0, 52)], [FULL], 52)),
    "varlen_tail": (SPECIAL["varlen_two_docs"],
                    ([(0, 21), (21, 52)], [(0, 21), (21, 52)], [CAUSAL, CAUSAL], 52)),
    "varlen_mid_grows": (SPECIAL["varlen_two_docs"],
                         ([(0, 22), (21, 52)], [(0, 21), (21, 52)], [CAUSAL, CAUSAL], 52)),
    "smoke_D": (([(0, 2900), (2900, 7600), (7600, 9000), (9000, 14900)],) * 2
                + ([CAUSAL] * 4, 14900),
                ([(0, 2900), (2900, 7600), (7600, 9000), (9000, 15000)],) * 2
                + ([CAUSAL] * 4, 15000)),
}


@pytest.mark.parametrize("name", sorted(EXTENDS))
def test_incremental_update_is_jax(name):
    prev, new = EXTENDS[name]
    pm = pfp.canonicalize_mask(*prev).build_row_maps()
    jm = jfp.canonicalize_mask(*prev).build_row_maps()
    ok = pfp.try_incremental_update(_sig(prev), _sig(new), pm)
    assert ok == jfp.try_incremental_update(_sig(prev), _sig(new), jm)
    assert ok == (name in ("plus_one", "varlen_tail", "smoke_D"))
    assert _maps_bytes(pm) == _maps_bytes(jm)
    # once patched the maps are of the new total: the old baseline is stale
    assert not pfp.try_incremental_update(_sig(prev), _sig(new), pm)


def test_row_maps_reject_a_wrong_cover():
    with pytest.raises(ValueError, match="segment cover"):
        pfp.RowMaps.from_segments([(0, 10, 2)], 10, 99)


def _fp(mod, canon, **over):
    common = dict(chunk_size=16, cp_size=2, num_heads_q=2, num_heads_kv=2, head_dim=32,
                  softcap=0.0, has_sink=False, sink_fingerprint=0, out_dtype="float32",
                  dispatch_config_repr="d", flags=())
    if mod is pfp:
        common.update(hier=None, device="cpu", block_config=(64, 64, 1), group_id=1)
    else:
        common.update(cp_axis="cp", interpret=None, mesh_id=1)
    common.update(over)
    return mod.make_plan_fingerprint(canon, **common)


def test_fingerprint_classes_are_jax():
    """Two masks share a fingerprint in the port exactly when they share
    one in JAX (the same non-mask fields on both sides)."""
    names = [n for n in sorted(MASKS) if pfp.canonicalize_mask(*MASKS[n]) is not None]
    port = [_fp(pfp, pfp.canonicalize_mask(*MASKS[n])) for n in names]
    ref = [_fp(jfp, jfp.canonicalize_mask(*MASKS[n])) for n in names]
    for i in range(len(names)):
        for j in range(len(names)):
            assert (port[i] == port[j]) == (ref[i] == ref[j]), (names[i], names[j])
    assert port[names.index("causal_51")] == port[names.index("causal_53")]
    assert len(set(port)) < len(port)  # the classes are not all singletons


@pytest.mark.parametrize("field,value", [("head_dim", 64), ("group_id", 2), ("hier", (1, 2)),
                                         ("device", "cuda:0"), ("block_config", (64, 64, 2)),
                                         ("flags", ("x",)), ("chunk_size", 32)])
def test_every_key_field_splits_the_fingerprint(field, value):
    canon = pfp.canonicalize_mask(*SPECIAL["causal_51"])
    base = _fp(pfp, canon)
    other = _fp(pfp, canon, **{field: value})
    assert other != base and other.stable_hash() != base.stable_hash()


def test_cache_lru_order_is_jax():
    """The same puts and gets leave the same entries, in the same order,
    with the same hit and miss counts."""
    names = ["causal_51", "varlen_two_docs", "full_offset", "invcausal_offset",
             "bicausal_uncovered_tail"]
    caches = {mod: mod.PlanReuseCache(capacity=3) for mod in (pfp, jfp)}
    fps = {mod: [_fp(mod, mod.canonicalize_mask(*SPECIAL[n])) for n in names]
           for mod in caches}
    ops = [("put", 0), ("put", 1), ("put", 2), ("get", 0), ("put", 3), ("get", 1), ("get", 2),
           ("put", 4), ("get", 0), ("get", 3), ("put", 1)]
    seen = {}
    for mod, cache in caches.items():
        trace = []
        for op, i in ops:
            if op == "put":
                cache.put(fps[mod][i], mod.ReuseEntry(canonical_key=i))
            else:
                e = cache.get(fps[mod][i])
                trace.append(None if e is None else e.canonical_key)
        order = [fps[mod].index(fp) for fp in cache._d]
        seen[mod] = (trace, order, cache.hits, cache.misses)
    assert seen[pfp] == seen[jfp]
    assert seen[pfp][1] == [4, 3, 1]  # 1, then 0, then 2 evicted


def test_cache_capacity_from_env_and_clear_by_group(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_CACHE_SIZE", "3")
    assert pfp.PlanReuseCache().capacity == 3
    canon = pfp.canonicalize_mask(*SPECIAL["causal_51"])
    cache = pfp.PlanReuseCache(capacity=10)
    a, b = _fp(pfp, canon), _fp(pfp, canon, group_id=2)
    cache.put(a, pfp.ReuseEntry(None))
    cache.put(b, pfp.ReuseEntry(None))
    cache.clear(group_id=1)
    assert a not in cache and b in cache
    cache.clear()
    assert len(cache) == 0 and cache.hits == cache.misses == 0
