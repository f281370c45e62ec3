"""The port's degradation paths against the JAX package's: the same
``AdmissionResult``s over the same admission sequence under
``pool_exhaust`` and ``alloc_fail:times=1`` (and after chaos clears); a
prefill fault (``prefill_error``) releasing its pages, the re-admission
reusing them; a refused growth keeping the slot intact; under
``plan_error:times=1`` the fallback degree-0 plan byte for byte JAX's (and
``times=0`` raising); under ``hops_build_error`` the meta's ``impl`` and
``impl_reason`` JAX's, the degraded meta still routing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import serving as jsv
from magiattention_tpu.resilience import ChaosInjectedError as JaxChaosError
from magiattention_tpu.resilience import reset_chaos as jax_reset_chaos
from magiattention_tpu_torch.resilience import ChaosInjectedError, reset_chaos
from magiattention_tpu_torch.serving import PageAllocatorError, ServingEngine
from tests.torch_jax_backend import jax_backend

HK, HQ, D, PS = 2, 4, 32, 16


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    jax_backend(monkeypatch)
    for name in ("MAGI_ATTENTION_CHAOS", "MAGI_ATTENTION_GUARD", "MAGI_ATTENTION_PREFILL_CHUNK",
                 "MAGI_ATTENTION_GROUP_COLL_IMPL"):
        monkeypatch.delenv(name, raising=False)
    reset_chaos()
    jax_reset_chaos()
    yield
    reset_chaos()
    jax_reset_chaos()


def _arm(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("MAGI_ATTENTION_CHAOS", raising=False)
    else:
        monkeypatch.setenv("MAGI_ATTENTION_CHAOS", spec)
    reset_chaos()
    jax_reset_chaos()


def _engines(num_pages=8, max_seqs=4, mpp=4, **kw):
    geom = dict(num_pages=num_pages, num_kv_heads=HK, head_dim=D, page_size=PS,
                max_seqs=max_seqs, max_pages_per_seq=mpp, **kw)
    return (ServingEngine(**geom, dtype=torch.float32, device="cpu"),
            jsv.ServingEngine(**geom, dtype=jnp.float32))


def _verdict(res):
    return (res.admitted, res.slot, res.reason, tuple(res.evicted), res.prefix_len)


# (chaos spec or None, tokens, priority, token ids or None) per admission
SEQUENCE = [
    ("pool_exhaust", 16, 0, None),
    ("alloc_fail:times=1", 16, 0, None),
    (None, 16, 0, None),
    (None, 40, 1, list(range(40))),
    ("alloc_fail:times=1", 40, 0, list(range(40))),  # the fork path
    (None, 40, 0, list(range(40))),  # the retry forks
    ("pool_exhaust", 24, 5, list(range(24))),
    (None, 4 * 16, 9, None),  # evicts lower priorities
    (None, 5 * 16, 0, None),  # too long
]


def test_admission_results_equal_jax(monkeypatch):
    port, jax_eng = _engines()
    got, want = [], []
    for spec, n, prio, toks in SEQUENCE:
        _arm(monkeypatch, spec)
        got.append(_verdict(port.admit(n, priority=prio, tokens=toks)))
        want.append(_verdict(jax_eng.admit(n, priority=prio, tokens=toks)))
        if got[-1][0] and toks is not None:  # register the prompt, as a prefill would
            rng = np.random.default_rng(n)
            left = n - got[-1][4]
            q, k, v = (rng.standard_normal((left, h, D)).astype(np.float32)
                       for h in (HQ, HK, HK))
            port.prefill(*(torch.from_numpy(x) for x in (q, k, v)), got[-1][1])
            jax_eng.prefill(*(jnp.asarray(x) for x in (q, k, v)), want[-1][1])
    assert got == want
    reasons = [g[2] for g in got]
    assert {"pool_exhausted", "alloc_error", "ok", "too_long"} <= set(reasons)
    assert port.allocator.occupancy() == jax_eng.occupancy() | {
        k: v for k, v in port.allocator.occupancy().items() if k not in jax_eng.occupancy()}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_prefill_fault_releases_pages_and_readmit_reuses(monkeypatch):
    rng = np.random.default_rng(0)
    port, jax_eng = _engines(num_pages=4, max_seqs=2, mpp=4)
    res, jres = port.admit(48), jax_eng.admit(48)
    pages = set(port.allocator.slot_pages(res.slot))
    assert pages == set(jax_eng.allocator._slot_pages[jres.slot])
    assert port.allocator.pages_in_use == 3
    _arm(monkeypatch, "prefill_error:times=1")
    args = [_rand(rng, 48, HQ, D), _rand(rng, 48, HK, D), _rand(rng, 48, HK, D)]
    with pytest.raises(ChaosInjectedError):
        port.prefill(*(torch.from_numpy(x) for x in args), res.slot)
    with pytest.raises(JaxChaosError):
        jax_eng.prefill(*(jnp.asarray(x) for x in args), jres.slot)
    occ = port.allocator.occupancy()
    assert occ["pages_in_use"] == 0 == jax_eng.occupancy()["pages_in_use"]
    assert occ["active_seqs"] == 0 and res.slot not in port._lengths
    _arm(monkeypatch, None)
    res2, jres2 = port.admit(48), jax_eng.admit(48)
    assert set(port.allocator.slot_pages(res2.slot)) == pages
    assert _verdict(res2) == _verdict(jres2)
    out, _ = port.prefill(*(torch.from_numpy(x) for x in args), res2.slot)
    jout, _ = jax_eng.prefill(*(jnp.asarray(x) for x in args), jres2.slot)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-5)
    assert port.length(res2.slot) == 48


def test_prefill_growth_exhaustion_keeps_slot_intact():
    rng = np.random.default_rng(1)
    port, _ = _engines(num_pages=2, max_seqs=2, mpp=4)
    res = port.admit(16)
    port.prefill(*(torch.from_numpy(_rand(rng, 16, h, D)) for h in (HQ, HK, HK)), res.slot)
    assert port.admit(16).admitted  # the second sequence drains the pool
    with pytest.raises(PageAllocatorError):
        port.prefill(*(torch.from_numpy(_rand(rng, 16, h, D)) for h in (HQ, HK, HK)), res.slot)
    assert port.length(res.slot) == 16  # committed KV intact
    assert port.allocator.active_seqs == 2  # not torn down


def test_injected_growth_exhaustion_changes_nothing(monkeypatch):
    port, _ = _engines()
    res = port.admit(16)
    before = port.allocator.slot_pages(res.slot)
    _arm(monkeypatch, "pool_exhaust")
    with pytest.raises(PageAllocatorError):
        port.reserve_growth(res.slot, 40)
    assert port.allocator.slot_pages(res.slot) == before
    port.reserve_growth(res.slot, 16)  # no growth needed: no refusal


# -- plan and hop-plan build fallbacks -------------------------------------------------


def test_plan_error_falls_back_to_jax_degree0_plan(monkeypatch):
    from tests.test_torch_dist_plan import _plans, _same_plans

    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", "a2a")
    _arm(monkeypatch, "plan_error:times=1")
    jm, pm, jp, pp = _plans("varlen_block_causal", 2, 2)
    assert pp.overlap_degree == jp.overlap_degree == 0 and pp.merged_comm is not None
    _same_plans(jm, pm, jp, pp, 0)
    _, _, _, healthy = _plans("varlen_block_causal", 2, 2)  # the injector is spent
    assert healthy.overlap_degree > 0
    # an unlimited injector fails the fallback too: the error surfaces, in both
    _arm(monkeypatch, "plan_error:times=0")
    with pytest.raises(JaxChaosError):
        _plans("varlen_block_causal", 2, 2)
    from magiattention_tpu_torch.common import AttnMaskType, AttnRanges
    from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel import build_dist_attn_plan

    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges([(0, 1024)]), AttnRanges.from_ranges([(0, 1024)]),
        [AttnMaskType.CAUSAL], 1024, 1024, 128, 2)
    with pytest.raises(ChaosInjectedError):
        build_dist_attn_plan(mq, bucket, overlap_config=OverlapConfig(degree=2))


def test_hops_build_error_degrades_to_a2a_as_jax(monkeypatch):
    from magiattention_tpu.comm.group_collective import GroupCollectiveMeta as JaxMeta
    from magiattention_tpu_torch.comm import GroupCollectiveMeta

    smap = [[np.arange(4, dtype=np.int64) if s != d else np.empty(0, np.int64)
             for d in range(2)] for s in range(2)]
    _arm(monkeypatch, "hops_build_error:times=1")
    meta = GroupCollectiveMeta.build(smap, [8, 8], impl="hops")
    jmeta = JaxMeta.build(smap, [8, 8], impl="hops")
    assert (meta.impl, meta.impl_reason, meta.hops) == (jmeta.impl, jmeta.impl_reason, ()) == \
        ("a2a", "degraded_hops_build_error", ())
    for a, b in zip(meta.cast_device_arrays(), jmeta.cast_device_arrays()):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    again = GroupCollectiveMeta.build(smap, [8, 8], impl="hops")
    assert again.impl == JaxMeta.build(smap, [8, 8], impl="hops").impl == "hops"
