"""Resilience on the port's decode paths against the JAX package's (jnp
backend, the same numpy cache state): ``decode_attn_paged`` and the
cascade (``cascade_decode_attn``, its level 1 through
``_decode_shared_prefix``) at 2 splits under
``corrupt_partial:site=split1``: ``check`` raises ``NumericalGuardError``
naming ``split1``, as JAX does; ``repair`` gives JAX's outputs (rtol 2e-4,
atol 2e-5); ``check`` with no chaos is bit for bit ``off``. Then the
``TieredScheduler`` at ``decode=2x1`` under ``decode_fault:times=1``: the
same ``StepReport``s as JAX's, field for field, the faulted replica's
requests replayed, and decode outputs within 1e-6 of JAX's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import serving as jsv
from magiattention_tpu.resilience import NumericalGuardError as JaxGuardError
from magiattention_tpu.resilience import reset_chaos as jax_reset_chaos
from magiattention_tpu_torch.convert import cache_from_numpy
from magiattention_tpu_torch.resilience import NumericalGuardError, reset_chaos
from magiattention_tpu_torch.serving import (
    CascadeGroup,
    Request,
    TieredEngine,
    TieredScheduler,
    cascade_decode_attn,
    decode_attn_paged,
)
from tests.torch_jax_backend import jax_backend

HQ, HK, D, PS, MPP = 4, 2, 16, 8, 6
RTOL, ATOL = 2e-4, 2e-5
PLANT = "corrupt_partial:site=split1,value=nan,seed=8"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    jax_backend(monkeypatch)
    for name in ("MAGI_ATTENTION_GUARD", "MAGI_ATTENTION_CHAOS", "MAGI_ATTENTION_DECODE_SPLITS",
                 "MAGI_ATTENTION_SERVING_MESH", "MAGI_ATTENTION_PREFILL_CHUNK",
                 "MAGI_ATTENTION_UNIFIED_TICK"):
        monkeypatch.delenv(name, raising=False)
    reset_chaos()
    jax_reset_chaos()


def _state(seed=0, b=5, shared=3):
    """One cache state in both packages: rows 0-2 share their first
    ``shared`` pages (a cascade group), rows 3-4 are on their own."""
    rng = np.random.default_rng(seed)
    num_pages = b * MPP + 1
    k = rng.standard_normal((num_pages, PS, HK, D)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (num_pages, PS, HK, D)).astype(np.float32)
    tables = 1 + rng.permutation(num_pages - 1).reshape(b, MPP).astype(np.int32)
    tables[:3, :shared] = tables[0, :shared]
    lens = rng.integers(shared * PS + 1, MPP * PS + 1, b).astype(np.int32)
    q = rng.standard_normal((b, HQ, D)).astype(np.float32)
    jcache = jsv.make_paged_kv_cache(num_pages, PS, HK, D, max_seqs=b, max_pages_per_seq=MPP,
                                     dtype=jnp.float32)
    jcache = type(jcache)(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(lens))
    group = (tuple(int(p) for p in tables[0, :shared]), shared * PS, (0, 1, 2))
    return jcache, cache_from_numpy(k, v, tables, lens), q, group


def _flat(pkg, jcache, cache, q):
    slots = np.arange(q.shape[0])
    if pkg == "jax":
        return jsv.decode_attn_paged(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=2)
    return decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots), num_splits=2)


def _cascade(pkg, jcache, cache, q, group):
    slots = np.arange(q.shape[0])
    if pkg == "jax":
        return jsv.cascade_decode_attn(jnp.asarray(q), jcache, slots,
                                       [jsv.CascadeGroup(*group)], num_splits=2)
    return cascade_decode_attn(torch.from_numpy(q), cache, slots.tolist(),
                               [CascadeGroup(*group)], num_splits=2)


PATHS = {"flat": _flat, "cascade": _cascade}


def _run(path, pkg, state):
    jcache, cache, q, group = state
    args = (jcache, cache, q) + ((group,) if path == "cascade" else ())
    out, lse = PATHS[path](pkg, *args)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_check_raises_naming_the_split(path, monkeypatch):
    state = _state()
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", PLANT)
    with pytest.raises(JaxGuardError) as want:
        _run(path, "jax", state)
    with pytest.raises(NumericalGuardError) as got:
        _run(path, "torch", state)
    assert got.value.sites == want.value.sites == ("split1",)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_repair_matches_jax(path, monkeypatch):
    state = _state(seed=1)
    clean = _run(path, "torch", state)
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "repair")
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", PLANT)
    want = _run(path, "jax", state)
    got = _run(path, "torch", state)
    assert np.isfinite(got[0]).all() and not np.isnan(got[1]).any()
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert not np.array_equal(got[1], clean[1]), "the plant changed nothing"


@pytest.mark.parametrize("path", sorted(PATHS))
def test_check_without_chaos_is_off_bit_for_bit(path, monkeypatch):
    state = _state(seed=2)
    off = _run(path, "torch", state)
    monkeypatch.setenv("MAGI_ATTENTION_GUARD", "check")
    on = _run(path, "torch", state)
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[1], off[1])


# -- the tiered scheduler under decode_fault -------------------------------------------

VOCAB = 89
_tok = np.random.default_rng(7)
EMB_K = _tok.standard_normal((VOCAB, HK, D)).astype(np.float32)
EMB_V = _tok.standard_normal((VOCAB, HK, D)).astype(np.float32)
GEOM = dict(num_pages=16, num_kv_heads=HK, head_dim=D, page_size=PS, max_seqs=4,
            max_pages_per_seq=4)
SPEC_2X1 = {"prefill": 1, "decode_dp": 2, "decode_tp": 1}


def _trace():
    rng = np.random.default_rng(21)
    specs = []
    for rid in range(3):
        tokens = [int(t) for t in rng.integers(0, VOCAB, 8)]
        specs.append(dict(rid=rid, prompt_q=rng.standard_normal((8, HQ, D)).astype(np.float32),
                          prompt_k=EMB_K[tokens], prompt_v=EMB_V[tokens],
                          decode_q=rng.standard_normal((2, HQ, D)).astype(np.float32),
                          decode_k=rng.standard_normal((2, HK, D)).astype(np.float32),
                          decode_v=rng.standard_normal((2, HK, D)).astype(np.float32),
                          tokens=tokens))
    return specs


def _fields(report) -> dict:
    return {f.name: getattr(report, f.name) for f in dataclasses.fields(report)}


def _tiered_run(pkg):
    if pkg == "jax":
        eng = jsv.TieredEngine(mesh_spec=SPEC_2X1, dtype=jnp.float32, **GEOM)
        sched, conv, req = jsv.TieredScheduler(eng, prefill_budget=64, decode_budget=16), \
            jnp.asarray, jsv.Request
    else:
        eng = TieredEngine(mesh_spec=SPEC_2X1, devices=["cpu"] * 3, dtype=torch.float32, **GEOM)
        sched, conv, req = TieredScheduler(eng, prefill_budget=64, decode_budget=16), \
            torch.from_numpy, Request
    for spec in _trace():
        sched.submit(req(**{k: conv(v) if isinstance(v, np.ndarray) else v
                            for k, v in spec.items()}))
    reports = sched.run(max_steps=60)
    results = {i: sched.result(i) for i in range(3)}
    return ([_fields(r) for r in reports],
            {i: (r.status, getattr(r, "requeues", None),
                 np.stack([np.asarray(x) for x in r.decode_outs]))
             for i, r in results.items()},
            [rep.restarts for rep in eng.replicas])


def test_tiered_decode_fault_matches_jax(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "1")
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", "decode_fault:times=1")
    want_reports, want, want_restarts = _tiered_run("jax")
    reset_chaos()
    got_reports, got, got_restarts = _tiered_run("torch")
    assert got_reports == want_reports
    assert got_restarts == want_restarts and sum(got_restarts) == 1
    faulted = [i for i, (_, rq, _) in got.items() if ("decode", "decode_fault") in rq]
    assert faulted
    for i in range(3):
        assert got[i][0] == want[i][0] == "finished"
        np.testing.assert_allclose(got[i][2], want[i][2], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_decode_fault_raises_typed_outside_scheduler(pkg, monkeypatch):
    """The raw engine (JAX ``test_distributed.py``'s twin): the injected
    fault surfaces as a typed ``DecodeTierFault`` naming the torn-down
    sequence, in both packages, and the sequence is gone."""
    from magiattention_tpu_torch.serving import DecodeTierFault

    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", "decode_fault:times=1")
    rng = np.random.default_rng(14)
    toks = [int(t) for t in rng.integers(0, VOCAB, 10)]
    q, qd, kd = (rng.standard_normal(s).astype(np.float32)
                 for s in ((10, HQ, D), (1, HQ, D), (1, HK, D)))
    spec = {"prefill": 1, "decode_dp": 1, "decode_tp": 1}
    if pkg == "jax":
        eng, conv, fault = jsv.TieredEngine(mesh_spec=spec, dtype=jnp.float32, **GEOM), \
            jnp.asarray, jsv.DecodeTierFault
    else:
        eng, conv, fault = TieredEngine(mesh_spec=spec, devices=["cpu"] * 2,
                                        dtype=torch.float32, **GEOM), torch.from_numpy, \
            DecodeTierFault
    res = eng.admit(10, tokens=toks)
    eng.prefill(conv(q), conv(EMB_K[toks]), conv(EMB_V[toks]), res.slot)
    assert eng.placed(res.slot)
    with pytest.raises(fault) as got:
        eng.decode_step(conv(qd), conv(kd), conv(kd), [res.slot])
    assert got.value.sids == (res.slot,) and got.value.replica == 0
    assert not eng.placed(res.slot)
