"""The port's cross-attention keys against the JAX package's.

``magi_attn_cross_key`` -> ``dispatch`` (queries) / ``dispatch_kv``
(memory) -> ``calc_attn`` -> ``undispatch`` over gloo on the CPU at cp 2
and 4, against JAX ``magi_attn_cross_key`` on its virtual CPU mesh (jnp
kernel backend, both at the port kernels' 64 x 64 tile through the
``MAGI_ATTENTION_BLOCK_Q/_K`` pins), on the same numpy inputs in float32:
out, lse and dq / dk / dv within rtol 2e-4 / atol 2e-5 (the bound of
``tests/test_torch_dist_attn.py``), with tq != tk and both sides padded
to their chunk multiples; the dispatch metas' partitions and the plan
byte-identical to the JAX key's; ``get_xattn_args`` and the memory's
``undispatch_kv`` round trip. A planted cast whose backward drops the
memory's dK/dV fails dk / dv only. Then the key cache and the refusals
around the key variants (JAX ``tests/test_api/test_cross_key.py``,
``tests/test_parallel/test_cross_attn.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .test_torch_dist_plan import _same_plans
from .torch_jax_backend import jax_backend

RTOL, ATOL = 2e-4, 2e-5
D, HQ, HK = 32, 4, 2
CHUNK_Q, CHUNK_K = 64, 128
# (name, q_ranges, k_ranges, types, tq, tk): 448 queries, 960 memory rows,
# neither a chunk multiple over the ranks, so both sides pad
MASKS = {
    "halves": ([(0, 224), (224, 448)], [(0, 480), (240, 960)], [0, 1]),
    # each document's queries attend FULL to its own memory span
    "docs": ([(0, 192), (192, 320), (320, 448)], [(0, 480), (480, 720), (720, 960)], [0, 0, 0]),
}
TQ, TK = 448, 960
CASES = [(2, "halves", 0, "a2a"), (2, "docs", 2, "hops"), (4, "docs", 0, "hops"),
         (4, "halves", 2, "a2a")]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(TQ, HQ, D), k=f(TK, HK, D), v=f(TK, HK, D), g_out=f(TQ, HQ, D),
                g_lse=f(TQ, HQ))


def _case(mask, degree, impl, **extra):
    qr, kr, ty = MASKS[mask]
    return dict(q_ranges=qr, k_ranges=kr, types=ty, tq=TQ, tk=TK, chunk_q=CHUNK_Q,
                chunk_k=CHUNK_K, degree=degree, impl=impl, **extra)


def _jax_run(cp, case, inputs, monkeypatch):
    """JAX ``magi_attn_cross_key`` on the same inputs, forward and
    ``jax.grad``; its key's plan and dispatch metas."""
    jax_backend(monkeypatch)
    for name, val in (("MAGI_ATTENTION_BLOCK_Q", "64"),
                      ("MAGI_ATTENTION_BLOCK_K", "64"),
                      ("MAGI_ATTENTION_GROUP_COLL_IMPL", case["impl"])):
        monkeypatch.setenv(name, val)
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))
    key = jax_api.magi_attn_cross_key(
        case["q_ranges"], case["k_ranges"], case["types"], TQ, TK, mesh, num_heads=(HQ, HK),
        head_dim=D, chunk_size_q=CHUNK_Q, chunk_size_k=CHUNK_K, out_dtype="float32",
        overlap_config=JaxOverlapConfig(degree=case["degree"], min_stage_rows=CHUNK_Q))
    g_out, g_lse = jnp.asarray(inputs["g_out"]), jnp.asarray(inputs["g_lse"])

    def fwd(q, k, v):
        out_d, meta = jax_api.calc_attn(jax_api.dispatch(q, key), jax_api.dispatch_kv(k, key),
                                        jax_api.dispatch_kv(v, key), key)
        return jax_api.undispatch(out_d, key), jax_api.undispatch(meta.lse, key)

    def loss(q, k, v):
        o, lse = fwd(q, k, v)
        return (o * g_out).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * g_lse).sum()

    args = tuple(jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    out, lse = jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    mgr = jax_api.get_runtime_mgr(key)
    return {"out": np.asarray(out), "lse": np.asarray(lse),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)},
            "plan": mgr.plan, "q_meta": mgr.dispatch_meta, "k_meta": mgr.kv_dispatch_meta,
            "pad_size_k": mgr.pad_size_k, "key": key}


@pytest.fixture(scope="module")
def pools():
    pools = {cp: RankPool(cp) for cp in (2, 4)}
    yield pools
    for p in pools.values():
        p.close()


@pytest.mark.parametrize("cp,mask,degree,impl", CASES, ids=lambda x: str(x))
def test_keyed_cross_attention_matches_jax(cp, mask, degree, impl, pools, monkeypatch):
    inputs = _inputs()
    case = _case(mask, degree, impl)
    got = pools[cp].run(workers.cross_attention, case, inputs)
    ref = _jax_run(cp, case, inputs, monkeypatch)
    g0 = got[0]
    assert g0["q_partitions"] == ref["q_meta"].partitions
    assert g0["k_partitions"] == ref["k_meta"].partitions
    assert g0["pad_size_k"] == ref["pad_size_k"] > 0 and g0["pad_size"] > 0
    _same_plans(None, None, ref["plan"], g0["plan"], degree)
    assert g0["plan"].shard_k_len == ref["k_meta"].shard_seqlen
    tq, tk = ref["key"].total_seqlen_q, ref["key"].total_seqlen_k
    assert g0["args"] == (tq, tk, tq // cp, tk // cp)
    # every rank's slots together cover each padded position once
    for side, total in (("q_pos", tq), ("k_pos", tk)):
        assert sorted(np.concatenate([r[side] for r in got]).tolist()) == list(range(total))
    assert all(r["kv_round_trip_exact"] for r in got)
    for name in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_allclose(g0[name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
        for r in range(1, cp):
            np.testing.assert_array_equal(got[r][name], g0[name], err_msg=f"{name} rank {r}")


def test_planted_skip_of_the_memory_reduce_is_caught(pools, monkeypatch):
    """A cast whose backward drops the received memory rows' dK/dV: out,
    lse and dq still agree, dk and dv must not."""
    inputs = _inputs()
    case = _case("docs", 0, "a2a")
    ref = _jax_run(2, case, inputs, monkeypatch)
    try:
        got = pools[2].run(workers.cross_attention, {**case, "skip_reduce": True}, inputs)[0]
    finally:  # the fault is planted in the ranks: do not leave it to later tests
        pools[2].close()
        pools[2] = RankPool(2)
    for name in ("out", "lse", "dq"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for name in ("dk", "dv"):
        assert not np.allclose(got[name], ref[name], rtol=RTOL, atol=ATOL), name


def test_key_cache_and_refusals_of_the_key_variants(pools):
    got = pools[4].run(workers.key_variants)
    for r in got:
        assert r["cross_keys_differ"] and r["cross_key_cached"] and r["is_cross"]
        assert r["pad_size_k"] == (64, 0)
        assert r["flat_hier_differ"] and r["hier_key"] == (2, 2)
        assert r["new_hier_plan"] == r["new_hier_key"] == (2, 2)
        assert r["new_shares_dispatch"]
        ref = r["refusals"]
        assert "sink" in ref["sink"]
        assert "qo-comm" in ref["qo"]
        assert "cross-attention" in ref["cross"]
        assert "cross-attn key" in ref["xattn_args_self"]
        assert "cross-attn key" in ref["dispatch_kv_self"]
