"""Auto range merge (``MAGI_ATTENTION_AUTO_RANGE_MERGE``): the port's
``ops/range_merge.py::merge_ranges`` byte-identical to the JAX package's
on random slice lists (duplicates, overlapping and adjacent FULL k-ranges,
causal duplicates, empty slices); and the flag honoured, where it made the
port raise before, by ``flex_flash_attn_func`` and by a cp=2 key over
gloo: on a mask whose FULL slice is split into overlapping k-ranges and
whose causal slice is listed twice, the tables those of the pre-merged
list, out / lse (and the cp key's dq / dk / dv) bitwise the pre-merged
list's and within the float32 row of
``DEFAULT_BUDGETS`` of JAX's under the same flag (jnp backend, 64 x 64
tiles), the key holding the merged slices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.ops.range_merge import merge_ranges as jax_merge
from magiattention_tpu_torch.ops import flex_attn, flex_flash_attn_func
from magiattention_tpu_torch.ops.range_merge import merge_ranges
from magiattention_tpu_torch.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

BUDGET = DEFAULT_BUDGETS["float32"]
ABS_ONLY = dataclasses.replace(BUDGET, max_rel=float("inf"), max_ulp=float("inf"))
TOTAL, HQ, HK, D, CHUNK = 512, 4, 2, 32, 64
# the FULL slice of the second document split into overlapping k-ranges, the
# causal slice of the first listed twice; MERGED is merge_ranges' output
SPLIT = ([(0, 256), (256, 512), (256, 512), (0, 256), (256, 512), (256, 512)],
         [(0, 256), (0, 128), (64, 200), (0, 256), (190, 256), (256, 512)],
         [1, 0, 0, 1, 0, 1])
MERGED = ([(0, 256), (256, 512), (256, 512)], [(0, 256), (0, 256), (256, 512)], [1, 0, 1])


@pytest.mark.parametrize("seed", range(40))
def test_merge_ranges_is_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 12))
    qs = rng.choice([0, 16, 32, 48], n)
    q = np.stack([qs, qs + rng.choice([0, 16, 32], n)], 1)
    ks = rng.integers(0, 64, n)
    k = np.stack([ks, ks + rng.integers(0, 40, n)], 1)
    t = rng.choice([0, 0, 0, 1, 2, 3], n)
    if n > 2:  # an exact duplicate
        q[1], k[1], t[1] = q[0], k[0], t[0]
    got, ref = merge_ranges(q, k, t), jax_merge(q, k, t)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.int64
        assert g.shape == r.shape and g.tobytes() == r.tobytes()


def test_merge_ranges_of_the_split_mask():
    q, k, t = merge_ranges(*(np.asarray(a) for a in SPLIT))
    assert q.tolist() == [list(r) for r in MERGED[0]]
    assert k.tolist() == [list(r) for r in MERGED[1]]
    assert t.tolist() == MERGED[2]


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(TOTAL, HQ, D), k=f(TOTAL, HK, D),
                v=rng.uniform(0.5, 1.5, (TOTAL, HK, D)).astype(np.float32),
                g_out=f(TOTAL, HQ, D), g_lse=f(TOTAL, HQ))


def test_flex_flash_attn_func_merges_under_the_flag(monkeypatch):
    x = _inputs()
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    kw = dict(block_q=64, block_k=64, head_block=1, grid="row_major")
    want_out, want_lse = flex_flash_attn_func(q, k, v, *MERGED, **kw)
    monkeypatch.setenv("MAGI_ATTENTION_AUTO_RANGE_MERGE", "1")
    before = flex_attn._cached_meta.cache_info()
    out, lse = flex_flash_attn_func(q, k, v, *SPLIT, **kw)
    after = flex_attn._cached_meta.cache_info()
    # the split list planned nothing: it took the merged list's cached tables
    assert (after.hits - before.hits, after.misses - before.misses) == (1, 0)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    jax_backend(monkeypatch)
    ref_out, ref_lse = jax_flex(*(jnp.asarray(x[n]) for n in "qkv"), *SPLIT, block_q=64,
                                block_k=64, head_block=1, grid="row_major")
    assert_within_budget(divergence_report(np.asarray(ref_out), out.numpy(),
                                           ref_lse=np.asarray(ref_lse), test_lse=lse.numpy()),
                         BUDGET, where="flex_flash_attn_func")


def _jax_keyed(inputs, monkeypatch):
    jax_backend(monkeypatch)
    for name, val in (("MAGI_ATTENTION_BLOCK_Q", "64"),
                      ("MAGI_ATTENTION_BLOCK_K", "64"), ("MAGI_ATTENTION_AUTO_RANGE_MERGE", "1")):
        monkeypatch.setenv(name, val)
    mesh = Mesh(np.array(jax.devices()[:2]), ("cp",))
    key = jax_api.magi_attn_flex_key(*SPLIT, TOTAL, TOTAL, mesh, num_heads=(HQ, HK), head_dim=D,
                                     chunk_size=CHUNK, out_dtype="float32")
    g_out, g_lse = jnp.asarray(inputs["g_out"]), jnp.asarray(inputs["g_lse"])

    def fwd(q, k, v):
        out_d, meta = jax_api.calc_attn(*(jax_api.dispatch(a, key) for a in (q, k, v)), key)
        return jax_api.undispatch(out_d, key), jax_api.undispatch(meta.lse, key)

    def loss(q, k, v):
        o, lse = fwd(q, k, v)
        return (o * g_out).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * g_lse).sum()

    args = tuple(jnp.asarray(inputs[n]) for n in "qkv")
    out, lse = jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return {"out": np.asarray(out), "lse": np.asarray(lse), "key_q_ranges": key.q_ranges,
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


def test_a_cp_key_merges_under_the_flag(monkeypatch):
    inputs = _inputs(seed=6)
    case = dict(total=TOTAL, chunk=CHUNK, degree=0, impl="a2a", min_stage_rows=64)
    with RankPool(2) as pool:
        got = pool.run(workers.keyed_attention, dict(
            case, q_ranges=SPLIT[0], k_ranges=SPLIT[1], types=SPLIT[2],
            env={"MAGI_ATTENTION_AUTO_RANGE_MERGE": "1"}), inputs)
        want = pool.run(workers.keyed_attention, dict(
            case, q_ranges=MERGED[0], k_ranges=MERGED[1], types=MERGED[2]), inputs)
    ref = _jax_keyed(inputs, monkeypatch)
    g0 = got[0]
    assert (list(g0["key_q_ranges"]), list(g0["key_k_ranges"]), list(g0["key_types"])) == MERGED
    assert tuple(ref["key_q_ranges"]) == g0["key_q_ranges"]
    for name in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_array_equal(g0[name], want[0][name], err_msg=name)
    assert_within_budget(divergence_report(ref["out"], g0["out"], ref_lse=ref["lse"],
                                           test_lse=g0["lse"]), BUDGET, where="cp out")
    for name in ("dq", "dk", "dv"):
        r, g = ref[name], g0[name]
        assert_within_budget(divergence_report(r, g), ABS_ONLY, where=name)
        big = np.abs(r) >= 1e-2 * np.abs(r).max()
        assert_within_budget(divergence_report(r[big], g[big]), BUDGET, where=name)
