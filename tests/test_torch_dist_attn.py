"""The port's context-parallel attention over gloo on the CPU against the
JAX package's ``make_dist_attn_fn`` + ``jax.grad`` on its virtual CPU mesh
(jnp kernel backend), on the same numpy inputs in float32: out, lse and
dq / dk / dv (and the sink's gradient) of ``magi_attn_flex_key`` ->
``dispatch`` -> ``calc_attn`` -> ``undispatch`` within rtol 2e-4 / atol
2e-5, the bound the JAX package holds its own cp layouts to against cp=1
(``tests/test_models/test_llama.py``). cp 2 and 4, overlap degree 0 and
2, the a2a and hops group collectives, G 1 and 2, a sink, a mask that
leaves rows uncovered, and an uneven shard; both plans at the 64 x 64
tile. The ranks are
spawned once per cp size (``testing.dist.RankPool``) and run every case.

A planted fault (the cast's backward skipping the dK/dV reduce) must fail
the dk / dv comparison. Then the LSE merge of the staged path under
autograd against ``jax.grad`` of its JAX twin, on rows that one or both
partials leave uncovered (lse = -inf)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu.meta.solver.dispatch_solver import DispatchConfig as JaxDispatchConfig
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.ops.correction import correct_attn_out_lse as jax_correct
from magiattention_tpu.parallel.dispatch import dispatch, undispatch
from magiattention_tpu.parallel.dist_attn import (
    build_dist_attn_plan,
    make_attn_params,
    make_dist_attn_fn,
)
from magiattention_tpu_torch.ops.correction import correct_attn_out_lse
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

RTOL, ATOL = 2e-4, 2e-5
TOTAL, CHUNK, D = 1024, 64, 32
MIN_STAGE_ROWS = 64  # so that degree 2 splits these sizes' remote rows into two stages
DOCS = [(0, 200), (200, 520), (520, 704), (704, TOTAL)]
MASKS = {
    "varlen_causal": (DOCS, DOCS, [1] * len(DOCS)),
    "causal": ([(0, TOTAL)], [(0, TOTAL)], [1]),
    # rows [256, 384) are in no slice: out 0, lse -inf, no gradient
    "uncovered": ([(0, 256), (384, TOTAL), (384, TOTAL)], [(0, 256), (0, 128), (256, TOTAL)],
                  [1, 0, 1]),
}
UNEVEN_TOTAL = 17 * CHUNK  # 17 chunks: an uneven shard at cp 2 and 4
UNEVEN_DOCS = [(0, 200), (200, 520), (520, 704), (704, UNEVEN_TOTAL)]
MASKS["uneven_varlen_causal"] = (UNEVEN_DOCS, UNEVEN_DOCS, [1] * len(UNEVEN_DOCS))
# (cp, mask, degree, impl, (hq, hk), sink)
CASES = [
    (2, "varlen_causal", 0, "a2a", (4, 4), False),
    (2, "causal", 2, "hops", (4, 2), True),
    (2, "uncovered", 0, "hops", (4, 2), False),
    (4, "causal", 0, "a2a", (4, 2), False),
    (4, "uncovered", 2, "hops", (4, 4), False),
    (4, "varlen_causal", 2, "a2a", (4, 2), True),
]


def _case_id(c):
    cp, mask, degree, impl, (hq, hk), sink = c
    return f"cp{cp}_{mask}_d{degree}_{impl}_g{hq // hk}" + ("_sink" if sink else "")


def _inputs(hq, hk, sink, seed=0, total=TOTAL):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = dict(q=f(total, hq, D), k=f(total, hk, D), v=f(total, hk, D),
               g_out=f(total, hq, D), g_lse=f(total, hq))
    if sink:
        out["sink"] = f(hq)
    return out


def _case(cp, mask, degree, impl, total=TOTAL, **extra):
    qr, kr, ty = MASKS[mask]
    return dict(cp=cp, q_ranges=qr, k_ranges=kr, types=ty, total=total, chunk=CHUNK,
                degree=degree, impl=impl, min_stage_rows=MIN_STAGE_ROWS, **extra)


def _jax_run(case, inputs, monkeypatch):
    """The JAX package's cp attention on the same inputs: its plan at the
    same tile, the jnp kernel backend, forward and ``jax.grad``."""
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", case["impl"])
    cp, total = case["cp"], case["total"]
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        JaxRanges.from_ranges(case["q_ranges"]), JaxRanges.from_ranges(case["k_ranges"]),
        case["types"], total, total, chunk_size=CHUNK, cp_size=cp,
        dispatch_config=JaxDispatchConfig(uneven_shard=case.get("uneven", False)))
    plan = build_dist_attn_plan(mq, bucket, block_q=64, block_k=64, overlap_config=JaxOverlapConfig(
        degree=case["degree"], min_stage_rows=MIN_STAGE_ROWS))
    has_sink = "sink" in inputs
    params = make_attn_params(plan, D, has_sink=has_sink, out_dtype="float32")
    sink0 = jnp.asarray(inputs["sink"]) if has_sink else None
    fn = make_dist_attn_fn(plan, mesh, params, sink=sink0)
    shard = NamedSharding(mesh, P("cp"))
    g_out, g_lse = jnp.asarray(inputs["g_out"]), jnp.asarray(inputs["g_lse"])

    def fwd(q, k, v, s):
        qd, kd, vd = (jax.lax.with_sharding_constraint(dispatch(x, mq), shard) for x in (q, k, v))
        out_d, lse_d = fn(qd, kd, vd, s)
        return undispatch(out_d, mq), undispatch(lse_d, mq)

    def loss(q, k, v, s):
        o, lse = fwd(q, k, v, s)
        return (o * g_out).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * g_lse).sum()

    args = tuple(jnp.asarray(inputs[n]) for n in ("q", "k", "v")) + (sink0,)
    out, lse = jax.jit(fwd)(*args)
    argnums = (0, 1, 2, 3) if has_sink else (0, 1, 2)
    grads = jax.jit(jax.grad(loss, argnums=argnums))(*args)
    res = dict(out=out, lse=lse, dq=grads[0], dk=grads[1], dv=grads[2],
               partitions=mq.partitions, degree=plan.overlap_degree)
    if has_sink:
        res["dsink"] = grads[3]
    return {n: (np.asarray(x) if not isinstance(x, (tuple, int)) else x) for n, x in res.items()}


@pytest.fixture(scope="module")
def pools():
    pools = {cp: RankPool(cp) for cp in (2, 4)}
    yield pools
    for p in pools.values():
        p.close()


@pytest.mark.parametrize("c", CASES, ids=_case_id)
def test_keyed_cp_attention_matches_jax(c, pools, monkeypatch):
    cp, mask, degree, impl, (hq, hk), sink = c
    inputs = _inputs(hq, hk, sink)
    case = _case(cp, mask, degree, impl)
    got = pools[cp].run(workers.keyed_attention, case, inputs)
    ref = _jax_run(case, inputs, monkeypatch)
    assert got[0]["partitions"] == ref["partitions"]
    assert got[0]["degree"] == ref["degree"] == degree
    assert set(got[0]["impls"]) == {impl}
    if mask == "uncovered":
        assert np.isneginf(ref["lse"][256:384]).all() and np.isfinite(ref["lse"][:256]).all()
    for name in ("out", "lse", "dq", "dk", "dv") + (("dsink",) if sink else ()):
        np.testing.assert_allclose(got[0][name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
        for r in range(1, cp):  # every rank holds the same global result
            np.testing.assert_array_equal(got[r][name], got[0][name], err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("cp,degree,impl", [(4, 0, "hops"), (2, 2, "a2a")])
def test_uneven_shard_matches_jax(cp, degree, impl, pools, monkeypatch):
    """``DispatchConfig(uneven_shard=True)`` on 17 chunks: the ranks hold
    unequal numbers of valid rows (pad slots past them), through
    ``dispatch`` -> ``calc_attn`` -> ``undispatch``."""
    inputs = _inputs(4, 2, False, total=UNEVEN_TOTAL)
    case = _case(cp, "uneven_varlen_causal", degree, impl, total=UNEVEN_TOTAL, uneven=True)
    got = pools[cp].run(workers.keyed_attention, case, inputs)
    ref = _jax_run(case, inputs, monkeypatch)
    assert got[0]["partitions"] == ref["partitions"]
    assert len({len(p) for p in got[0]["partitions"]}) > 1, "the shard must be uneven"
    for name in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[0][name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("cp,impl", [(2, "a2a"), (4, "hops")])
def test_planted_skip_of_the_dkv_reduce_is_caught(cp, impl, pools, monkeypatch):
    """A cast whose backward drops the received rows' dK/dV: out, lse and
    dq still agree, dk and dv must not."""
    inputs = _inputs(4, 2, False)
    case = _case(cp, "causal", 0, impl)
    ref = _jax_run(case, inputs, monkeypatch)
    try:
        got = pools[cp].run(workers.keyed_attention, {**case, "skip_reduce": True}, inputs)
    finally:  # the fault is planted in the ranks: do not leave it to later tests
        pools[cp].close()
        pools[cp] = RankPool(cp)
    for name in ("out", "lse", "dq"):
        np.testing.assert_allclose(got[0][name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for name in ("dk", "dv"):
        assert not np.allclose(got[0][name], ref[name], rtol=RTOL, atol=ATOL), name


# bf16 q/k/v against the float32 JAX run: rounding the inputs and the
# outputs to bf16 (8 mantissa bits, 2**-9 relative) moves each result by a
# few 1e-3 in relative L2, and an lse (|lse| < 10 here) by about 1e-2
BF16_REL_L2, BF16_LSE_ATOL = 2e-2, 5e-2


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("high_precision", [False, True], ids=["bf16_reduce", "f32_reduce"])
@pytest.mark.parametrize("degree,impl", [(0, "a2a"), (2, "hops")])
def test_backward_high_precision_reduce(degree, impl, high_precision, pools, monkeypatch):
    """bf16 inputs: the dK/dV reduce of the cast's backward runs in f32
    under ``MAGI_ATTENTION_BACKWARD_HIGH_PRECISION_REDUCE`` (an f32
    payload) and in bf16 without it; either way the results stay within
    bf16 rounding of the float32 JAX run."""
    inputs = _inputs(4, 2, False)
    case = _case(2, "varlen_causal", degree, impl, dtype="bfloat16",
                 high_precision_backward=high_precision)
    got = pools[2].run(workers.keyed_attention, case, inputs)[0]
    ref = _jax_run(_case(2, "varlen_causal", degree, impl), inputs, monkeypatch)
    assert got["reduce_dtypes"] == [f"torch.{'float32' if high_precision else 'bfloat16'}"]
    for name in ("out", "dq", "dk", "dv"):
        assert _rel_l2(got[name], ref[name]) <= BF16_REL_L2, name
    np.testing.assert_allclose(got["lse"], ref["lse"], atol=BF16_LSE_ATOL, err_msg="lse")


# -- the staged path's LSE merge under autograd ------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lse_merge_gradients_match_jax_on_uncovered_rows(dtype):
    """Rows 0-3: both partials covered; 4-5: only the first; 6-7: only the
    second; 8-9: neither (the merged lse stays -inf, every gradient 0,
    nothing NaN). The uncovered partial's out holds garbage (NaN) as a
    kernel's unwritten rows could, which must not leak into the merge or
    its gradients. Tolerance: 1e-5 relative in float32, 1e-12 in float64
    (the same elementwise formulas, evaluated in another order)."""
    rng = np.random.default_rng(3)
    t, h, d = 10, 3, 8
    o1, o2, go = (rng.standard_normal((t, h, d)).astype(dtype) for _ in range(3))
    l1, l2, gl = (rng.standard_normal((t, h)).astype(dtype) for _ in range(3))
    l2[4:6] = -np.inf
    l1[6:8] = -np.inf
    l1[8:] = l2[8:] = -np.inf
    o1[6:] = np.nan
    o2[4:6] = np.nan
    o2[8:] = np.nan

    def jloss(o1, l1, o2, l2):
        o, lse = jax_correct(o1, l1, o2, l2)
        return (o * go).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * gl).sum()

    jo, jl = jax_correct(*map(jnp.asarray, (o1, l1, o2, l2)))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (o1, l1, o2, l2)))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (o1, l1, o2, l2)]
    o, lse = correct_attn_out_lse(*ts)
    loss = (o * torch.from_numpy(go)).sum() + torch.where(
        torch.isneginf(lse), 0.0, lse * torch.from_numpy(gl)).sum()
    loss.backward()
    rtol, atol = (1e-5, 1e-6) if dtype == np.float32 else (1e-12, 1e-12)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=rtol, atol=atol)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), rtol=rtol, atol=atol)
    assert np.isneginf(lse.detach().numpy()[8:]).all()
    for name, x, g in zip(("do1", "dl1", "do2", "dl2"), ts, jg):
        got = x.grad.numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, np.asarray(g), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("impl", ["a2a", "hops"])
@pytest.mark.parametrize("cp", [2, 4])
def test_comm_primitives_and_reduce_is_the_casts_transpose(cp, impl, pools):
    """The variable-size primitives on uneven sizes, the sum of a
    replicated tensor's gradient, and GroupReduce as GroupCast's transpose
    (float64, so the two inner products agree to 1e-12)."""
    got = pools[cp].run(workers.comm_primitives, impl, 7)
    sizes = [3 + 2 * r for r in range(cp)]
    offsets = np.cumsum([0] + sizes)
    for r, res in enumerate(got):
        assert res["impl"] == impl
        want = np.concatenate([np.full((s, 2), float(q)) for q, s in enumerate(sizes)])
        np.testing.assert_array_equal(res["gathered"], want)
        np.testing.assert_array_equal(
            res["scattered"][: sizes[r]], np.arange(offsets[r], offsets[r + 1]))
        assert not res["scattered"][sizes[r]:].any()
        a2a = res["a2a"]
        for src in range(cp):
            np.testing.assert_array_equal(a2a[src], np.arange(r * 4, r * 4 + 4) + 100 * src)
        np.testing.assert_array_equal(res["sink_grad"], np.full(3, cp * (cp + 1) / 2))
        assert res["cast_tail_zero"]
        lhs, rhs = res["adjoint"]
        assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))
