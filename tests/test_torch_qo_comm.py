"""The port's qo-comm against the JAX package's, on the CPU.

Plans, host only: ``build_qo_comm_plan`` on the three cases of the JAX
package's own qo-comm test (causal, a mixed varlen mask and a sliding
window) for the KD, SNF and auto solvers at cp 2 and 4, over the
contiguous shard and over a MinHeap dispatch meta, with both group
collective realisations: the comm metas' routing arrays and the per-rank
kernel tables (``StageTables.arrays()``) byte for byte.

Results, over gloo (``testing.dist.RankPool``) in float32:
``qo_comm_attn_local`` against JAX ``make_qo_comm_attn_fn`` + ``jax.grad``
on its virtual CPU mesh (jnp kernel backend), out, lse, dq, dk, dv and
dsink within rtol 2e-4 / atol 2e-5, the bound ``tests/test_torch_dist_attn.py``
states; the solvers pinned to ones that move Q (at these sizes the auto
solver picks NCQ placement, which moves none), and a mask that leaves rows
uncovered. The keyed API under ``MAGI_ATTENTION_QO_COMM=1`` against JAX's
keyed API under the same flag. A planted O-return reduce that drops the
remote partials must fail the out and lse comparison
(``tests/test_torch_group_reduce_lse.py`` holds the reduce on its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu import meta as jax_meta
from magiattention_tpu.common import AttnMaskType as JaxMaskType
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import (
    make_dispatch_meta_from_qk_ranges as jax_dispatch_meta,
)
from magiattention_tpu.parallel.dist_attn import make_attn_params as jax_make_attn_params
from magiattention_tpu.parallel.qo_comm import build_qo_comm_plan as jax_build_qo_plan
from magiattention_tpu.parallel.qo_comm import make_qo_comm_attn_fn
from magiattention_tpu_torch import meta
from magiattention_tpu_torch.common import AttnMaskType, AttnRanges
from magiattention_tpu_torch.parallel import build_qo_comm_plan
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .test_torch_dist_plan import _same_comm, _same_tables
from .torch_jax_backend import jax_backend

RTOL, ATOL = 2e-4, 2e-5
TOTAL, D, BLOCK = 512, 32, 64


def _window_case():
    qr, kr, ts = jax_api.infer_window_mask_per_range((0, TOTAL), (0, TOTAL), (96, 32))
    return [(q[0], q[1], k[0], k[1], int(t)) for q, k, t in zip(qr, kr, ts)]


PLAN_CASES = {  # the JAX package's tests/test_parallel/test_qo_comm.py cases
    "causal": [(0, TOTAL, 0, TOTAL, 1)],
    "varlen_mixed": [(0, 192, 0, 192, 1), (192, 448, 0, 448, 1), (448, 512, 192, 512, 0)],
    "swa_window": _window_case(),
}
# rows [128, 256) are in no slice: out 0, lse -inf, no gradient
UNCOVERED = [(0, 128, 0, 128, 1), (256, 512, 0, 64, 0), (256, 512, 128, 512, 1)]
SOLVERS = {"kd": "DynamicAttnSolver", "snf": "SNFDynamicSolver", "auto": "AutoDynamicSolver"}


def _split(slices):
    return ([(int(s[0]), int(s[1])) for s in slices], [(int(s[2]), int(s[3])) for s in slices],
            [int(s[4]) for s in slices])


def _dispatch_metas(slices, cp, chunk=32):
    qr, kr, ts = _split(slices)
    jm, _, _ = jax_dispatch_meta(JaxRanges.from_ranges(qr), JaxRanges.from_ranges(kr),
                                 [JaxMaskType(t) for t in ts], TOTAL, TOTAL, chunk, cp)
    pm, _, _ = meta.make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr), [AttnMaskType(t) for t in ts],
        TOTAL, TOTAL, chunk, cp)
    assert pm.partitions == jm.partitions
    return jm, pm


def _same_plan(jp, pp):
    for f in ("cp_size", "shard_len", "q_buf_pad", "kv_buf_pad", "block_q", "block_k",
              "rank_areas"):
        assert getattr(pp, f) == getattr(jp, f), f
    _same_comm(jp.comm_q, pp.comm_q, "comm_q")
    _same_comm(jp.comm_kv, pp.comm_kv, "comm_kv")
    for j, p in zip(jp.comm_q.reduce_device_arrays(), pp.comm_q.reduce_device_arrays()):
        assert np.asarray(j).tobytes() == np.asarray(p).tobytes(), "comm_q reduce arrays"
    _same_tables(jp.tables, pp.tables, "tables")


@pytest.mark.parametrize("impl", ["a2a", "hops"])
@pytest.mark.parametrize("dispatched", [False, True], ids=["contiguous", "minheap"])
@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_is_byte_identical_to_jax(case, solver, cp, dispatched, impl, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
    sl = np.asarray(PLAN_CASES[case], np.int64)
    jm, pm = _dispatch_metas(sl, cp) if dispatched else (None, None)
    jp = jax_build_qo_plan(sl, TOTAL, cp, block_q=BLOCK, block_k=BLOCK,
                           solver=getattr(jax_meta, SOLVERS[solver])(), dispatch_meta=jm)
    pp = build_qo_comm_plan(sl, TOTAL, cp, block_q=BLOCK, block_k=BLOCK,
                            solver=getattr(meta, SOLVERS[solver])(), dispatch_meta=pm)
    _same_plan(jp, pp)
    assert pp.comm_q.impl == pp.comm_kv.impl == impl


def test_plan_checks_its_inputs():
    sl = np.asarray(PLAN_CASES["causal"], np.int64)
    with pytest.raises(ValueError, match="divisible"):
        build_qo_comm_plan(sl, TOTAL + 1, 2)
    with pytest.raises(ValueError, match="within"):
        build_qo_comm_plan(np.asarray([(0, TOTAL, 0, TOTAL + 8, 0)]), TOTAL, 2)


# -- results over gloo against JAX ------------------------------------------------------------


def _inputs(hq, hk, sink, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = dict(q=f(TOTAL, hq, D), k=f(TOTAL, hk, D), v=f(TOTAL, hk, D),
               g_out=f(TOTAL, hq, D), g_lse=f(TOTAL, hq))
    if sink:
        out["sink"] = f(hq)
    return out


def _case(slices, impl, **extra):
    qr, kr, ts = _split(slices)
    return dict(q_ranges=qr, k_ranges=kr, types=ts, total=TOTAL, chunk=64, impl=impl, **extra)


def _mesh(cp):
    return Mesh(np.array(jax.devices()[:cp]), ("cp",))


def _jax_grads(fwd, inputs, has_sink):
    g_out, g_lse = jnp.asarray(inputs["g_out"]), jnp.asarray(inputs["g_lse"])

    def loss(q, k, v, s):
        o, lse = fwd(q, k, v, s)
        return (o * g_out).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * g_lse).sum()

    args = tuple(jnp.asarray(inputs[n]) for n in ("q", "k", "v")) + (
        jnp.asarray(inputs["sink"]) if has_sink else None,)
    out, lse = jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3) if has_sink else (0, 1, 2)))(*args)
    res = dict(out=out, lse=lse, dq=grads[0], dk=grads[1], dv=grads[2])
    if has_sink:
        res["dsink"] = grads[3]
    return {n: np.asarray(x) for n, x in res.items()}


def _jax_local(slices, cp, solver, inputs, monkeypatch, impl):
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
    plan = jax_build_qo_plan(np.asarray(slices, np.int64), TOTAL, cp, block_q=BLOCK,
                             block_k=BLOCK, solver=getattr(jax_meta, SOLVERS[solver])())
    has_sink = "sink" in inputs
    params = jax_make_attn_params(plan, D, out_dtype="float32")
    fn = make_qo_comm_attn_fn(plan, _mesh(cp), params,
                              sink=jnp.asarray(inputs["sink"]) if has_sink else None)
    return _jax_grads(lambda q, k, v, s: fn(q, k, v, s), inputs, has_sink)


@pytest.fixture(scope="module")
def pools():
    pools = {cp: RankPool(cp) for cp in (2, 4)}
    yield pools
    for p in pools.values():
        p.close()


def _assert_close(got, ref, names, cp_results=None):
    for name in names:
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for r, res in enumerate(cp_results or []):  # every rank holds the same global result
        for name in names:
            np.testing.assert_array_equal(res[name], got[name], err_msg=f"{name} rank {r}")


# (cp, mask, impl, solver, (hq, hk), sink)
RESULT_CASES = [
    (2, "varlen_mixed", "a2a", "kd", (2, 2), False),
    (2, "varlen_mixed", "hops", "snf", (4, 2), True),
    (4, "causal", "hops", "kd", (4, 2), False),
    (4, "uncovered", "a2a", "snf", (2, 2), False),
]


def _case_id(c):
    cp, mask, impl, solver, (hq, hk), sink = c
    return f"cp{cp}_{mask}_{impl}_{solver}_g{hq // hk}" + ("_sink" if sink else "")


@pytest.mark.parametrize("c", RESULT_CASES, ids=_case_id)
def test_qo_comm_attn_local_matches_jax(c, pools, monkeypatch):
    cp, mask, impl, solver, (hq, hk), sink = c
    slices = UNCOVERED if mask == "uncovered" else PLAN_CASES[mask]
    inputs = _inputs(hq, hk, sink)
    got = pools[cp].run(workers.qo_attention, _case(slices, impl, solver=solver), inputs)
    ref = _jax_local(slices, cp, solver, inputs, monkeypatch, impl)
    assert got[0]["impls"] == [impl, impl]
    assert got[0]["q_remote_rows"] > 0, "the pinned solver must move Q, or the reduce is idle"
    if mask == "uncovered":
        assert np.isneginf(ref["lse"][128:256]).all() and np.isfinite(ref["lse"][:128]).all()
        assert np.isfinite(got[0]["dq"]).all() and not got[0]["dq"][128:256].any()
    _assert_close(got[0], ref, ("out", "lse", "dq", "dk", "dv") + (("dsink",) if sink else ()),
                  got[1:])


@pytest.mark.parametrize("cp,impl", [(2, "a2a"), (4, "hops")])
def test_qo_comm_over_a_dispatch_meta(cp, impl, pools, monkeypatch):
    """Ownership from a MinHeap dispatch (chunk-permuted): the plane
    partition stays global, the casts and the reduce route over the
    permuted layout; the result is the contiguous plan's."""
    inputs = _inputs(2, 2, True)
    case = _case(PLAN_CASES["varlen_mixed"], impl, solver="kd", dispatch_chunk=32)
    got = pools[cp].run(workers.qo_attention, case, inputs)[0]
    ref = _jax_local(PLAN_CASES["varlen_mixed"], cp, "kd", inputs, monkeypatch, impl)
    assert got["q_remote_rows"] > 0
    _assert_close(got, ref, ("out", "lse", "dq", "dk", "dv", "dsink"))


@pytest.mark.parametrize("cp,impl", [(2, "hops"), (4, "a2a")])
def test_planted_drop_of_remote_partials_is_caught(cp, impl, pools, monkeypatch):
    """An O-return reduce that loses every partial computed on another
    rank: out and lse must fail the comparison."""
    inputs = _inputs(2, 2, False)
    case = _case(PLAN_CASES["varlen_mixed"], impl, solver="kd", drop_remote=True)
    got = pools[cp].run(workers.qo_attention, case, inputs)[0]
    ref = _jax_local(PLAN_CASES["varlen_mixed"], cp, "kd", inputs, monkeypatch, impl)
    for name in ("out", "lse"):
        assert not np.allclose(got[name], ref[name], rtol=RTOL, atol=ATOL), name


@pytest.mark.parametrize("cp,impl,sink", [(2, "a2a", True), (4, "hops", False)])
def test_keyed_qo_comm_matches_jax_keyed(cp, impl, sink, pools, monkeypatch):
    """``MAGI_ATTENTION_QO_COMM=1`` through ``magi_attn_flex_key`` ->
    ``dispatch`` -> ``calc_attn`` -> ``undispatch`` in both packages (the
    auto solver over the MinHeap dispatch meta); the qo key is another key
    than the K/V-comm one."""
    hq, hk = 4, 2
    inputs = _inputs(hq, hk, sink)
    slices = PLAN_CASES["varlen_mixed"]
    got = pools[cp].run(workers.qo_attention, _case(slices, impl, keyed=True), inputs)
    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    monkeypatch.setenv("MAGI_ATTENTION_BLOCK_Q", str(BLOCK))
    monkeypatch.setenv("MAGI_ATTENTION_BLOCK_K", str(BLOCK))
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
    qr, kr, ts = _split(slices)
    key = jax_api.magi_attn_flex_key(
        qr, kr, ts, TOTAL, TOTAL, _mesh(cp), num_heads=(hq, hk), head_dim=D, chunk_size=64,
        out_dtype="float32", sink=jnp.asarray(inputs["sink"]) if sink else None)
    jmgr = jax_api.get_runtime_mgr(key)

    def fwd(q, k, v, s):
        out_d, m = jax_api.calc_attn(*(jax_api.dispatch(x, key) for x in (q, k, v)), key, sink=s)
        return jax_api.undispatch(out_d, key), jax_api.undispatch(m.lse, key)

    ref = _jax_grads(fwd, inputs, sink)
    assert got[0]["plan"] == "QoCommPlan" == type(jmgr.plan).__name__
    assert got[0]["kv_plan"] == "DistAttnPlan" and got[0]["keys_differ"]
    assert got[0]["max_logits"] is None
    assert got[0]["partitions"] == jmgr.dispatch_meta.partitions
    assert got[0]["rank_areas"] == list(jmgr.plan.rank_areas)
    assert got[0]["impls"] == [jmgr.plan.comm_q.impl, jmgr.plan.comm_kv.impl]
    _assert_close(got[0], ref, ("out", "lse", "dq", "dk", "dv") + (("dsink",) if sink else ()),
                  got[1:])
