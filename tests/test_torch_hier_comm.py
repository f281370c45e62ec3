"""The port's hierarchical two-level comm against the JAX package's.

Host: ``HierGroupCollectiveMeta.build`` gives byte-identical routing
arrays, hop plans and ``recv_sources`` at (n_inter, n_intra) = (2, 2), (2,
4) and (4, 2), for the a2a, hops and auto impls, with the same volume
accounting; its two level metas route what the hier arrays route.

Over gloo on the CPU at 2 x 2 (four spawned ranks, ``make_hier_cp_groups``):
the cast equals JAX ``group_cast_hier`` on a (dcn=2, ici=2) CPU mesh, row
for row; the reduce is its transpose (<cast(x), y> = <x, reduce(y)> to
1e-12 in float64, and equal to the dense sum of each partial onto its
source row) and is ``GroupCastHier``'s gradient; planted reduces that sum
pad slots onto row 0, or that skip the gateway's pre-reduce, fail that
oracle. Then the keyed API over the hierarchical groups, forward and
backward, against JAX ``make_dist_attn_fn`` over ``cp_axis=("dcn",
"ici")`` on the jnp backend (float32, rtol 2e-4 / atol 2e-5, the bound of
``tests/test_torch_dist_attn.py``), at degree 0 and 2 with both impls, the
plans byte-identical; and the planted reduces failing dk / dv only
(JAX ``tests/test_comm/test_hier.py`` and
``tests/test_parallel/test_pipeline.py::test_hier_cp_pipeline_2d_mesh``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from magiattention_tpu.comm.hier import HierGroupCollectiveMeta as JaxHierMeta
from magiattention_tpu.comm.hier import group_cast_hier as jax_group_cast_hier
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.parallel.dispatch import dispatch, undispatch
from magiattention_tpu.parallel.dist_attn import (
    build_dist_attn_plan,
    make_attn_params,
    make_dist_attn_fn,
)
from magiattention_tpu.utils.compat import shard_map
from magiattention_tpu_torch.comm import HierGroupCollectiveMeta
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .test_torch_dist_plan import _same, _same_plans, same_hier_meta
from .torch_jax_backend import jax_backend

ROWS = 12
SHAPES = [(2, 2), (2, 4), (4, 2)]


def _send_map(n, seed):
    return workers.hier_send_map(n, ROWS, seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", ["a2a", "hops", "auto"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_hier_meta_is_byte_identical_to_jax(shape, impl, seed):
    n = shape[0] * shape[1]
    smap = _send_map(n, seed)
    jm, jsrc = JaxHierMeta.build(smap, [ROWS] * n, *shape, impl=impl)
    pm, psrc = HierGroupCollectiveMeta.build(smap, [ROWS] * n, *shape, impl=impl)
    same_hier_meta(jm, pm, f"{shape} {impl}")
    assert len(psrc) == len(jsrc) == n
    for d in range(n):
        assert [s for s, _ in psrc[d]] == [s for s, _ in jsrc[d]]
        for (_, pr), (_, jr) in zip(psrc[d], jsrc[d]):
            _same(jr, pr, f"recv_sources[{d}]")
    assert (HierGroupCollectiveMeta.inter_crossing_rows(smap, *shape)
            == JaxHierMeta.inter_crossing_rows(smap, *shape))


@pytest.mark.parametrize("impl", ["a2a", "hops"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_level_metas_route_the_hier_arrays(shape, impl):
    """The two flat level metas the device side runs carry the hier arrays
    unchanged, and their reduce rows come from the pair counts: every pad
    slot holds the level's input-row sentinel, never row 0."""
    n = shape[0] * shape[1]
    smap = _send_map(n, 3)
    pm, _ = HierGroupCollectiveMeta.build(smap, [ROWS] * n, *shape, impl=impl)
    inter, intra = pm.inter_level, pm.intra_level
    assert (inter.cp_size, intra.cp_size) == shape
    assert inter.impl == "a2a" and intra.impl == pm.impl
    r1 = pm.inter_recv_sel.shape[1]
    assert (inter.max_recv, intra.max_recv) == (r1, pm.max_recv)
    assert intra.hops is pm.intra_hops
    for level, send, sentinel in ((inter, pm.inter_send_idx, ROWS),
                                  (intra, pm.intra_send_idx, r1)):
        assert level.send_idx is send
        counts = level.seg_ids < sentinel
        assert (level.seg_ids[~counts] == sentinel).all()
        assert (level.seg_ids[counts] == send[counts]).all()
        # the valid prefix of every pair is as long as the receiver's count
        s = level.max_send
        for src in range(n):
            for j in range(level.cp_size):
                k = int(counts[src, j].sum())
                assert counts[src, j, :k].all() and not counts[src, j, k:].any()
    assert intra.recv_total == pm.recv_total


def _jax_cast(meta, xs, shape):
    """JAX ``group_cast_hier`` on a (dcn, ici) CPU mesh; [n, max_recv, f]."""
    ni, nj = shape
    n = ni * nj
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(ni, nj), ("dcn", "ici"))
    spec = NamedSharding(mesh, P("dcn", "ici"))
    tabs = meta.cast_device_arrays()
    x = jax.device_put(jnp.asarray(np.stack(xs)).reshape((ni, nj) + xs[0].shape), spec)
    tabs = tuple(jax.device_put(jnp.asarray(a).reshape((ni, nj) + a.shape[1:]), spec)
                 for a in tabs)

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("dcn", "ici"),) * (1 + len(tabs)),
                       out_specs=P("dcn", "ici"), check_vma=False)
    def run(x, *tabs):
        flat = tuple(t.reshape((1,) + t.shape[2:]) for t in tabs)
        return jax_group_cast_hier(x[0, 0], flat, meta=meta)[None, None]

    return np.asarray(jax.jit(run)(x, *tabs)).reshape(n, meta.max_recv, -1)


@pytest.fixture(scope="module")
def pool():
    pool = RankPool(4)
    yield pool
    pool.close()


def _dense_reduce(src, ys, n):
    out = [np.zeros((ROWS, 3)) for _ in range(n)]
    for d in range(n):
        pos = 0
        for s, rows in src[d]:
            for j, r in enumerate(rows):
                out[s][r] += ys[d][pos + j]
            pos += len(rows)
    return out


@pytest.mark.parametrize("impl", ["a2a", "hops"])
def test_cast_matches_jax_and_reduce_is_its_transpose(impl, pool):
    shape, seed = (2, 2), 5
    got = pool.run(workers.hier_comm, *shape, impl, seed, ROWS)
    assert [r["groups"] for r in got] == [(2, 0, 2, 0), (2, 0, 2, 1), (2, 1, 2, 0), (2, 1, 2, 1)]
    jm, src = JaxHierMeta.build(_send_map(4, seed), [ROWS] * 4, *shape, impl=impl)
    assert got[0]["impl"] == jm.impl == impl
    ref = _jax_cast(jm, [r["x"] for r in got], shape)
    for r in range(4):
        np.testing.assert_array_equal(got[r]["cast"], ref[r], err_msg=f"cast rank {r}")
    want = _dense_reduce(src, [r["y"] for r in got], 4)
    for r in range(4):
        np.testing.assert_allclose(got[r]["reduce"], want[r], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got[r]["grad"], want[r], rtol=1e-12, atol=1e-12)
    lhs, rhs = got[0]["adjoint"]
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("impl", ["a2a", "hops"])
@pytest.mark.parametrize("plant", ["pad_rows", "no_pre_reduce"])
def test_planted_hier_reduce_is_caught(plant, impl, pool):
    """A reduce that sums the inter level's pad slots onto row 0, or one
    whose gateway keeps a single consumer's partial of a row: the cast is
    untouched, the reduce fails the dense oracle and the adjoint identity."""
    shape, seed = (2, 2), 5
    got = pool.run(workers.hier_comm, *shape, impl, seed, ROWS, plant)
    _, src = JaxHierMeta.build(_send_map(4, seed), [ROWS] * 4, *shape, impl=impl)
    want = _dense_reduce(src, [r["y"] for r in got], 4)
    assert not all(np.allclose(got[r]["reduce"], want[r]) for r in range(4))
    assert not all(np.allclose(got[r]["grad"], want[r]) for r in range(4))
    lhs, rhs = got[0]["adjoint"]
    assert abs(lhs - rhs) > 1e-6


# -- the keyed API over the hierarchical groups ------------------------------------------------

RTOL, ATOL = 2e-4, 2e-5
TOTAL, CHUNK, D = 1024, 64, 32
MIN_STAGE_ROWS = 64
DOCS = [(0, 200), (200, 520), (520, 704), (704, TOTAL)]
MASKS = {
    "varlen_causal": (DOCS, DOCS, [1] * len(DOCS)),
    "causal": ([(0, TOTAL)], [(0, TOTAL)], [1]),
}
KEYED = [("causal", 0, "a2a"), ("varlen_causal", 0, "hops"), ("causal", 2, "hops"),
         ("varlen_causal", 2, "a2a")]


def hier_inputs(hq=4, hk=2, seed=0, total=TOTAL):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(total, hq, D), k=f(total, hk, D), v=f(total, hk, D),
                g_out=f(total, hq, D), g_lse=f(total, hq))


def hier_case(mask, degree, impl, **extra):
    qr, kr, ty = MASKS[mask]
    return dict(q_ranges=qr, k_ranges=kr, types=ty, total=TOTAL, chunk=CHUNK, degree=degree,
                impl=impl, min_stage_rows=MIN_STAGE_ROWS, hier=(2, 2), **extra)


def jax_hier_run(case, inputs, monkeypatch, mask=None):
    """The JAX package's hierarchical cp attention on the same inputs: its
    plan over cp_mesh_shape (2, 2) at the port's tile (for ``mask``: that
    mask over the dispatch of the case's), the jnp kernel backend, forward
    and ``jax.grad`` over a (dcn=2, ici=2) CPU mesh."""
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", case["impl"])
    from magiattention_tpu.common import AttnMaskType as JaxMaskType
    from magiattention_tpu.meta.dispatch_meta import make_global_bucket_from_qk_ranges

    total = case["total"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        JaxRanges.from_ranges(case["q_ranges"]), JaxRanges.from_ranges(case["k_ranges"]),
        case["types"], total, total, chunk_size=CHUNK, cp_size=4)
    if mask is not None:
        bucket = make_global_bucket_from_qk_ranges(
            JaxRanges.from_ranges(mask[0]), JaxRanges.from_ranges(mask[1]),
            [JaxMaskType(t) for t in mask[2]], total, CHUNK)
    plan = build_dist_attn_plan(
        mq, bucket, block_q=64, block_k=64, cp_mesh_shape=(2, 2),
        overlap_config=JaxOverlapConfig(degree=case["degree"], min_stage_rows=MIN_STAGE_ROWS))
    params = make_attn_params(plan, D, out_dtype="float32")
    fn = make_dist_attn_fn(plan, mesh, params, axis_name=("dcn", "ici"))
    shard = NamedSharding(mesh, P(("dcn", "ici")))
    g_out, g_lse = jnp.asarray(inputs["g_out"]), jnp.asarray(inputs["g_lse"])

    def fwd(q, k, v):
        qd, kd, vd = (jax.lax.with_sharding_constraint(dispatch(x, mq), shard) for x in (q, k, v))
        out_d, lse_d = fn(qd, kd, vd)
        return undispatch(out_d, mq), undispatch(lse_d, mq)

    def loss(q, k, v):
        o, lse = fwd(q, k, v)
        return (o * g_out).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * g_lse).sum()

    args = tuple(jnp.asarray(inputs[n]) for n in ("q", "k", "v"))
    out, lse = jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    res = dict(out=out, lse=lse, dq=grads[0], dk=grads[1], dv=grads[2])
    return {**{n: np.asarray(x) for n, x in res.items()}, "plan": plan,
            "partitions": mq.partitions}


@pytest.mark.parametrize("mask,degree,impl", KEYED, ids=lambda x: str(x))
def test_hier_keyed_attention_matches_jax(mask, degree, impl, pool, monkeypatch):
    inputs = hier_inputs()
    case = hier_case(mask, degree, impl, return_plan=True)
    got = pool.run(workers.keyed_attention, case, inputs)
    ref = jax_hier_run(case, inputs, monkeypatch)
    assert got[0]["hier"] == got[0]["key_hier"] == (2, 2)
    assert got[0]["partitions"] == ref["partitions"]
    assert set(got[0]["impls"]) == {impl}
    _same_plans(None, None, ref["plan"], got[0]["plan"], degree)
    assert got[0]["plan"].hier == ref["plan"].hier == (2, 2)
    for name in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[0][name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
        for r in range(1, 4):
            np.testing.assert_array_equal(got[r][name], got[0][name], err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("plant", ["pad_rows", "no_pre_reduce"])
def test_planted_hier_reduce_fails_dk_dv_only(plant, pool, monkeypatch):
    """The planted reduces under the keyed attention: out, lse and dq still
    agree with JAX, dk and dv must not."""
    inputs = hier_inputs()
    case = hier_case("causal", 0, "a2a")
    got = pool.run(workers.keyed_attention, {**case, "hier_plant": plant}, inputs)[0]
    ref = jax_hier_run(case, inputs, monkeypatch)
    for name in ("out", "lse", "dq"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for name in ("dk", "dv"):
        assert not np.allclose(got[name], ref[name], rtol=RTOL, atol=ATOL), name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_node_crossing_rows(shape):
    """``node_crossing_rows`` of a hier meta is JAX's ``inter_crossing_rows``
    of its send map, and a flat meta's counts every row between nodes; on
    a map where a node's ranks share rows the dedup moves fewer."""
    from magiattention_tpu_torch.comm import GroupCollectiveMeta, node_crossing_rows

    n = shape[0] * shape[1]
    smap = _send_map(n, 2)
    for d in range(shape[1]):  # every rank of node 1 needs rank 0's rows 0-5
        smap[0][shape[1] + d] = np.arange(6)
    hier, _ = HierGroupCollectiveMeta.build(smap, [ROWS] * n, *shape)
    flat = GroupCollectiveMeta.build(smap, [ROWS] * n)
    want_flat = sum(len(smap[s][d]) for s in range(n) for d in range(n)
                    if s // shape[1] != d // shape[1])
    assert node_crossing_rows(flat, *shape) == want_flat
    assert node_crossing_rows(hier, *shape) == JaxHierMeta.inter_crossing_rows(smap, *shape)
    assert node_crossing_rows(hier, *shape) < want_flat
