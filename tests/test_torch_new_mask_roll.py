"""Two keyed-API variants against the JAX package's: a new mask on an
existing dispatch, and ``roll``.

``make_flex_key_for_new_mask_after_dispatch`` (a per-document sliding
window on the dispatch of a varlen-causal key, flat at cp=4 and
hierarchical at 2 x 2, overlap degree 0 and 2) over gloo on the CPU: the
new key's plan byte-identical to the one JAX's
``make_flex_key_for_new_mask_after_dispatch`` plans (both at the 64 x 64
tile through the ``MAGI_ATTENTION_BLOCK_Q/_K`` pins), the dispatch and a
hierarchical layout inherited, and out / lse / dq / dk / dv against JAX's
keyed path on the jnp backend within rtol 2e-4 / atol 2e-5 in float32.

``api.roll`` of dispatched integer labels by 1, -1, 300 and 4097 over
flat cp 2 and 4, a 2 x 2 hierarchical key and an uneven shard: exactly
``dispatch(torch.roll(labels))`` on every rank, exactly JAX ``roll`` of
the dispatched global tensor, pad slots keeping their value; and the
gradient of a float roll exactly the reverse roll of the cotangent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.config import DistAttnConfig as JaxDistAttnConfig
from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges as jax_meta
from magiattention_tpu.meta.solver.dispatch_solver import DispatchConfig as JaxDispatchConfig
from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig
from magiattention_tpu.parallel.dispatch import dispatch as jax_dispatch
from magiattention_tpu.parallel.dispatch import roll as jax_roll
from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .test_torch_dist_plan import _same_plans
from .torch_jax_backend import jax_backend

RTOL, ATOL = 2e-4, 2e-5
TOTAL, CHUNK, D = 1024, 64, 32
CU = [0, 200, 520, 704, TOTAL]
DOCS = [(CU[i], CU[i + 1]) for i in range(len(CU) - 1)]
WINDOW = 128


def _window_mask():
    qr, kr, ty = infer_attn_mask_from_cu_seqlens(CU, causal=False, window_size=(WINDOW, 0))
    return ([r.to_naive_range() for r in qr], [r.to_naive_range() for r in kr],
            [int(t) for t in ty])


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(TOTAL, 4, D), k=f(TOTAL, 2, D), v=f(TOTAL, 2, D), g_out=f(TOTAL, 4, D),
                g_lse=f(TOTAL, 4))


def _jax_new_mask_run(hier, degree, impl, inputs, monkeypatch):
    """JAX: the varlen-causal key, then the window mask's key on its
    dispatch, forward and ``jax.grad`` through the keyed path."""
    jax_backend(monkeypatch)
    for name, val in (("MAGI_ATTENTION_BLOCK_Q", "64"),
                      ("MAGI_ATTENTION_BLOCK_K", "64"), ("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)):
        monkeypatch.setenv(name, val)
    devs = np.array(jax.devices()[:4])
    if hier:
        mesh, cp_axis = Mesh(devs.reshape(2, 2), ("dcn", "ici")), ("dcn", "ici")
    else:
        mesh, cp_axis = Mesh(devs, ("cp",)), "cp"
    old = jax_api.magi_attn_flex_key(
        DOCS, DOCS, [1] * len(DOCS), TOTAL, TOTAL, mesh, num_heads=(4, 2), head_dim=D,
        chunk_size=CHUNK, cp_axis=cp_axis, out_dtype="float32",
        dist_attn_config=JaxDistAttnConfig(
            overlap_config=JaxOverlapConfig(degree=degree, min_stage_rows=64)))
    key = jax_api.make_flex_key_for_new_mask_after_dispatch(*_window_mask(), old)
    g_out, g_lse = jnp.asarray(inputs["g_out"]), jnp.asarray(inputs["g_lse"])

    def fwd(q, k, v):
        out_d, meta = jax_api.calc_attn(*(jax_api.dispatch(x, key) for x in (q, k, v)), key)
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
            "plan": mgr.plan, "partitions": mgr.dispatch_meta.partitions}


@pytest.fixture(scope="module")
def pools():
    pools = {cp: RankPool(cp) for cp in (2, 4)}
    yield pools
    for p in pools.values():
        p.close()


@pytest.mark.parametrize("hier,degree,impl", [(False, 0, "a2a"), (False, 2, "hops"),
                                              (True, 0, "hops"), (True, 2, "a2a")],
                         ids=["flat_d0_a2a", "flat_d2_hops", "hier_d0_hops", "hier_d2_a2a"])
def test_new_mask_key_matches_jax(hier, degree, impl, pools, monkeypatch):
    inputs = _inputs()
    case = dict(q_ranges=DOCS, k_ranges=DOCS, types=[1] * len(DOCS), total=TOTAL, chunk=CHUNK,
                degree=degree, impl=impl, min_stage_rows=64, new_mask=_window_mask(),
                return_plan=True, hier=(2, 2) if hier else None)
    got = pools[4].run(workers.keyed_attention, case, inputs)
    ref = _jax_new_mask_run(hier, degree, impl, inputs, monkeypatch)
    g0 = got[0]
    assert g0["partitions"] == ref["partitions"]
    assert g0["hier"] == g0["key_hier"] == ((2, 2) if hier else None)
    _same_plans(None, None, ref["plan"], g0["plan"], degree)
    for name in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_allclose(g0[name], ref[name], rtol=RTOL, atol=ATOL, err_msg=name)


def test_new_mask_key_never_takes_another_dispatchs_runtime(pools):
    """A key for the window mask W on the varlen-causal dispatch A must not
    be W's own key (a different permutation), nor W's key on the dispatch
    of the one-document causal mask B, even with W's own runtime cached
    first; attention on it over A-dispatched activations is W's."""
    inputs = _inputs(seed=3)
    masks = {"w": _window_mask(), "a": (DOCS, DOCS, [1] * len(DOCS)),
             "b": ([(0, TOTAL)], [(0, TOTAL)], [1]), "chunk": CHUNK}
    got = pools[2].run(workers.new_mask_key_origin, masks, inputs)
    for r in got:
        parts = r["partitions"]
        assert parts["w"] != parts["a"] and parts["a"] != parts["b"]  # three dispatches
        assert r["own_vs_on_a_differ"] and r["on_a_vs_on_b_differ"]
        assert r["chained_is_on_a"] and r["dispatch_inherited"]
        for name in ("out_on_a", "out_on_b"):
            np.testing.assert_allclose(r[name], r["out_own"], rtol=RTOL, atol=ATOL, err_msg=name)


# -- roll -----------------------------------------------------------------------------------

SHIFTS = [1, -1, 300, 4097]
UNEVEN_TOTAL = 17 * CHUNK
ROLL_CASES = {  # name -> (cp, hier, uneven, impl)
    "cp2_a2a": (2, None, False, "a2a"),
    "cp4_hops": (4, None, False, "hops"),
    "hier2x2_a2a": (4, (2, 2), False, "a2a"),
    "cp4_uneven_hops": (4, None, True, "hops"),
}


@pytest.mark.parametrize("name", sorted(ROLL_CASES))
def test_roll_is_exact(name, pools):
    cp, hier, uneven, impl = ROLL_CASES[name]
    total = UNEVEN_TOTAL if uneven else TOTAL
    docs = [(0, 200), (200, 520), (520, 704), (704, total)]
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 32000, total).astype(np.int64)
    x = rng.standard_normal((total, 3)).astype(np.float64)
    g = rng.standard_normal((total, 3)).astype(np.float64)
    case = dict(q_ranges=docs, k_ranges=docs, types=[1] * 4, total=total, chunk=CHUNK,
                impl=impl, hier=hier, uneven=uneven)
    got = pools[cp].run(workers.roll_labels, case, SHIFTS, labels, x, g)
    jm, _, _ = jax_meta(JaxRanges.from_ranges(docs), JaxRanges.from_ranges(docs), [1] * 4, total,
                        total, CHUNK, cp, dispatch_config=JaxDispatchConfig(uneven_shard=uneven))
    assert got[0]["partitions"] == jm.partitions
    assert jm.is_uneven == uneven
    for shift in SHIFTS:
        want_global = np.roll(labels, shift)
        # dispatch of the rolled labels, pad slots -7 as dispatched
        want_local = np.asarray(jax_dispatch(jnp.asarray(want_global), jm, pad_value=-7))
        ref = np.asarray(jax_roll(jax_dispatch(jnp.asarray(labels), jm, pad_value=-7), jm, shift))
        got_local = np.concatenate([r["rolled"][shift]["local"] for r in got])
        np.testing.assert_array_equal(got_local, want_local, err_msg=f"shift {shift}")
        np.testing.assert_array_equal(got_local, ref, err_msg=f"shift {shift} vs JAX roll")
        for r in got:
            np.testing.assert_array_equal(r["rolled"][shift]["global"], want_global)
            assert r["rolled"][shift]["simple_equal"]
    if uneven:
        pads = np.concatenate([r["dispatched"] for r in got]) == -7
        assert pads.any() and (got_local[pads] == -7).all()
    for r in got:
        np.testing.assert_array_equal(r["x_rolled"], np.roll(x, SHIFTS[0], axis=0))
        np.testing.assert_array_equal(r["x_grad"], np.roll(g, -SHIFTS[0], axis=0))


def test_roll_plan_moves_only_the_rank_crossing_rows():
    """The host plan of a roll by 1 over cp=4: one received row per chunk
    boundary whose neighbour lives on another rank, and the local sources
    plus the received slots cover every slot once."""
    from magiattention_tpu_torch.common import AttnMaskType, AttnRanges
    from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu_torch.parallel import roll_plan

    meta, _, _ = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(DOCS), AttnRanges.from_ranges(DOCS), [AttnMaskType(1)] * 4,
        TOTAL, TOTAL, CHUNK, 4)
    local_src, recv_slots, comm = roll_plan(meta, 1)
    perm = meta.perm_idx.reshape(4, -1)
    crossing = 0
    for r in range(4):
        starts = perm[r][::CHUNK]  # each chunk's first position reads the previous one
        owner = {int(p): rr for rr in range(4) for p in perm[rr]}
        crossing += sum(owner[(int(s) - 1) % TOTAL] != r for s in starts)
    assert sum(comm.recv_total) == sum(len(s) for s in recv_slots) == crossing
    assert roll_plan(meta, 1) is roll_plan(meta, 1)  # cached per (meta, shift)
    for r in range(4):  # a received slot's local source is the placeholder 0
        assert (local_src[r][recv_slots[r]] == 0).all()
