"""The port's cp baselines (``parallel/baselines/``: ring, Ulysses, hybrid
DCP at cp 2, USP and the double ring at 2 x 2; one gloo process per rank on
the CPU) against the JAX package's ``make_*_attn_fn`` on the CPU mesh, on
the jnp backend in float32, on JAX's test masks (causal 512, varlen 200 /
312) at hq 4 / hk 2 / d 64, both packages at the 64 x 64 tile: each rank's
host tables byte for byte, out and lse within 3e-5, and dq / dk / dv of
sum(out * g_out) + sum(lse * g_lse) within 1e-4 (the JAX package's own
bounds, ``tests/test_parallel/test_baselines.py``). Then the zigzag
dispatch, single-device NSA within 5e-5 of JAX's, USP-NSA at cp 2 within
3e-5 of single-device NSA, and the refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu.ops.flex_attn import FlexAttnParams as JaxParams
from magiattention_tpu.parallel import baselines as jbl
from magiattention_tpu_torch.parallel import baselines as bl
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

C = 1  # AttnMaskType.CAUSAL
MASKS = {
    "causal": (512, [(0, 512, 0, 512, C)]),
    "varlen": (512, [(0, 200, 0, 200, C), (200, 512, 200, 512, C)]),
}
RUNS = {  # kind -> the layout: cp, or (outer, inner)
    "ring": dict(cp=2),
    "ulysses": dict(cp=2),
    "hybrid_dcp": dict(cp=2),
    "usp": dict(outer=2, inner=2),  # (ring, ulysses)
    "double_ring": dict(outer=2, inner=2),
}
HQ, HK, D = 4, 2, 64
OUT_TOL, GRAD_TOL = 3e-5, 1e-4
NSA_CFG = dict(block=64, topk=2, window=128)


def _inputs(total: int, seed: int = 0, hq: int = HQ, hk: int = HK, d: int = D) -> dict:
    rng = np.random.default_rng(seed)
    shapes = dict(q=(total, hq, d), k=(total, hk, d), v=(total, hk, d), g_out=(total, hq, d),
                  g_lse=(total, hq))
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}


def _jax_fn(kind: str, total: int, slices: np.ndarray, layout: dict):
    """The JAX baseline as f(q, k, v) -> (out, lse) on global arrays."""
    params = JaxParams(block_q=64, block_k=64, scale=float(1.0 / np.sqrt(D)), softcap=0.0,
                       has_sink=False, out_dtype="float32", interpret=True)
    devs = np.array(jax.devices())
    if kind in ("usp", "double_ring"):
        ro, ri = layout["outer"], layout["inner"]
        names = ("ring", "ulysses") if kind == "usp" else ("ring_out", "ring_in")
        mesh = Mesh(devs[:ro * ri].reshape(ro, ri), names)
        if kind == "usp":
            plan = jbl.build_usp_plan(slices, total, ri, ro, block_q=64, block_k=64)
            return jbl.make_usp_attn_fn(plan, mesh, params), plan.ring_plan.steps
        plan = jbl.build_double_ring_plan(slices, total, ro, ri, block_q=64, block_k=64)
        return jbl.make_double_ring_attn_fn(plan, mesh, params), plan.steps
    cp = layout["cp"]
    mesh = Mesh(devs[:cp], ("cp",))
    if kind == "ring":
        plan = jbl.build_ring_attn_plan(slices, total, cp, block_q=64, block_k=64)
        return jbl.make_ring_attn_fn(plan, mesh, params), plan.steps
    if kind == "ulysses":
        plan = jbl.build_ulysses_plan([tuple(s[:2]) for s in slices],
                                      [tuple(s[2:4]) for s in slices],
                                      [int(s[4]) for s in slices], total, cp,
                                      block_q=64, block_k=64)
        return jbl.make_ulysses_attn_fn(plan, mesh, params), plan.meta
    plan = jbl.build_hybrid_dcp_plan(slices, total, cp, block_q=64, block_k=64)
    fn = jbl.make_hybrid_dcp_attn_fn(plan, mesh, params)

    def full(q, k, v):
        out, lse = fn(*(jbl.zigzag_dispatch(x, total, cp) for x in (q, k, v)))
        return (jbl.zigzag_undispatch(out, total, cp), jbl.zigzag_undispatch(lse, total, cp))

    return full, plan.tables


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        for kind, layout in RUNS.items():
            for mask, (total, slices) in MASKS.items():
                sl = np.asarray(slices, np.int64)
                fn, tables = _jax_fn(kind, total, sl, layout)
                x = _inputs(total)
                q, k, v = (jnp.asarray(x[n]) for n in ("q", "k", "v"))
                (o, lse), vjp = jax.vjp(jax.jit(fn), q, k, v)
                dq, dk, dv = vjp((jnp.asarray(x["g_out"]), jnp.asarray(x["g_lse"])))
                out[(kind, mask)] = {"out": np.asarray(o), "lse": np.asarray(lse),
                                     "dq": np.asarray(dq), "dk": np.asarray(dk),
                                     "dv": np.asarray(dv), "tables": tables}
    return out


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    with RankPool(2) as pool2, RankPool(4) as pool4:
        for kind, layout in RUNS.items():
            pool = pool2 if "cp" in layout else pool4
            for mask, (total, slices) in MASKS.items():
                res = pool.run(workers.baseline_attn, kind,
                               dict(total=total, slices=slices, **layout), _inputs(total))
                out[(kind, mask)] = res[0]
        out["usp_nsa"] = pool2.run(workers.baseline_attn, "usp_nsa",
                                   dict(total=512, slices=MASKS["causal"][1], nsa=NSA_CFG),
                                   _inputs(512, seed=9, hq=4, hk=4, d=32))[0]
    return out


CASES = [(kind, mask) for kind in RUNS for mask in MASKS]
IDS = [f"{kind}-{mask}" for kind, mask in CASES]


def _same_tables(got, want) -> None:
    if isinstance(got, tuple):  # per-step StageTables
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tables(g, w)
        return
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype and a.tobytes() == np.asarray(b).tobytes(), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind,mask", CASES, ids=IDS)
def test_host_tables_are_byte_identical(kind, mask, jax_runs, port_runs):
    _same_tables(port_runs[(kind, mask)]["tables"], jax_runs[(kind, mask)]["tables"])


@pytest.mark.parametrize("kind,mask", CASES, ids=IDS)
def test_out_and_lse_match_jax(kind, mask, jax_runs, port_runs):
    got, want = port_runs[(kind, mask)], jax_runs[(kind, mask)]
    for name in ("out", "lse"):
        np.testing.assert_allclose(got[name], want[name], rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind,mask", CASES, ids=IDS)
def test_gradients_match_jax(kind, mask, jax_runs, port_runs):
    got, want = port_runs[(kind, mask)], jax_runs[(kind, mask)]
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("cp", [2, 4])
def test_zigzag_dispatch_equals_jax(cp):
    x = np.arange(512 * 3, dtype=np.float32).reshape(512, 3)
    want = np.asarray(jbl.zigzag_dispatch(jnp.asarray(x), 512, cp))
    got = bl.zigzag_dispatch(torch.from_numpy(x), 512, cp)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bl.zigzag_undispatch(got, 512, cp).numpy(), x)


@pytest.fixture(scope="module")
def nsa_single():
    """Single-device NSA on USP-NSA's inputs: the port's and JAX's."""
    x = _inputs(512, seed=9, hq=4, hk=4, d=32)
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        want = np.asarray(jbl.nsa_attn(*(jnp.asarray(x[n]) for n in ("q", "k", "v")),
                                       jbl.NsaConfig(**NSA_CFG)))
    got = bl.nsa_attn(*(torch.from_numpy(x[n]) for n in ("q", "k", "v")),
                      bl.NsaConfig(**NSA_CFG)).numpy()
    return got, want


def test_nsa_attn_matches_jax(nsa_single):
    got, want = nsa_single
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_nsa_gqa_matches_jax():
    """GQA (hq 4 / hk 2) with every block selected (``topk`` = all)."""
    x = _inputs(256, seed=7, hq=4, hk=2, d=32)
    cfg = dict(block=64, topk=4, window=128)
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        want = np.asarray(jbl.nsa_attn(*(jnp.asarray(x[n]) for n in ("q", "k", "v")),
                                       jbl.NsaConfig(**cfg)))
    got = bl.nsa_attn(*(torch.from_numpy(x[n]) for n in ("q", "k", "v")), bl.NsaConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)


def test_usp_nsa_matches_single_device(nsa_single, port_runs):
    np.testing.assert_allclose(port_runs["usp_nsa"]["out"], nsa_single[0], rtol=3e-5,
                               atol=3e-5)


def test_ulysses_needs_heads_divisible_by_cp():
    from magiattention_tpu_torch.comm.group_collective import DryGroup

    plan = bl.build_ulysses_plan([(0, 512)], [(0, 512)], [C], 512, 4, block_q=64, block_k=64)
    params = dataclasses.replace(_params(), out_dtype=torch.float32)
    fn = bl.make_ulysses_attn_fn(plan, DryGroup(0, 4), params)
    q = torch.zeros(128, 4, D)
    with pytest.raises(ValueError, match="Ulysses needs heads divisible by cp: hq=4 hk=2 cp=4"):
        fn(q, torch.zeros(128, 2, D), torch.zeros(128, 2, D))


def test_plans_take_the_kernel_tile_by_default():
    """JAX's builders default to 128 x 128, which the flex kernels refuse;
    the port's take ``resolve_tile``'s 64 x 64."""
    sl = np.asarray(MASKS["causal"][1], np.int64)
    assert bl.build_ring_attn_plan(sl, 512, 2).block_q == 64
    assert bl.build_hybrid_dcp_plan(sl, 512, 2).tables.kv_pad == 512
    assert bl.build_ulysses_plan([(0, 512)], [(0, 512)], [C], 512, 2).meta.block_k == 64


def _params():
    from magiattention_tpu_torch.ops.flex_attn import FlexAttnParams

    return FlexAttnParams(block_q=64, block_k=64, scale=0.125, softcap=0.0, has_sink=False,
                          out_dtype=torch.float32)
