"""The port's flex-attention forward (plain version, CPU) against the JAX
package's ``flex_flash_attn_func``: in Pallas interpret mode pinned to the
row-major grid with head_block=1 and 64x64 tiles (the path that reaches
``_fwd_pallas``), and under the jnp reference backend. Same float32 inputs
from a numpy seed; out and lse within the float32 row of
``telemetry.numerics.DEFAULT_BUDGETS``, max-logits within its lse bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu.testing import ref_attn_from_ranges as jax_ref
from magiattention_tpu_torch.ops import flex_attn_with_meta, flex_flash_attn_func
from magiattention_tpu_torch.ops.block_meta import Run, build_block_meta_general
from magiattention_tpu_torch.testing import ref_attn_from_ranges
from tests.torch_jax_backend import jax_backend

F, C, I, B = 0, 1, 2, 3
BUDGET = DEFAULT_BUDGETS["float32"]

# (name, tq, tk, q_ranges, k_ranges, types, hq, hk, d, options)
CASES = [
    ("causal_gqa", 192, 192, [(0, 192)], [(0, 192)], [C], 4, 2, 32, {}),
    ("varlen_causal_softcap", 200, 200, [(0, 70), (70, 150), (150, 200)],
     [(0, 70), (70, 150), (150, 200)], [C, C, C], 4, 2, 32, {"softcap": 5.0}),
    ("full_inv_bi", 192, 192, [(0, 64), (64, 128), (128, 192)],
     [(0, 192), (0, 128), (32, 192)], [F, I, B], 4, 1, 64, {}),
    ("continuation", 64, 200, [(0, 64)], [(0, 200)], [C], 4, 2, 32, {}),
    ("uncovered_rows_sink", 160, 160, [(20, 100)], [(0, 90)], [C], 4, 2, 32,
     {"sink": [0.5, -1.0, 2.0, 0.0]}),
    ("uncovered_rows", 130, 130, [(0, 60)], [(0, 60)], [F], 2, 2, 64, {}),
]


def _inputs(seed, tq, tk, hq, hk, d):
    """q, k normal; v positive, so that outputs (convex combinations of v)
    stay away from zero, where the budget's ulp and relative bounds would
    measure two float32 summation orders rather than the algorithm."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((tk, hk, d)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (tk, hk, d)).astype(np.float32)
    return q, k, v


def _check(jax_out, jax_lse, jax_max, out, lse, mx):
    report = divergence_report(
        np.asarray(jax_out), out.numpy(), ref_lse=np.asarray(jax_lse), test_lse=lse.numpy()
    )
    assert_within_budget(report, BUDGET)
    jm, tm = np.asarray(jax_max), mx.numpy()
    np.testing.assert_array_equal(np.isneginf(jm), np.isneginf(tm))
    fin = np.isfinite(jm)
    np.testing.assert_allclose(tm[fin], jm[fin], atol=BUDGET.lse_max_abs, rtol=0)


@pytest.mark.parametrize("backend", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case, backend, monkeypatch):
    _, tq, tk, qr, kr, ty, hq, hk, d, opts = case
    q, k, v = _inputs(7, tq, tk, hq, hk, d)
    softcap = opts.get("softcap", 0.0)
    sink = opts.get("sink")
    jax_kw = dict(block_q=64, block_k=64, head_block=1, grid="row_major")
    if backend == "jnp":
        jax_backend(monkeypatch)
    else:
        jax_kw["interpret"] = True
    jo, jl, jm = jax_flex(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qr, kr, ty,
        softcap=softcap,
        sink=None if sink is None else jnp.asarray(np.asarray(sink, np.float32)),
        return_max_logits=True,
        **jax_kw,
    )
    out, lse, mx = flex_flash_attn_func(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), qr, kr, ty,
        softcap=softcap,
        sink=None if sink is None else torch.tensor(sink),
        return_max_logits=True,
    )
    assert out.shape == (tq, hq, d) and lse.shape == (tq, hq) and mx.shape == (hq,)
    _check(jo, jl, jm, out, lse, mx)


def test_uncovered_rows_contract():
    """An uncovered row gives out=0 and lse=-inf, or lse=sink with a sink."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 128, 128, 2, 1, 32))
    out, lse = flex_flash_attn_func(q, k, v, [(0, 50)], [(0, 50)], [C])
    assert (out[50:] == 0).all() and torch.isneginf(lse[50:]).all()
    sink = torch.tensor([0.25, -2.0])
    out, lse = flex_flash_attn_func(q, k, v, [(0, 50)], [(0, 50)], [C], sink=sink)
    assert (out[50:] == 0).all()
    assert torch.equal(lse[50:], sink.expand(78, 2))


def test_tile_choice_does_not_change_result():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 150, 150, 4, 2, 32))
    a = flex_flash_attn_func(q, k, v, [(0, 150)], [(0, 150)], [C], block_q=32, block_k=64)
    b = flex_flash_attn_func(q, k, v, [(0, 150)], [(0, 150)], [C])
    torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(a[1], b[1], atol=1e-6, rtol=1e-6)


def test_oracle_matches_jax_oracle():
    q, k, v = _inputs(5, 96, 128, 4, 2, 32)
    qr, kr, ty = [(0, 48), (48, 96)], [(0, 128), (16, 100)], [C, I]
    sink = np.asarray([0.1, 0.2, -0.3, 1.0], np.float32)
    jo, jl, jm = jax_ref(
        jnp.asarray(q, jnp.float64), jnp.asarray(k, jnp.float64), jnp.asarray(v, jnp.float64),
        qr, kr, ty, softcap=3.0, sink=jnp.asarray(sink), compute_dtype=jnp.float64,
    )
    o, lse, mx = ref_attn_from_ranges(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), qr, kr, ty,
        softcap=3.0, sink=torch.from_numpy(sink),
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-12, rtol=1e-10)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-12, rtol=1e-10)
    np.testing.assert_allclose(mx.numpy(), np.asarray(jm), atol=1e-12, rtol=1e-10)


def test_plain_forward_matches_fp64_oracle():
    q, k, v = (torch.from_numpy(x).double() for x in _inputs(6, 140, 140, 4, 2, 32))
    qr, kr, ty = [(0, 60), (60, 140)], [(0, 60), (0, 140)], [C, C]
    out, lse = flex_flash_attn_func(q, k, v, qr, kr, ty)
    ro, rl, _ = ref_attn_from_ranges(q, k, v, qr, kr, ty)
    torch.testing.assert_close(out, ro, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(lse, rl, atol=1e-12, rtol=1e-10)


def test_plain_forward_over_permuted_runs_matches_oracle():
    """Local buffers holding global segments out of order: the plain version
    evaluates the global mask through the tables' run offsets."""
    qg, kg, vg = (torch.from_numpy(x).double() for x in _inputs(8, 200, 200, 4, 2, 32))
    qr, kr, ty = [(0, 96), (96, 150), (150, 200)], [(0, 96), (0, 150), (20, 180)], [C, F, B]
    q_runs, k_runs = [(0, 100, 60), (60, 0, 70), (130, 160, 40)], [(0, 120, 80), (80, 0, 120)]
    q_idx = torch.cat([torch.arange(g, g + n) for _, g, n in q_runs])
    k_idx = torch.cat([torch.arange(g, g + n) for _, g, n in k_runs])
    slices = np.concatenate([np.asarray(qr), np.asarray(kr), np.asarray(ty)[:, None]], axis=1)
    meta = build_block_meta_general(slices, [Run(*r) for r in q_runs],
                                    [Run(*r) for r in k_runs], 170, 200,
                                    block_q=32, block_k=64)
    out, lse = flex_attn_with_meta(qg[q_idx], kg[k_idx], vg[k_idx], meta)
    ro, rl, _ = ref_attn_from_ranges(qg, kg, vg, qr, kr, ty)
    torch.testing.assert_close(out, ro[q_idx], atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(lse, rl[q_idx], atol=1e-12, rtol=1e-10)


def test_non_cpu_non_cuda_tensors_raise():
    q = torch.empty((64, 2, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        flex_flash_attn_func(q, q[:, :1], q[:, :1], [(0, 64)], [(0, 64)], [C])


# the kernels' argument checks, with the launch recorded instead of run (the
# CPU has no card): what each of the eight flex kernels takes

_ROW_MAJOR = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv")
_SPARSE = ("flex_fwd_sparse", "flex_fwd_sparse_hb", "flex_dq_sparse", "flex_dkv_sparse")


def _launch_recorded(kernel, d, dtype, monkeypatch, kv_dtype=None):
    """Call ``kernel``'s wrapper on CPU tensors of head_dim ``d`` and
    ``dtype`` (k and v of ``kv_dtype``, default ``dtype``; a causal 256-token
    mask, 4 q / 2 kv heads, the 64 x 64 tile) with ``csrc.launch`` recorded;
    returns the recorded (name, args)."""
    import dataclasses
    import types as pytypes

    from magiattention_tpu_torch.ops import flex_attn as fa

    t, hq, hk = 256, 4, 2
    meta = fa.build_block_meta([(0, t)], [(0, t)], [C], t, t, block_q=64, block_k=64)
    q, do = (torch.zeros((hq, t, d), dtype=dtype) for _ in range(2))
    k, v = (torch.zeros((hk, t, d), dtype=kv_dtype or dtype) for _ in range(2))
    lse, delta, sink = torch.zeros((hq, t)), torch.zeros((hq, t)), torch.zeros(hq)
    grid = "sparse" if kernel in _SPARSE else "row_major"
    hb = 2 if kernel.endswith("_hb") else 1
    params = fa.FlexAttnParams(64, 64, d ** -0.5, 0.0, False, dtype, hb, grid)
    ftab, btab = fa.fwd_tables(meta, "cpu"), fa.bwd_tables(meta, "cpu")
    work = fa.sparse_work(meta, "cpu", hq, hk, hb)
    calls = []
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: pytypes.SimpleNamespace(cuda_stream=0))
    run = {
        "flex_fwd": lambda: fa._fwd_kernel(q, k, v, sink, ftab, params),
        "flex_fwd_hb": lambda: fa._fwd_hb_kernel(q, k, v, sink, ftab, params),
        "flex_dq": lambda: fa._dq_kernel(q, k, v, do, lse, delta, ftab, params),
        "flex_dkv": lambda: fa._dkv_kernel(q, k, v, do, lse, delta, btab, params),
        "flex_fwd_sparse": lambda: fa._fwd_sparse_kernel(q, k, v, sink, ftab, work, params),
        "flex_fwd_sparse_hb": lambda: fa._fwd_sparse_hb_kernel(q, k, v, sink, ftab, work,
                                                               params),
        "flex_dq_sparse": lambda: fa._dq_sparse_kernel(q, k, v, do, lse, delta, ftab, work,
                                                       dataclasses.replace(params, head_block=2)),
        "flex_dkv_sparse": lambda: fa._dkv_sparse_kernel(q, k, v, do, lse, delta, btab, work,
                                                         params),
    }[kernel]
    run()
    return calls


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("kernel", _ROW_MAJOR + _SPARSE)
def test_every_flex_kernel_takes_bf16_at_head_dims_32_64_128(kernel, d, monkeypatch):
    calls = _launch_recorded(kernel, d, torch.bfloat16, monkeypatch)
    assert [name for name, _ in calls] == [kernel]
    args = calls[0][1]
    assert d in args  # the head_dim argument the entry point switches on
    assert args[-2] == 0  # in_f32: the wgmma walk


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("kernel", _ROW_MAJOR)
def test_row_major_kernels_take_float32(kernel, d, monkeypatch):
    calls = _launch_recorded(kernel, d, torch.float32, monkeypatch)
    assert [name for name, _ in calls] == [kernel] and calls[0][1][-2] == 1  # in_f32


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("kernel", _SPARSE)
def test_sparse_kernels_take_float32(kernel, d, monkeypatch):
    """The sparse grid's CUDA-core walks: float32 q/k/v launch with
    ``in_f32`` = 1, as the row-major kernels do."""
    calls = _launch_recorded(kernel, d, torch.float32, monkeypatch)
    assert [name for name, _ in calls] == [kernel] and calls[0][1][-2] == 1  # in_f32


@pytest.mark.parametrize("kernel", _SPARSE)
def test_sparse_kernels_refuse_float32_naming_the_grid(kernel, monkeypatch):
    """The sparse grid takes float32 q/k/v since its CUDA-core walks; a
    float32 q against bf16 k/v (no kernel's walk) is still refused, naming
    the grid."""
    with pytest.raises(TypeError, match="the sparse grid"):
        _launch_recorded(kernel, 32, torch.float32, monkeypatch, kv_dtype=torch.bfloat16)


@pytest.mark.parametrize("kernel", _ROW_MAJOR + _SPARSE)
def test_flex_kernels_refuse_other_head_dims(kernel, monkeypatch):
    with pytest.raises(ValueError, match="head_dim"):
        _launch_recorded(kernel, 16, torch.bfloat16, monkeypatch)
