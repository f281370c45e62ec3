"""The port's Llama trainer under data and tensor parallelism (one gloo
process per rank on the CPU, ``make_parallel_groups`` row-major over (dp,
cp, tp) as the JAX mesh) against the JAX package's cp=1 model on the jnp
backend and the port's own cp=1 trainer, at JAX's test configuration (2
layers, dim 64, 4 / 2 heads, d 16; 512 tokens, chunk 64, batch 2), float32,
both packages at the 64 x 64 tile: dp2 x cp2, cp2 x tp2 and cp 4 as 2 x 2
(hierarchical cp through ``make_parallel_groups(cp=(2, 2))``), the loss and
every parameter gradient (a tp shard gathered back to the full weight)
within rtol 2e-4 / atol 2e-5, and the losses of three AdamW steps with
optax's hyperparameters. The dp and tp layouts against JAX
``build_magi_llama`` on the same mesh are slow-marked (the JAX same-layout
runs are slow in the JAX package's own suite)."""

import numpy as np
import pytest
import torch

from magiattention_tpu_torch import convert
from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
from magiattention_tpu_torch.models import (
    LlamaConfig,
    build_magi_llama,
    make_model_train_step,
    plan_flex_attn,
    resolve_harness_blocking,
)
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_llama_jax import (
    ADAMW,
    ATOL,
    BATCH,
    CHUNK,
    CU,
    FIELDS,
    RTOL,
    STEPS,
    TOTAL,
    assert_trees_close,
    jax_run,
    tokens,
)

LAYOUTS = {"dp2_cp2": dict(dp=2, cp=2), "cp2_tp2": dict(cp=2, tp=2),
           "hier_cp2x2": dict(cp=(2, 2))}  # cp 4 as 2 nodes x 2 ranks: the two-level plan
JAX_AXES = {"dp2_cp2": (dict(dp=2, cp=2), None), "cp2_tp2": (dict(dp=1, cp=2, tp=2), "tp")}


@pytest.fixture(scope="module")
def oracle():
    """The JAX model at cp=1 (dp=1)."""
    return jax_run(dict(dp=1, cp=1))


@pytest.fixture(scope="module")
def port_runs(oracle):
    tok, lab = tokens()
    with RankPool(4) as pool:
        return {name: pool.run(workers.llama_parallel, FIELDS, TOTAL, CU, CHUNK,
                               oracle["params"], tok, lab, layout, STEPS, ADAMW)
                for name, layout in LAYOUTS.items()}


@pytest.fixture(scope="module")
def cp1_port(oracle):
    """The port's own cp=1 trainer on the same weights and tokens."""
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    model = build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts,
                             params=convert.llama_params_from_numpy(oracle["params"]),
                             device="cpu", block_q=64, block_k=64)
    tok, lab = (torch.from_numpy(a).long() for a in tokens())
    pos = torch.arange(TOTAL).expand(BATCH, TOTAL)
    loss = model.loss(tok, lab, pos)
    loss.backward()
    grads = convert.llama_params_to_numpy(model, grad=True)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))
    return {"loss": float(loss.detach()), "grads": grads,
            "losses": [float(step(tok, lab, pos)) for _ in range(STEPS)]}


def _check(got: list, ref: dict) -> None:
    for r in got:  # every rank holds the same loss, steps and gathered gradients
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=RTOL, atol=ATOL)
        assert_trees_close(r["grads"], ref["grads"])


@pytest.mark.parametrize("against", ["jax_cp1", "port_cp1"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_cp1(layout, against, port_runs, oracle, cp1_port):
    got = port_runs[layout]
    lay = LAYOUTS[layout]
    tp, cp = lay.get("tp", 1), int(np.prod(lay["cp"]))
    heads = (FIELDS["n_heads"] // tp * FIELDS["head_dim"],
             FIELDS["n_kv_heads"] // tp * FIELDS["head_dim"])
    assert all(tuple(r["heads"]) == heads for r in got)  # a tp rank holds its head block
    sizes = (1, lay.get("dp", 1), cp, tp)
    assert [r["coords"] for r in got] == [
        tuple(int(c) for c in np.unravel_index(i, sizes)) for i in range(4)]
    assert all(r["hier"] == (tuple(lay["cp"]) if isinstance(lay["cp"], tuple) else None)
               for r in got)
    _check(got, oracle if against == "jax_cp1" else cp1_port)


@pytest.mark.slow
@pytest.mark.parametrize("layout", list(JAX_AXES))
def test_layout_matches_jax_same_layout(layout, port_runs):
    axes, tp_axis = JAX_AXES[layout]
    _check(port_runs[layout], jax_run(axes, tp_axis=tp_axis))


def test_tp_must_divide_the_heads():
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    with pytest.raises(ValueError, match="tp=4 must divide"):
        plan_flex_attn(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts, chunk_size=CHUNK, cp_size=2,
                       tp=4)


@pytest.mark.parametrize("tp", [1, 2])
def test_harness_blocking_at_tp_equals_jax(tp, monkeypatch):
    """The harness's (block_q, block_k, head_block) at the per-tp-rank heads,
    with the tuner stepping aside as both packages' harness does under a
    pinned tile and head_block: JAX's ``resolve_harness_blocking`` on a tp
    mesh."""
    from magiattention_tpu.models._common import resolve_harness_blocking as jax_resolve

    from .torch_llama_jax import mesh

    monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", "4")
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    naive = qr.to_naive_ranges(), kr.to_naive_ranges()
    got = resolve_harness_blocking(LlamaConfig(**FIELDS), *naive, ts, TOTAL, 2, 64, 64, tp=tp)
    want = jax_resolve(LlamaConfig(**FIELDS), mesh(cp=2, tp=tp), "tp", *naive, ts, TOTAL, 2,
                       64, 64)
    assert got == tuple(int(x) for x in want)
    # per-rank heads: 4 / 2 at tp 1 (head_block 4), 2 / 1 at tp 2 (head_block 2)
    assert got[2] == FIELDS["n_heads"] // tp
