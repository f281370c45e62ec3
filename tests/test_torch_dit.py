"""The port's Magi-1 DiT (``models/dit.py``) against the JAX package's, on
the CPU, at the JAX test's configuration (``tests/test_models/test_dit.py``:
dim 64, 2 layers, 4 / 2 heads of d 16, 512 tokens as 4 AR chunks of 128,
dispatch chunk 32, tile 32) in float32. One parameter tree (JAX's
``init_dit_params`` with 0.02 numpy noise added, so that the adaLN-zero
identity start is broken and attention mixes tokens) and one batch of two
streams from a numpy seed go through JAX's cp = 1 model on the jnp backend
and through the port at cp = 1 (this process) and at dp2 x cp2 and cp 4
(gloo ranks, ``testing.dist.RankPool``): the velocities, the loss, every
gradient and the losses of two AdamW steps within rtol 2e-4 / atol 2e-5
(the bound of ``tests/torch_llama_jax.py``). The JAX test's properties hold
too: no earlier token's velocity moves when the last chunk's latents do,
and the velocities do not depend on the layout; remat is the plain step
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from magiattention_tpu import models as jax_models
from magiattention_tpu.parallel.dispatch import dispatch as jax_dispatch
from magiattention_tpu.parallel.dispatch import undispatch as jax_undispatch
from magiattention_tpu_torch import convert
from magiattention_tpu_torch.models import (
    DiTConfig,
    ParallelGroups,
    build_magi_dit,
    chunk_causal_mask,
)
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend
from .torch_llama_jax import ADAMW, ATOL, RTOL

FIELDS = dict(in_dim=8, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
              ffn_hidden=128, text_dim=32, text_len=16)
TOTAL, CHUNK, DISPATCH, BLOCK, BATCH, STEPS = 512, 128, 32, 32, 2, 2
LAYOUTS = {"dp2_cp2": dict(dp=2, cp=2), "cp4": dict(cp=4)}
CAUSAL_TOL = 1e-5  # the JAX test's bound on an earlier token's move


def _params(seed: int = 0) -> dict:
    """JAX ``init_dit_params`` in float32 plus 0.02 numpy noise (the JAX
    causality test's perturbation, drawn with numpy)."""
    tree = jax_models.init_dit_params(jax.random.PRNGKey(seed), jax_models.DiTConfig(**FIELDS))
    rng = np.random.default_rng(100 + seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.02 * rng.standard_normal(a.shape)).astype(
            np.float32), tree)


def _data(seed: int = 1) -> dict:
    """The JAX test's batch: latents, text, per-chunk t in [0.05, 0.95]
    broadcast to tokens, rectified-flow noising and target; ``lat_moved``
    is ``noised`` with the last chunk's latents moved by 10."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    lat = rng.standard_normal((BATCH, TOTAL, FIELDS["in_dim"])).astype(f32)
    text = rng.standard_normal((BATCH, FIELDS["text_len"], FIELDS["text_dim"])).astype(f32)
    tc = np.repeat(rng.uniform(0.05, 0.95, (BATCH, TOTAL // CHUNK)), CHUNK, axis=1).astype(f32)
    noise = rng.standard_normal(lat.shape).astype(f32)
    noised = ((1 - tc[..., None]) * lat + tc[..., None] * noise).astype(f32)
    moved = noised.copy()
    moved[:, -CHUNK:] += 10.0
    return {"noised": noised, "target_v": noise - lat, "t_chunk": tc, "text": text,
            "lat_moved": moved}


def _leaves(tree):
    for name in sorted(k for k in tree if k != "layers"):
        yield name, tree[name]
    for i, layer in enumerate(tree["layers"]):
        for name in sorted(layer):
            yield f"layers[{i}].{name}", layer[name]


def _assert_trees_close(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_ref() -> dict:
    """JAX ``MagiDiT`` at cp = 1 (dp = 1) on the jnp backend: the
    velocities of both batches in natural order, the loss and gradients,
    and the losses of two optax AdamW steps."""
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "cp"))
        model, mq = jax_models.build_magi_dit(jax_models.DiTConfig(**FIELDS), mesh, TOTAL, CHUNK,
                                              dispatch_chunk=DISPATCH, block_q=BLOCK,
                                              block_k=BLOCK)
        data = _data()

        def disp(x, pad=0.0):
            return jax.vmap(lambda a: jax_dispatch(a, mq, pad_value=pad))(jnp.asarray(x))

        tc = disp(data["t_chunk"], -1.0)
        pos = disp(np.broadcast_to(np.arange(TOTAL, dtype=np.int32), (BATCH, TOTAL)))
        text = jnp.asarray(data["text"])
        params = jax.tree.map(jnp.asarray, _params())
        fwd = model.make_forward()
        vel = {n: np.asarray(jax.vmap(lambda a: jax_undispatch(a, mq))(
            fwd(params, disp(data[n]), tc, pos, text))) for n in ("noised", "lat_moved")}
        batch = (disp(data["noised"]), disp(data["target_v"]), tc, pos, text)
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, *batch,
                                                                 model.sharded_tables())
        grads = jax.tree.map(np.array, grads)
        opt = optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0], b2=ADAMW["betas"][1],
                          eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])
        step = model.make_train_step(opt)
        p, state, losses = params, opt.init(params), []
        for _ in range(STEPS):  # the step donates its parameters
            p, state, step_loss = step(p, state, *batch)
            losses.append(float(step_loss))
    return {"vel": vel["noised"], "vel_moved": vel["lat_moved"], "loss": float(loss),
            "grads": grads, "losses": losses}


def _port(layout=None, remat=False) -> dict:
    fields = dict(FIELDS, remat=remat)
    return workers.dit_parallel(None, fields, TOTAL, CHUNK, _params(), _data(), layout, STEPS,
                                ADAMW, DISPATCH, BLOCK)


@pytest.fixture(scope="module")
def port_runs() -> dict:
    """The port at cp = 1 in this process and under each layout over four
    gloo ranks (every rank's result)."""
    runs = {"cp1": [_port()]}
    with RankPool(4) as pool:
        for name, layout in LAYOUTS.items():
            runs[name] = pool.run(workers.dit_parallel, FIELDS, TOTAL, CHUNK, _params(), _data(),
                                  layout, STEPS, ADAMW, DISPATCH, BLOCK)
    return runs


@pytest.mark.parametrize("total,chunk", [(512, 128), (1000, 300), (64, 64)])
def test_chunk_causal_mask_matches_jax(total, chunk):
    assert chunk_causal_mask(total, chunk) == jax_models.chunk_causal_mask(total, chunk)


@pytest.mark.parametrize("layout", ["cp1", *LAYOUTS])
def test_velocities_match_jax(layout, port_runs, jax_ref):
    for r in port_runs[layout]:  # every rank gathers the global velocities
        np.testing.assert_allclose(r["vel"], jax_ref["vel"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["vel_moved"], jax_ref["vel_moved"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["cp1", *LAYOUTS])
def test_loss_grads_and_steps_match_jax(layout, port_runs, jax_ref):
    for r in port_runs[layout]:  # every rank holds the same loss, grads and steps
        np.testing.assert_allclose(r["loss"], jax_ref["loss"], rtol=RTOL, atol=ATOL)
        _assert_trees_close(r["grads"], jax_ref["grads"])
        np.testing.assert_allclose(r["losses"], jax_ref["losses"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["cp1", *LAYOUTS])
def test_chunk_causality(layout, port_runs):
    """THE Magi-1 property, as the JAX test states it: moving the last
    chunk's latents moves no earlier token's velocity, and moves its own."""
    r = port_runs[layout][0]
    d = np.abs(r["vel"] - r["vel_moved"]).max(axis=(0, 2))  # per token
    assert (d[: TOTAL - CHUNK] < CAUSAL_TOL).all()
    assert d[TOTAL - CHUNK:].max() > 1e-3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cp_invariance(layout, port_runs):
    """The JAX test's bound: cp = 1 and the layout give the same velocities."""
    ref = port_runs["cp1"][0]["vel"]
    for r in port_runs[layout]:
        np.testing.assert_allclose(r["vel"], ref, atol=2e-5, rtol=2e-5)


def test_remat_matches_plain_bit_for_bit(port_runs):
    got, ref = _port(remat=True), port_runs["cp1"][0]
    assert got["loss"] == ref["loss"] and got["losses"] == ref["losses"]
    for (name, a), (_, b) in zip(_leaves(got["grads"]), _leaves(ref["grads"])):
        assert np.array_equal(a, b), name


def test_builder_refuses_tp():
    cfg = DiTConfig(**FIELDS)
    cp2_tp2 = ParallelGroups(None, None, None, None, None, None, (1, 1, 2, 2), (0, 0, 0, 0))
    with pytest.raises(ValueError, match="dp x cp only"):
        build_magi_dit(cfg, TOTAL, CHUNK, groups=cp2_tp2, device="cpu")
