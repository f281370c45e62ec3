"""The JAX side of the port's parallel-trainer tests: the JAX package's
Llama (``build_magi_llama`` / ``build_magi_llama_pp``) on the 8-device CPU
mesh, on the jnp backend in float32, at the tiny configuration and data the
port's ranks take (the same ``init_params``, the same tokens from a numpy
seed), both packages at the 64 x 64 tile."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from magiattention_tpu import models as jax_models
from magiattention_tpu.api import infer_attn_mask_from_cu_seqlens as jax_mask
from magiattention_tpu.parallel import dispatch

from .torch_jax_backend import jax_backend

TOTAL, CHUNK, BATCH, BLOCK = 512, 64, 2, 64
CU = [0, 192, TOTAL]
FIELDS = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
              ffn_hidden=96, dtype="float32")
RTOL, ATOL = 2e-4, 2e-5  # the JAX package's own layouts' bound (tests/test_models/test_llama.py)
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw's
STEPS = 3


def tokens(batch: int = BATCH, seed: int = 0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, FIELDS["vocab_size"], (batch, TOTAL)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def mesh(**axes) -> Mesh:
    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())), tuple(axes))


def jax_run(axes: dict, *, tp_axis: str | None = None, pp: bool = False, steps: int = STEPS,
            fields: dict = FIELDS, batch: int = BATCH) -> dict:
    """The JAX model on a mesh of ``axes``: its float32 params (the flat
    ``init_params`` tree), loss, grads (layer-stacked under ``pp``) and the
    losses of ``steps`` AdamW steps."""
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        cfg = jax_models.LlamaConfig(**fields)
        qr, kr, ts = jax_mask(CU)
        build = jax_models.build_magi_llama_pp if pp else jax_models.build_magi_llama
        model, meta = build(cfg, mesh(**axes), TOTAL, qr, kr, ts, chunk_size=CHUNK,
                            block_q=BLOCK, block_k=BLOCK, tp_axis=tp_axis)
        # float32 masters (the test session's x64 would promote the init)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jax_models.init_params(jax.random.PRNGKey(0), cfg))
        run_params = jax_models.stack_layer_params(params) if pp else params
        tok_g, lab_g = tokens(batch)
        tok = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(tok_g))
        lab = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(lab_g))
        pos = jnp.broadcast_to(jnp.asarray(meta.perm_idx), (batch, TOTAL))
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
            run_params, tok, lab, pos, model.sharded_tables())
        out = jax.tree.map(np.array, {"params": params, "grads": grads})
        losses = []
        if steps:
            opt = optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0], b2=ADAMW["betas"][1],
                              eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])
            step = model.make_train_step(opt)
            p, state = run_params, opt.init(run_params)
            for _ in range(steps):  # the step donates its parameters
                p, state, step_loss = step(p, state, tok, lab, pos)
                losses.append(float(step_loss))
        return {**out, "loss": float(loss), "losses": losses}


def leaves(tree):
    """(name, array) of a parameter tree, flat or layer-stacked."""
    yield "embed", tree["embed"]
    layers = tree["layers"]
    if isinstance(layers, dict):
        for name in sorted(layers):
            yield f"layers.{name}", layers[name]
    else:
        for i, layer in enumerate(layers):
            for name in sorted(layer):
                yield f"layers[{i}].{name}", layer[name]
    yield "final_norm", tree["final_norm"]
    yield "lm_head", tree["lm_head"]


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol, err_msg=name)
