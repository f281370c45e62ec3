"""The port's Llama trainer under context parallelism (cp=2, one gloo
process per rank on the CPU) against the JAX package's ``build_magi_llama``
on a (dp=1, cp=2) mesh, on the jnp backend in float32, at a tiny
configuration (2 layers, narrow widths): the same ``init_params`` carried
across with ``convert.llama_params_from_numpy``, the same tokens from a
numpy seed, both plans at the 64 x 64 tile. The loss and every parameter
gradient (summed over the ranks), and the losses of three AdamW steps with
optax's hyperparameters, within rtol 2e-4 / atol 2e-5 (the bound of the
JAX package's own cp layouts, ``tests/test_models/test_llama.py``), at
overlap degree 0 (a2a) and 2 (hops); and the same against the port's own
cp=1 trainer. Then cp=4 as 2 x 2 (``comm.make_hier_cp_groups``: the
hierarchical two-level plan) against JAX ``build_magi_llama`` over
``cp_axis=("dcn", "ici")`` on a (dp=1, dcn=2, ici=2) mesh, at degree 0
(a2a) and 2 (hops), at the same tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu import models as jax_models
from magiattention_tpu.api import infer_attn_mask_from_cu_seqlens as jax_mask
from magiattention_tpu.parallel import dispatch
from magiattention_tpu_torch import convert
from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama, make_model_train_step
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

CP, TOTAL, CHUNK, BATCH, BLOCK = 2, 512, 64, 2, 64
CU = [0, 192, TOTAL]
FIELDS = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
              ffn_hidden=96, dtype="float32")
RTOL, ATOL = 2e-4, 2e-5
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw's
STEPS = 3


def _tokens():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, FIELDS["vocab_size"], (BATCH, TOTAL)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_oracle(mesh, cp_axis="cp", overlap_config=None):
    """The JAX model on ``mesh``: params, loss, grads, and the losses of
    STEPS AdamW steps."""
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        cfg = jax_models.LlamaConfig(**FIELDS)
        qr, kr, ts = jax_mask(CU)
        model, meta = jax_models.build_magi_llama(
            cfg, mesh, TOTAL, qr, kr, ts, chunk_size=CHUNK, block_q=BLOCK, block_k=BLOCK,
            cp_axis=cp_axis, overlap_config=overlap_config)
        # float32 masters (the test session's x64 would promote the init)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jax_models.init_params(jax.random.PRNGKey(0), cfg))
        tokens_g, labels_g = _tokens()
        tokens = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(tokens_g))
        labels = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(labels_g))
        pos = jnp.broadcast_to(jnp.asarray(meta.perm_idx), (BATCH, TOTAL))
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
            params, tokens, labels, pos, model.sharded_tables())
        out = jax.tree.map(np.array, {"params": params, "grads": grads, "loss": loss})
        opt = optax.adamw(ADAMW["lr"], b1=ADAMW["betas"][0], b2=ADAMW["betas"][1],
                          eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])
        step = model.make_train_step(opt)
        p, state, losses = params, opt.init(params), []
        for _ in range(STEPS):  # the step donates its parameters
            p, state, step_loss = step(p, state, tokens, labels, pos)
            losses.append(float(step_loss))
        return {**out, "loss": float(out["loss"]), "losses": losses,
                "hier": model.plan.hier, "degree": model.plan.overlap_degree}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX oracle at (dp=1, cp=2)."""
    return _jax_oracle(Mesh(np.array(jax.devices()[:CP]).reshape(1, CP), ("dp", "cp")))


@pytest.fixture(scope="module")
def port_runs(jax_run):
    """The port at cp=2, degree 0 (a2a) and degree 2 (hops), in one pool."""
    tokens, labels = _tokens()
    with RankPool(CP) as pool:
        return {
            (degree, impl): pool.run(workers.llama_cp, FIELDS, TOTAL, CU, CHUNK,
                                     jax_run["params"], tokens, labels, degree, impl, STEPS,
                                     ADAMW)
            for degree, impl in ((0, "a2a"), (2, "hops"))
        }


def _leaves(tree):
    yield "embed", tree["embed"]
    for i, layer in enumerate(tree["layers"]):
        for name in sorted(layer):
            yield f"layers[{i}].{name}", layer[name]
    yield "final_norm", tree["final_norm"]
    yield "lm_head", tree["lm_head"]


@pytest.fixture(scope="module")
def cp1_port(jax_run):
    """The port's own cp=1 trainer on the same weights and tokens."""
    params = jax_run["params"]
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    model = build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts,
                             params=convert.llama_params_from_numpy(params), device="cpu")
    tokens, labels = (torch.from_numpy(a).long() for a in _tokens())
    pos = torch.arange(TOTAL).expand(BATCH, TOTAL)
    loss = model.loss(tokens, labels, pos)
    loss.backward()
    grads = convert.llama_params_to_numpy(model, grad=True)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))
    return {"loss": float(loss.detach()), "grads": grads,
            "losses": [float(step(tokens, labels, pos)) for _ in range(STEPS)]}


@pytest.mark.parametrize("run", [(0, "a2a"), (2, "hops")], ids=["d0_a2a", "d2_hops"])
@pytest.mark.parametrize("against", ["jax_cp2", "port_cp1"])
def test_cp2_loss_gradients_and_steps_match(run, against, jax_run, port_runs, cp1_port):
    got = port_runs[run]
    assert got[0]["degree"] == run[0] and set(got[0]["impls"]) == {run[1]}
    assert got[0]["head_block"] == FIELDS["n_heads"] // FIELDS["n_kv_heads"]
    ref = jax_run if against == "jax_cp2" else cp1_port
    for r in range(CP):  # every rank holds the same loss and summed gradients
        np.testing.assert_allclose(got[r]["loss"], ref["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[r]["losses"], ref["losses"], rtol=RTOL, atol=ATOL)
        grads = dict(_leaves(got[r]["grads"]))
        want = dict(_leaves(ref["grads"]))
        assert grads.keys() == want.keys()
        for name, g in want.items():
            np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL, err_msg=name)


HIER = (2, 2)


@pytest.fixture(scope="module")
def hier_runs(jax_run):
    """The JAX model and the port's at cp=4 as 2 x 2, degree 0 (a2a) and 2
    (hops), on the cp=2 oracle's weights."""
    from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig as JaxOverlapConfig

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, *HIER), ("dp", "dcn", "ici"))
    tokens, labels = _tokens()
    out = {}
    with RankPool(4) as pool:
        for degree, impl in ((0, "a2a"), (2, "hops")):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)
                ref = _jax_oracle(mesh, ("dcn", "ici"),
                                  JaxOverlapConfig(degree=degree, min_stage_rows=CHUNK))
            got = pool.run(workers.llama_cp, FIELDS, TOTAL, CU, CHUNK, jax_run["params"], tokens,
                           labels, degree, impl, STEPS, ADAMW, HIER)
            out[(degree, impl)] = (got, ref)
    return out


@pytest.mark.parametrize("run", [(0, "a2a"), (2, "hops")], ids=["d0_a2a", "d2_hops"])
def test_hier_2x2_loss_gradients_and_steps_match_jax(run, hier_runs):
    got, ref = hier_runs[run]
    assert ref["hier"] == HIER and ref["degree"] == run[0]
    assert got[0]["hier"] == HIER and got[0]["degree"] == run[0]
    assert set(got[0]["impls"]) == {run[1]}
    for r in range(4):
        np.testing.assert_allclose(got[r]["loss"], ref["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[r]["losses"], ref["losses"], rtol=RTOL, atol=ATOL)
        grads, want = dict(_leaves(got[r]["grads"])), dict(_leaves(ref["grads"]))
        assert grads.keys() == want.keys()
        for name, g in want.items():
            np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL, err_msg=name)
