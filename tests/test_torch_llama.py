"""The port's single-device Llama trainer against the JAX package's
``build_magi_llama`` at dp=1, cp=1 (the oracle ``tests/test_models/
test_llama.py`` holds every parallel layout to), on the jnp backend in
float32: the JAX ``init_params(PRNGKey(0), cfg)`` carried across with
``convert.llama_params_from_numpy``, the same tokens from a numpy seed. The
loss and every parameter gradient, and the losses of three AdamW steps with
optax's hyperparameters, within rtol 2e-4 / atol 2e-5 — the tolerance the
JAX package holds its own layouts to.

The JAX model runs in dispatch order with the dispatch position ids; the
port runs in global order. The loss and the parameter gradients do not
depend on the order of the tokens."""

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
from magiattention_tpu_torch.models import (
    LlamaConfig,
    build_magi_llama,
    init_params,
    make_model_train_step,
)

TOTAL, CHUNK, BATCH = 128, 16, 2
CU = [0, 48, TOTAL]
FIELDS = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
              ffn_hidden=96, dtype="float32")
RTOL, ATOL = 2e-4, 2e-5
# optax.adamw's defaults, set explicitly on both sides
LR, BETAS, EPS, WD = 3e-4, (0.9, 0.999), 1e-8, 1e-4
STEPS = 3


def _tokens():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, FIELDS["vocab_size"], (BATCH, TOTAL)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX oracle: params, loss, grads and the losses of STEPS AdamW steps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "jnp")
        cfg = jax_models.LlamaConfig(**FIELDS)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "cp"))
        qr, kr, ts = jax_mask(CU)
        model, meta = jax_models.build_magi_llama(
            cfg, mesh, TOTAL, qr, kr, ts, chunk_size=CHUNK, block_q=32, block_k=32)
        # float32 masters, as the config says (the test session enables x64,
        # under which the JAX init's numpy scale promotes them to float64)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jax_models.init_params(jax.random.PRNGKey(0), cfg))
        tokens_g, labels_g = _tokens()
        tokens = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(tokens_g))
        labels = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(labels_g))
        pos = jnp.broadcast_to(jnp.asarray(meta.perm_idx), (BATCH, TOTAL))
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
            params, tokens, labels, pos, model.sharded_tables())
        # copies: np.asarray may alias a buffer that the donating step reuses
        out = jax.tree.map(np.array, {"params": params, "grads": grads, "loss": loss})
        opt = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
        step = model.make_train_step(opt)
        p, state, losses = params, opt.init(params), []
        for _ in range(STEPS):  # the step donates its parameters
            p, state, step_loss = step(p, state, tokens, labels, pos)
            losses.append(float(step_loss))
        return {**out, "loss": float(out["loss"]), "losses": losses}


def _port_model(jax_params):
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    return build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts,
                            params=convert.llama_params_from_numpy(jax_params), device="cpu")


def _batch():
    tokens, labels = (torch.from_numpy(a).long() for a in _tokens())
    return tokens, labels, torch.arange(TOTAL).expand(BATCH, TOTAL)


def _leaves(tree):
    yield "embed", tree["embed"]
    for i, layer in enumerate(tree["layers"]):
        for name in sorted(layer):
            yield f"layers[{i}].{name}", layer[name]
    yield "final_norm", tree["final_norm"]
    yield "lm_head", tree["lm_head"]


def test_weights_round_trip_exactly(jax_run):
    model = _port_model(jax_run["params"])
    back = dict(_leaves(convert.llama_params_to_numpy(model)))
    ref = dict(_leaves(jax_run["params"]))
    assert back.keys() == ref.keys()
    for name, a in ref.items():
        assert back[name].dtype == a.dtype == np.float32 and np.array_equal(back[name], a), name


def test_loss_and_every_gradient_match_jax(jax_run):
    model = _port_model(jax_run["params"])
    # the harness's default: the row-major grid at head_block G (flex_fwd_hb on the card)
    assert model.head_block == FIELDS["n_heads"] // FIELDS["n_kv_heads"]
    loss = model.loss(*_batch())
    loss.backward()
    np.testing.assert_allclose(float(loss), jax_run["loss"], rtol=RTOL, atol=ATOL)
    grads = dict(_leaves(convert.llama_params_to_numpy(model, grad=True)))
    ref = dict(_leaves(jax_run["grads"]))
    assert grads.keys() == ref.keys()
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL, err_msg=name)


def test_adamw_steps_track_optax(jax_run):
    model = _port_model(jax_run["params"])
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    step = make_model_train_step(model, opt)
    batch = _batch()
    losses = [float(step(*batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]


def test_forward_takes_one_stream_or_several(jax_run):
    model = _port_model(jax_run["params"])
    tokens, _, pos = _batch()
    with torch.no_grad():
        both = model(tokens, pos)
        one = model(tokens[1], pos[1])
    assert both.shape == (BATCH, TOTAL, FIELDS["vocab_size"]) and both.dtype == torch.float32
    torch.testing.assert_close(both[1], one, rtol=0, atol=0)


def test_init_params_scheme():
    cfg = LlamaConfig(**FIELDS)
    p = init_params(torch.Generator().manual_seed(1), cfg)
    assert p["embed"].shape == (64, 64) and abs(float(p["embed"].std()) - 0.02) < 0.005
    wq = p["layers"][0]["wq"]
    assert wq.shape == (64, 64) and abs(float(wq.std()) - 64 ** -0.5) < 0.02
    assert len(p["layers"]) == 2 and bool((p["layers"][1]["mlp_norm"] == 1).all())
    q = init_params(torch.Generator().manual_seed(1), cfg)
    assert torch.equal(p["lm_head"], q["lm_head"])  # the generator decides the draws


def test_builder_refuses_remat():
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    with pytest.raises(NotImplementedError, match="remat"):
        build_magi_llama(LlamaConfig(**FIELDS, remat=True), TOTAL, qr, kr, ts, device="cpu")


def test_builder_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts)


def test_builder_resolves_head_block_and_passes_it(jax_run, monkeypatch):
    """``build_magi_llama`` resolves the blocking once through
    ``resolve_harness_blocking`` and every attention call carries its
    head_block: G by default, the env's pin snapped, 1 under the legacy
    harness (a caller's tile)."""
    from magiattention_tpu_torch.models import llama

    seen = []
    real = llama.flex_attn_with_meta
    monkeypatch.setattr(llama, "flex_attn_with_meta",
                        lambda *a, **k: seen.append(k["head_block"]) or real(*a, **k))
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    params = convert.llama_params_from_numpy(jax_run["params"])
    cfg = LlamaConfig(**FIELDS)
    tokens, _, pos = _batch()
    for env_pin, tile, want in ((None, None, 2), ("1", None, 1), (None, 32, 1), ("8", 32, 4)):
        if env_pin is None:
            monkeypatch.delenv("MAGI_ATTENTION_HEAD_BLOCK", raising=False)
        else:
            monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", env_pin)
        model = build_magi_llama(cfg, TOTAL, qr, kr, ts, params=params, block_q=tile,
                                 block_k=tile, device="cpu")
        assert model.head_block == want and model.meta.block_q == (tile or 64)
        seen.clear()
        with torch.no_grad():
            model(tokens[0], pos[0])
        assert seen == [want] * FIELDS["n_layers"]
