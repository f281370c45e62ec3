"""``utils/checkpoint.py`` of the port: the JAX tests' cases (round trip and
the newest step, ``max_to_keep`` pruning, a missing checkpoint raising), the
template pinning shapes and dtypes, the temporary directory renamed whole;
and the CPU Llama trainer saved after N AdamW steps, restored into a fresh
model and optimizer and run N more: its 2N losses bit for bit those of the
uninterrupted run, and within rtol 2e-4 / atol 2e-5 of the JAX package's 2N
optax steps on the same weights and tokens (the bound the JAX package holds
its own layouts to)."""

import os

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
from magiattention_tpu_torch.utils import latest_step, restore_train_state, save_train_state
from tests.torch_jax_backend import jax_backend

TOTAL, CHUNK, BATCH, N = 128, 16, 2, 2
CU = [0, 48, TOTAL]
FIELDS = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
              ffn_hidden=96, dtype="float32")
RTOL, ATOL = 2e-4, 2e-5
LR, BETAS, EPS, WD = 3e-4, (0.9, 0.999), 1e-8, 1e-4  # optax.adamw's, on both sides


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(4, 3, generator=g), "b": torch.zeros(3)},
            "optimizer": {"state": {0: {"step": torch.tensor(2.0)}},
                          "param_groups": [{"lr": 0.1, "betas": (0.9, 0.99), "params": [0]}]},
            "step": 7}


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def test_roundtrip_and_latest(tmp_path):
    path = str(tmp_path / "ckpt")
    assert latest_step(path) is None
    save_train_state(path, 1, _state(1))
    save_train_state(path, 5, _state(5))
    assert latest_step(path) == 5
    step, state = restore_train_state(path)
    assert step == 5 and _equal(state, _state(5))
    step, state = restore_train_state(path, step=1)
    assert step == 1 and _equal(state, _state(1))
    assert sorted(os.listdir(path)) == ["1", "5"]  # no temporary directory left behind


@pytest.mark.parametrize("keep,kept", [(2, ["3", "4"]), (1, ["4"]), (None, ["0", "1", "2", "3", "4"])])
def test_max_to_keep_prunes(tmp_path, keep, kept):
    path = str(tmp_path / "ckpt")
    for s in range(5):
        save_train_state(path, s, _state(s), max_to_keep=keep)
    assert sorted(os.listdir(path)) == kept and latest_step(path) == 4


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "nothing"))
    save_train_state(str(tmp_path / "c"), 3, _state())
    with pytest.raises(FileNotFoundError, match="step 4"):
        restore_train_state(str(tmp_path / "c"), step=4)


def test_a_saved_step_is_replaced_whole(tmp_path):
    path = str(tmp_path / "ckpt")
    save_train_state(path, 2, _state(0))
    save_train_state(path, 2, _state(9))
    assert _equal(restore_train_state(path)[1], _state(9))


@pytest.mark.parametrize("drift", ["shape", "dtype", "missing_key", "not_a_tensor"])
def test_template_drift_raises_at_load(tmp_path, drift):
    path = str(tmp_path / "ckpt")
    save_train_state(path, 1, _state())
    template = _state(3)
    if drift == "shape":
        template["model"]["w"] = torch.zeros(4, 4)
    elif drift == "dtype":
        template["model"]["w"] = torch.zeros(4, 3, dtype=torch.float64)
    elif drift == "missing_key":
        template["model"]["extra"] = torch.zeros(1)
    else:
        template["step"] = torch.zeros(())
    with pytest.raises(ValueError, match="checkpoint"):
        restore_train_state(path, template=template)


def test_template_pins_and_passes_what_it_lacks(tmp_path):
    """A fresh optimizer has no per-parameter state: entries the template
    lacks come back as saved."""
    path = str(tmp_path / "ckpt")
    save_train_state(path, 1, _state())
    template = _state(3)
    template["optimizer"]["state"] = {}
    step, state = restore_train_state(path, template=template)
    assert step == 1 and _equal(state, _state())


# -- the trainer: save after N steps, restore, N more -----------------------------


def _tokens():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, FIELDS["vocab_size"], (BATCH, TOTAL)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX oracle at dp = cp = 1 on the jnp backend: its float32
    params and the losses of 2N optax AdamW steps."""
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        cfg = jax_models.LlamaConfig(**FIELDS)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "cp"))
        model, meta = jax_models.build_magi_llama(cfg, mesh, TOTAL, *jax_mask(CU),
                                                  chunk_size=CHUNK, block_q=32, block_k=32)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jax_models.init_params(jax.random.PRNGKey(0), cfg))
        host = jax.tree.map(np.array, params)  # copies: the step donates its parameters
        tok_g, lab_g = _tokens()
        tok = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(tok_g))
        lab = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(lab_g))
        pos = jnp.broadcast_to(jnp.asarray(meta.perm_idx), (BATCH, TOTAL))
        opt = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
        step = model.make_train_step(opt)
        p, state, losses = params, opt.init(params), []
        for _ in range(2 * N):
            p, state, loss = step(p, state, tok, lab, pos)
            losses.append(float(loss))
        return {"params": host, "losses": losses}


def _trainer(params):
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    model = build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts,
                             params=convert.llama_params_from_numpy(params), device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    return model, opt, make_model_train_step(model, opt)


def _batch():
    tokens, labels = (torch.from_numpy(a).long() for a in _tokens())
    return tokens, labels, torch.arange(TOTAL).expand(BATCH, TOTAL)


def test_trainer_resumes_bit_for_bit_and_tracks_jax(jax_run, tmp_path):
    batch = _batch()
    _, _, step = _trainer(jax_run["params"])
    straight = [float(step(*batch)) for _ in range(2 * N)]

    model, opt, step = _trainer(jax_run["params"])
    first = [float(step(*batch)) for _ in range(N)]
    save_train_state(str(tmp_path), N, {"model": model.state_dict(),
                                        "optimizer": opt.state_dict()})
    # a fresh model (other weights: zeros) and optimizer take the saved state
    fresh = jax.tree.map(np.zeros_like, jax_run["params"])
    model, opt, step = _trainer(fresh)
    at, state = restore_train_state(str(tmp_path), template={
        "model": model.state_dict(), "optimizer": opt.state_dict()})
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    resumed = first + [float(step(*batch)) for _ in range(N)]

    assert at == N
    assert resumed == straight  # bit for bit
    np.testing.assert_allclose(resumed, jax_run["losses"], rtol=RTOL, atol=ATOL)
    assert resumed[-1] < resumed[0]


def test_trainer_template_drift_raises(jax_run, tmp_path):
    model, opt, _ = _trainer(jax_run["params"])
    save_train_state(str(tmp_path), 0, {"model": model.state_dict(),
                                        "optimizer": opt.state_dict()})
    drifted = dict(FIELDS, ffn_hidden=FIELDS["ffn_hidden"] + 8)
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    other = build_magi_llama(LlamaConfig(**drifted), TOTAL, qr, kr, ts, device="cpu")
    with pytest.raises(ValueError, match="saved .* template"):
        restore_train_state(str(tmp_path), template={"model": other.state_dict()})
