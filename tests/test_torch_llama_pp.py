"""The port's GPipe pipeline trainer (``models/llama_pp.py``; one gloo
process per rank on the CPU, ``make_parallel_groups`` row-major over (pp,
dp, cp, tp) as the JAX mesh) against the JAX package's cp=1 model on the
jnp backend, at JAX's test configuration (2 layers, dim 64, 4 / 2 heads, d
16; 512 tokens, chunk 64, batch 2: two microbatches, three ticks), float32,
both packages at the 64 x 64 tile: pp2 x cp2 and pp2 x tp2, the loss and
every gradient layer-stacked as JAX stacks them (stages and tp shards
gathered back) within rtol 2e-4 / atol 2e-5, and three AdamW steps' losses.
The same layouts against JAX ``build_magi_llama_pp`` on the same mesh are
slow-marked. Then ``stack_layer_params`` against JAX's, the pp
divisibility error, remat under pp against no remat, and a run whose loss
falls."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from magiattention_tpu import models as jax_models
from magiattention_tpu_torch import convert
from magiattention_tpu_torch.models import LlamaConfig, init_params, stack_layer_params
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_llama_jax import (
    ADAMW,
    ATOL,
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

LAYOUTS = {"pp2_cp2": dict(pp=2, cp=2), "pp2_tp2": dict(pp=2, tp=2)}
JAX_AXES = {"pp2_cp2": (dict(pp=2, dp=1, cp=2), None),
            "pp2_tp2": (dict(pp=2, dp=1, cp=1, tp=2), "tp")}


@pytest.fixture(scope="module")
def oracle():
    """The JAX model at cp=1, its gradients layer-stacked."""
    run = jax_run(dict(dp=1, cp=1))
    return {**run, "grads": jax_models.stack_layer_params(run["grads"])}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


@pytest.fixture(scope="module")
def port_runs(oracle, pool):
    tok, lab = tokens()
    return {name: pool.run(workers.llama_parallel, FIELDS, TOTAL, CU, CHUNK, oracle["params"],
                           tok, lab, layout, STEPS, ADAMW)
            for name, layout in LAYOUTS.items()}


def _check(got: list, ref: dict) -> None:
    for r in got:  # every rank (both stages) holds the same loss, steps and gradients
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=RTOL, atol=ATOL)
        assert_trees_close(r["grads"], ref["grads"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipeline_matches_cp1(layout, port_runs, oracle):
    got = port_runs[layout]
    assert [r["coords"][0] for r in got] == [0, 0, 1, 1]  # pp is the slowest axis
    assert [r["ticks"] for r in got] == [3] * 4  # 2 microbatches over 2 stages
    _check(got, oracle)


@pytest.mark.slow
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipeline_matches_jax_same_layout(layout, port_runs):
    axes, tp_axis = JAX_AXES[layout]
    ref = jax_run(axes, tp_axis=tp_axis, pp=True)
    _check(port_runs[layout], ref)


def test_stack_layer_params_equals_jax():
    cfg = jax_models.LlamaConfig(**FIELDS)
    # float32 masters (the test session's x64 would promote the init)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax_models.init_params(jax.random.PRNGKey(0), cfg))
    want = jax.tree.map(np.asarray, jax_models.stack_layer_params(params))
    got = stack_layer_params(convert.llama_params_from_numpy(params))
    assert_trees_close(jax.tree.map(lambda t: t.numpy(), got,
                                    is_leaf=lambda x: isinstance(x, torch.Tensor)),
                       want, rtol=0, atol=0)
    # numpy trees stack as numpy, as JAX's
    assert_trees_close(stack_layer_params(params), want, rtol=0, atol=0)


def test_pp_must_divide_the_layers(pool):
    msgs = pool.run(workers.llama_pp_refusal, {**FIELDS, "n_layers": 3}, TOTAL, CU, CHUNK)
    assert all("pp=2 must divide n_layers=3" in m for m in msgs)


def test_remat_under_pp_equals_no_remat(pool):
    """One pp2 x cp2 step with ``cfg.remat`` (a checkpoint per layer inside
    the stage) against the stored-activation path: the loss and every
    gradient within 1e-6, as JAX's ``test_pp_remat_matches_no_remat``."""
    tok, lab = tokens()
    params = convert.llama_params_to_numpy(_Tree(init_params(torch.Generator().manual_seed(1),
                                                             LlamaConfig(**FIELDS))))
    runs = [pool.run(workers.llama_parallel, FIELDS, TOTAL, CU, CHUNK, params, tok, lab,
                     LAYOUTS["pp2_cp2"], 1, ADAMW, 64, remat)[0] for remat in (False, True)]
    assert abs(runs[0]["loss"] - runs[1]["loss"]) < 1e-6
    assert abs(runs[0]["losses"][0] - runs[1]["losses"][0]) < 1e-6
    assert_trees_close(runs[1]["grads"], runs[0]["grads"], rtol=0, atol=1e-6)


def test_pipeline_train_steps_lower_the_loss(pool):
    """Three AdamW steps at lr 1e-2 on a fixed batch over pp2 x tp2: finite
    and falling, as JAX's ``test_pp_train_step_runs_and_improves``."""
    tok, lab = tokens()
    params = convert.llama_params_to_numpy(_Tree(init_params(torch.Generator().manual_seed(2),
                                                             LlamaConfig(**FIELDS))))
    got = pool.run(workers.llama_parallel, FIELDS, TOTAL, CU, CHUNK, params, tok, lab,
                   LAYOUTS["pp2_tp2"], 3, {**ADAMW, "lr": 1e-2})
    losses = got[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(r["losses"] == losses for r in got)


@dataclasses.dataclass
class _Tree:
    """A parameter tree in the shape ``convert.llama_params_to_numpy`` reads."""

    tree: dict

    def param_tree(self):
        return self.tree
