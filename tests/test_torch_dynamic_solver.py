"""The port's dynamic (qo-comm) solvers against the JAX package's, host
only: every solver (KD, NCQ, locality greedy, grid, SNF, auto) and
``dynamic_solver_for`` over every ``DynamicAttnAlgType``, on the port's
``DYNSOLVER_WORKLOADS`` masks (the same slice lists as JAX's) at 16k
tokens and cp 2 and 4. Each rank's rectangles (``to_array()``) must be
byte-identical to JAX's, and so must the areas, ``balance_ratio``,
``rank_comm_rows`` and ``modeled_step_cost``."""

import numpy as np
import pytest

from magiattention_tpu.common.enum import DynamicAttnAlgType as JaxAlg
from magiattention_tpu.common.rectangle import AttnRectangles as JaxRects
from magiattention_tpu import meta as jax_meta
from magiattention_tpu.testing.workloads import DYNSOLVER_WORKLOADS as JAX_WORKLOADS
from magiattention_tpu_torch import meta
from magiattention_tpu_torch.common import DynamicAttnAlgType
from magiattention_tpu_torch.common.rectangle import AttnRectangles
from magiattention_tpu_torch.testing.workloads import DYNSOLVER_WORKLOADS

TOTAL = 16384
SOLVERS = {
    "kd": "DynamicAttnSolver",
    "ncq": "NCQDynamicSolver",
    "locality": "LocalityGreedySolver",
    "grid": "GridLocalitySolver",
    "snf": "SNFDynamicSolver",
    "auto": "AutoDynamicSolver",
}


def _rects(cls, slices):
    return cls.from_ranges([(s[0], s[1]) for s in slices], [(s[2], s[3]) for s in slices],
                           [s[4] for s in slices])


def _same_solution(js, ps, cp):
    assert len(ps.rank_rects) == len(js.rank_rects) == cp
    for r, (jr, pr) in enumerate(zip(js.rank_rects, ps.rank_rects)):
        ja, pa = np.asarray(jr.to_array()), np.asarray(pr.to_array())
        assert ja.dtype == pa.dtype and ja.shape == pa.shape, r
        assert ja.tobytes() == pa.tobytes(), f"rank {r}'s rectangles differ"
    assert ps.areas == js.areas
    assert ps.balance_ratio == js.balance_ratio
    assert meta.rank_comm_rows(ps, TOTAL, cp) == jax_meta.rank_comm_rows(js, TOTAL, cp)
    assert meta.modeled_step_cost(ps, TOTAL, cp) == jax_meta.modeled_step_cost(js, TOTAL, cp)


def test_workloads_are_jax_workloads():
    assert set(DYNSOLVER_WORKLOADS) == set(JAX_WORKLOADS)
    for name, fn in DYNSOLVER_WORKLOADS.items():
        assert [tuple(map(int, s)) for s in fn(TOTAL)] == \
            [tuple(map(int, s)) for s in JAX_WORKLOADS[name](TOTAL)], name


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("workload", sorted(DYNSOLVER_WORKLOADS))
def test_solver_is_jax_solver(workload, solver, cp):
    slices = DYNSOLVER_WORKLOADS[workload](TOTAL)
    js = getattr(jax_meta, SOLVERS[solver])().solve(_rects(JaxRects, slices), cp,
                                                    total_seqlen=TOTAL)
    ps = getattr(meta, SOLVERS[solver])().solve(_rects(AttnRectangles, slices), cp,
                                                total_seqlen=TOTAL)
    assert sum(ps.areas) == _rects(AttnRectangles, slices).area
    _same_solution(js, ps, cp)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("alg", list(DynamicAttnAlgType), ids=lambda a: a.name.lower())
@pytest.mark.parametrize("workload", sorted(DYNSOLVER_WORKLOADS))
def test_dynamic_solver_for_is_jax_factory(workload, alg, cp):
    assert [a.value for a in DynamicAttnAlgType] == [a.value for a in JaxAlg]
    slices = DYNSOLVER_WORKLOADS[workload](TOTAL)
    ps_solver = meta.dynamic_solver_for(alg)
    js_solver = jax_meta.dynamic_solver_for(JaxAlg(alg.value))
    assert type(ps_solver).__name__ == type(js_solver).__name__
    _same_solution(js_solver.solve(_rects(JaxRects, slices), cp, total_seqlen=TOTAL),
                   ps_solver.solve(_rects(AttnRectangles, slices), cp, total_seqlen=TOTAL), cp)


def test_grid_jitter_and_constants_are_jax_defaults():
    """The grid solver's restarts draw from ``random.Random(seed)`` and the
    comm weight is the reference's 1024 area-units per row, in both."""
    slices = DYNSOLVER_WORKLOADS["varlen_block_causal"](TOTAL)
    for seed in (0, 3):
        js = jax_meta.GridLocalitySolver(seed=seed, restarts=6).solve(
            _rects(JaxRects, slices), 4, total_seqlen=TOTAL)
        ps = meta.GridLocalitySolver(seed=seed, restarts=6).solve(
            _rects(AttnRectangles, slices), 4, total_seqlen=TOTAL)
        _same_solution(js, ps, 4)
    assert meta.AutoDynamicSolver().c2a == jax_meta.AutoDynamicSolver().c2a == 1024.0
