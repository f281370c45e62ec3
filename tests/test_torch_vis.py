"""``utils/vis.py`` of the port: the mask polygons against the JAX
package's on seeded slices and against the dense mask, the mask and
dynamic-solution pictures, a no-op without matplotlib, and the
dynamic-solver plot that ``parallel/qo_comm.py`` draws at ``DEBUG``
logging (a drawing failure never stops planning)."""

import logging
import os
import sys

import numpy as np
import pytest

from magiattention_tpu.utils.vis import _mask_polygon as jax_mask_polygon
from magiattention_tpu_torch.common.enum import AttnMaskType
from magiattention_tpu_torch.common.mask import slice_mask
from magiattention_tpu_torch.common.rectangle import AttnRectangles
from magiattention_tpu_torch.meta.solver.dynamic_attn_solver import DynamicAttnSolver
from magiattention_tpu_torch.parallel import qo_comm
from magiattention_tpu_torch.utils import plot_dynamic_solution, plot_mask
from magiattention_tpu_torch.utils.vis import _mask_polygon


@pytest.mark.parametrize("seed", range(4))
def test_mask_polygon_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        qs, ks = (int(x) for x in rng.integers(0, 64, 2))
        qe, ke = qs + int(rng.integers(1, 64)), ks + int(rng.integers(1, 64))
        mt = int(rng.integers(0, 4))
        assert _mask_polygon(qs, qe, ks, ke, mt) == jax_mask_polygon(qs, qe, ks, ke, mt)


@pytest.mark.parametrize("mt", list(AttnMaskType))
def test_mask_polygon_matches_dense_semantics(mt):
    """The polygon's edges agree with the dense mask's row bounds at the
    slice's first and last rows (the bounds are linear in q)."""
    qs, qe, ks, ke = 4, 12, 2, 16
    poly = _mask_polygon(qs, qe, ks, ke, mt)
    dense = np.asarray(slice_mask(qs, qe, ks, ke, mt, 16, 20))
    for q in (qs, qe - 1):
        row = np.where(dense[q])[0]
        if row.size == 0:
            continue
        (l0, _), (l1, _) = poly[0], poly[1]
        (r1, _), (r0, _) = poly[2], poly[3]
        frac = (q - qs) / (qe - qs)
        assert abs(l0 + (l1 - l0) * frac - row[0]) <= 1.0
        assert abs(r0 + (r1 - r0) * frac - (row[-1] + 1)) <= 1.0


def _solution(total=256):
    qr, kr, ts = [(0, 128), (128, 256)], [(0, 128), (64, 256)], [1, 3]
    return qr, kr, ts, DynamicAttnSolver().solve(AttnRectangles.from_ranges(qr, kr, ts), 4,
                                                 total_seqlen=total)


def test_plot_mask_and_solution(tmp_path):
    qr, kr, ts, sol = _solution()
    p1 = plot_mask(qr, kr, ts, 256, 256, str(tmp_path / "mask.png"))
    assert p1 and os.path.getsize(p1) > 1000
    p2 = plot_dynamic_solution(sol, 256, 256, str(tmp_path / "buckets.png"))
    assert p2 and os.path.getsize(p2) > 1000


def test_plots_are_a_no_op_without_matplotlib(tmp_path, monkeypatch, caplog):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    qr, kr, ts, sol = _solution()
    with caplog.at_level(logging.WARNING):
        assert plot_mask(qr, kr, ts, 256, 256, str(tmp_path / "m.png")) is None
        assert plot_dynamic_solution(sol, 256, 256, str(tmp_path / "b.png")) is None
    assert not os.listdir(tmp_path) and "matplotlib unavailable" in caplog.text


@pytest.fixture
def log_level():
    """Set the package logger's level for a test (``setLevel``: its
    ``isEnabledFor`` cache is cleared), restored after."""
    logger = logging.getLogger("magiattention_tpu_torch")
    saved = logger.level
    yield logger.setLevel
    logger.setLevel(saved)


@pytest.mark.parametrize("level,drawn", [(logging.INFO, False), (logging.DEBUG, True)])
def test_qo_plan_draws_its_partition_at_debug(level, drawn, tmp_path, monkeypatch, log_level):
    monkeypatch.chdir(tmp_path)
    log_level(level)
    slices = np.array([[0, 128, 0, 128, 1], [128, 256, 64, 256, 3]], dtype=np.int64)
    plan = qo_comm.build_qo_comm_plan(slices, 256, 2, solver=DynamicAttnSolver())
    assert plan.cp_size == 2
    pngs = [f for f in os.listdir(tmp_path) if f.startswith("dyn_solver_buckets_cp2_")]
    assert len(pngs) == (1 if drawn else 0)


def test_a_drawing_failure_never_stops_planning(tmp_path, monkeypatch, log_level):
    monkeypatch.chdir(tmp_path)
    log_level(logging.DEBUG)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr("magiattention_tpu_torch.utils.vis.plot_dynamic_solution", boom)
    slices = np.array([[0, 256, 0, 256, 1]], dtype=np.int64)
    assert qo_comm.build_qo_comm_plan(slices, 256, 2, solver=DynamicAttnSolver()).cp_size == 2
