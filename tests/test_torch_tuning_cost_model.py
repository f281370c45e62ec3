"""The ranking half of the port's cost model (``magiattention_tpu_torch/
tuning/cost_model.py``), on the CPU.

The counts behind every candidate (entries, steps, live and dead slots)
equal the same quantities from the JAX package's ``estimate_entries`` at
the port's 64 x 64 tile, on masks made from a seed with numpy; the sparse
grid has no dead slot. The candidate set is the build's: its tile, both
grids, head_block 1 / G / 2G snapped to the GQA geometry; feasibility is
the launchers'; ties inside the error bar go by the Hopper preference order
and a candidate clearly cheaper outside it wins."""

import numpy as np
import pytest

from magiattention_tpu.tuning.cost_model import estimate_entries as jax_estimate_entries
from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal
from magiattention_tpu_torch.tuning import cost_model as cm


def _varlen(seed: int, total: int = 4096):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, total), size=rng.integers(2, 10), replace=False))
    b = [0, *cuts.tolist(), total]
    qr = [(x, y) for x, y in zip(b[:-1], b[1:])]
    ty = rng.integers(0, 4, size=len(qr)).tolist()
    return qr, list(qr), ty


MASKS = {
    "causal_4096": ([(0, 4096)], [(0, 4096)], [1]),
    "hetero_16k": split_slices(varlen_block_causal(16384)),
    "window_512_8k": ([(0, 511), (511, 8192)], [(0, 511), (0, 8192)], [1, 3]),
    **{f"varlen_seed{s}": _varlen(s) for s in range(4)},
}


@pytest.mark.parametrize("heads", [(32, 8), (16, 8), (8, 8), (12, 4)], ids=str)
@pytest.mark.parametrize("name", sorted(MASKS))
def test_counts_equal_jaxs_estimate(name, heads):
    qr, kr, ty = MASKS[name]
    hq, hk = heads
    entries, steps, nq = jax_estimate_entries(qr, kr, ty, 64, 64)
    cands = cm.rank_candidates(qr, kr, ty, hq, hk, head_dim=128)
    g = hq // hk
    assert {(c.head_block, c.grid) for c in cands} == {
        (hb, grid) for hb in {1, g, 2 * g if hq % (2 * g) == 0 else g}
        for grid in ("row_major", "sparse")}
    for c in cands:
        rows = hq // c.head_block
        assert (c.block_q, c.block_k, c.entries, c.steps) == (64, 64, entries, steps)
        assert c.live_slots == rows * entries
        if c.grid == "sparse":
            assert c.dead_slots == 0
        else:
            assert c.dead_slots == max(rows * nq * steps - rows * entries, 0)
        assert c.mma_seconds == pytest.approx(
            4 * 128 * hq * entries * 64 * 64 / (989e12 * cm.MMA_EFFICIENCY), rel=1e-12)
        assert c.feasible


def test_row_major_only_and_shard_constraints():
    qr, kr, ty = MASKS["hetero_16k"]
    rows = cm.rank_candidates(qr, kr, ty, 16, 8, include_sparse=False)
    assert {c.grid for c in rows} == {"row_major"}
    assert cm.rank_candidates(qr, kr, ty, 16, 8, max_block_q=32) == []
    assert cm.rank_candidates(qr, kr, ty, 16, 8, max_block_k=64)


def test_launch_feasibility():
    # a head dim the build has no tile for (16; 32 has one since the d-32
    # kernels): nothing feasible, the preference order (head_block G, the
    # density's grid) comes back
    cands = cm.rank_candidates([(0, 4096)], [(0, 4096)], [1], 8, 4, head_dim=16)
    assert cands and not any(c.feasible for c in cands)
    assert (cands[0].head_block, cands[0].grid) == (2, "row_major")
    assert not cm.any_feasible_rung([(0, 4096)], [(0, 4096)], [1], head_dim=16,
                                    num_heads_q=8, num_heads_kv=4)
    assert cm.any_feasible_rung([(0, 4096)], [(0, 4096)], [1], head_dim=32,
                                num_heads_q=8, num_heads_kv=4)
    # past 65,535 q blocks the row-major grid does not launch, the sparse one does
    t = 65536 * 64
    assert not cm.smem_feasible([(0, t)], [(0, 64)], [0], 64, 64, num_heads_q=1,
                                num_heads_kv=1)
    assert cm.smem_feasible([(0, t)], [(0, 64)], [0], 64, 64, num_heads_q=1, num_heads_kv=1,
                            grid="sparse")
    # head_block must be 1 or a multiple of G dividing hq; the tile the build's
    assert not cm.launch_feasible(4096, 4096, 16, 8, 128, 64, 64, 3, "row_major")
    assert not cm.launch_feasible(4096, 4096, 16, 8, 128, 128, 64, 2, "row_major")
    assert cm.launch_feasible(4096, 4096, 16, 8, 128, 64, 64, 4, "sparse")


@pytest.fixture
def fees(monkeypatch):
    def set_fees(live=0.0, dead=0.0, sparse=0.0):
        monkeypatch.setattr(cm, "LIVE_SLOT_S", live)
        monkeypatch.setattr(cm, "DEAD_SLOT_S", dead)
        monkeypatch.setattr(cm, "SPARSE_SLOT_S", sparse)
    return set_fees


@pytest.mark.parametrize("name,grid", [("causal_4096", "row_major"), ("hetero_16k", "sparse"),
                                       ("window_512_8k", "sparse")])
def test_ties_go_by_the_preference_order(name, grid, fees):
    """Every candidate within the band: head_block G on the density's grid."""
    fees()
    qr, kr, ty = MASKS[name]
    best = cm.rank_candidates(qr, kr, ty, 16, 8)[0]
    assert (best.head_block, best.grid) == (2, grid)


def test_a_clear_winner_leaves_the_band(fees):
    qr, kr, ty = MASKS["hetero_16k"]
    # a sparse slot priced far above the row-major grid's: row-major wins
    # on the heterogeneous mask; a live slot priced high: 2G (fewest rows)
    fees(sparse=1e-6)
    assert cm.rank_candidates(qr, kr, ty, 16, 8)[0].grid == "row_major"
    fees(live=1e-6, sparse=1e-6)
    assert cm.rank_candidates(qr, kr, ty, 16, 8)[0].head_block == 4
    # dead slots priced high keep the dense mask's head_block but the
    # sparse grid, which has none
    fees(dead=1e-6)
    cqr, ckr, cty = MASKS["causal_4096"]
    best = cm.rank_candidates(cqr, ckr, cty, 16, 8)[0]
    assert best.grid == "sparse" and best.dead_slots == 0


@pytest.mark.parametrize("name", ["varlen_seed1", "hetero_16k"])
def test_ranking_is_cost_ordered_past_the_tie_pool(name, fees):
    fees(live=1e-8, dead=1e-9, sparse=2e-8)
    qr, kr, ty = MASKS[name]
    cands = cm.rank_candidates(qr, kr, ty, 32, 8)
    hetero = cm.mask_density(qr, kr, ty) < cm.SPARSE_DENSITY_THRESHOLD
    tol = cm.SPARSE_TIE_TOLERANCE if hetero else cm.TIE_TOLERANCE
    best = min(c.cost_seconds for c in cands)
    tied = [c for c in cands if c.cost_seconds <= best * (1 + tol)]
    assert set(cands[:len(tied)]) == set(tied)
    rest = [c.cost_seconds for c in cands[len(tied):]]
    assert rest == sorted(rest)
