"""The port's SPMD collective-consistency audit (``analysis/spmd_audit.py``).
The JAX twin's tests fail on this image's jax (its jaxpr walk), so the port
is held to its own plants: the dry matrices are uniform and well paired,
each planted divergence is caught, and one live gloo run at cp 2 (calc and
grad) is uniform and equals its dry record."""

import pytest
import torch

from magiattention_tpu_torch.analysis import spmd_audit as sa
from magiattention_tpu_torch.comm.group_collective import exchange


def test_the_dry_group_matrix_is_uniform():
    errors, report = sa.audit_group_matrix(cps=(1, 2, 4))
    assert errors == []
    assert report["group_cast impl=auto cp=1"] == []
    assert all(s.startswith("all_to_all") for s in report["group_cast impl=a2a cp=4"])


def test_the_self_test_plants_are_caught():
    assert sa.self_test() == []


def _records(world, issue):
    return sa._plant_records(world, issue)


def test_a_rank_gated_extra_ppermute_diverges():
    x = torch.zeros(4)

    def gated(rank, g):
        exchange(x, (rank + 1) % 2, (rank - 1) % 2, g)
        if rank == 0:
            exchange(x, 1, 1, g)

    errors, _ = sa.uniformity_errors("plant", _records(2, gated))
    assert any("diverges from rank 0 at schedule position 1" in e for e in errors)


def test_a_one_sided_permutation_is_caught():
    x = torch.zeros(4)

    def one_sided(rank, g):
        if rank == 0:
            exchange(x, 1, 1, g)

    errors = sa.hop_pairing_errors(_records(2, one_sided))
    assert any("1/2 ranks participate" in e for e in errors)
    assert any("do not pair" in e for e in errors)


def test_a_mixed_shift_permutation_is_caught():
    x = torch.zeros(4)

    def mixed(rank, g):
        s = 1 if rank < 2 else 2
        exchange(x, (rank + s) % 4, (rank - s) % 4, g)

    errors = sa.hop_pairing_errors(_records(4, mixed))
    assert any("mixed shifts" in e for e in errors)


def test_a_full_rotation_is_clean():
    x = torch.zeros(4)
    recs = _records(4, lambda rank, g: exchange(x, (rank + 1) % 4, (rank - 1) % 4, g))
    errors, sig = sa.uniformity_errors("rotation", recs)
    assert errors == [] and sa.signature_shifts(sig) == [1]


def test_the_hierarchical_census_is_per_level():
    errors, report = sa.audit_hier_matrix(meshes=((2, 2),))
    assert errors == []
    for impl in ("a2a", "hops"):
        sig = report[f"hier_cast impl={impl} mesh=2x2"]
        assert sum(s.startswith("all_to_all[inter/2]") for s in sig) == 1
        assert all("[inter/" in s or "[intra/" in s for s in sig)


def test_tp_decode_records_zero_collectives():
    errors, report = sa.audit_tp_decode()
    assert errors == [] and all(v == [] for v in report.values())


def test_cp_decode_and_the_degraded_build_stay_uniform():
    errors, report = sa.audit_cp_decode()
    assert errors == []
    assert len(report["cp_decode cp=4"]) == 2
    errors, report = sa.audit_variants()
    assert errors == [] and len(report["degraded_hops_build cp=4"]) == 1


@pytest.fixture(scope="module")
def pool():
    from magiattention_tpu_torch.testing.dist import RankPool

    with RankPool(2) as p:
        yield p


@pytest.mark.parametrize("impl", ["hops", "a2a"])
def test_a_live_cp2_calc_and_grad_is_uniform_and_equals_its_dry_record(pool, impl):
    results = pool.run(sa.dist_attn_rank, 2, impl, 256, 64)
    errors, sig = sa.live_dist_attn_errors(f"cp=2 {impl}", results, impl)
    assert errors == []
    want = {"hops": "ppermute", "a2a": "all_to_all"}[impl]
    assert sig and all(s.startswith(want) for s in sig)
    assert results[0]["expected_fwd"] == {want: 1}
