"""The port's trace audit (``analysis/trace_audit.py``): the comm metas'
expected collective counts equal the JAX package's host arithmetic, every
cast of a plan recorded dry issues exactly them (and a planted extra
exchange breaks the census), the guard and upcast censuses, and the
rebuild guard. JAX's census itself reads jaxprs and is no yardstick here:
the port is held to the JAX package's expectation functions and to its own
plants."""

import numpy as np
import pytest
import torch

from magiattention_tpu.analysis import trace_audit as jax_ta
from magiattention_tpu.comm.group_collective import GroupCollectiveMeta as JaxMeta
from magiattention_tpu_torch.analysis import trace_audit as ta
from magiattention_tpu_torch.comm.group_collective import (
    DryGroup,
    GroupCollectiveMeta,
    exchange,
    record_collectives,
)


def _send_map(kind, cp, t=32, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return [[np.empty(0, np.int64) for _ in range(cp)] for _ in range(cp)]
    return [[rng.choice(t, size=int(rng.integers(1, 12)), replace=False)
             if s != d else np.empty(0, np.int64) for d in range(cp)] for s in range(cp)]


@pytest.mark.parametrize("kind,cp,impl", [
    ("skewed", 4, "a2a"), ("skewed", 4, "hops"), ("skewed", 2, "hops"), ("skewed", 4, "auto"),
    ("empty", 4, "auto"), ("empty", 4, "a2a"), ("skewed", 1, "auto"),
])
def test_expected_counts_equal_jax(kind, cp, impl):
    smap = _send_map(kind, cp)
    port = GroupCollectiveMeta.build(smap, [32] * cp, impl=impl)
    jax = JaxMeta.build(smap, [32] * cp, impl=impl)
    assert port.impl == jax.impl
    assert ta.expected_cast_collectives(port) == jax_ta.expected_cast_collectives(jax)
    for red in ("sum", "lse"):
        assert ta.expected_reduce_collectives(port, red) == \
            jax_ta.expected_reduce_collectives(jax, red)
    assert ta._scale_counts(ta.expected_cast_collectives(port), 2) == \
        jax_ta._scale_counts(jax_ta.expected_cast_collectives(jax), 2)


def test_expected_plan_counts_equal_jax():
    from magiattention_tpu.common.enum import AttnMaskType
    from magiattention_tpu.common.ranges import AttnRanges
    from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu.parallel.dist_attn import build_dist_attn_plan

    whole = AttnRanges.from_ranges([(0, 512)])
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(whole, whole, [AttnMaskType.CAUSAL], 512,
                                                      512, chunk_size=64, cp_size=4)
    for degree in (0, 2):
        jplan = build_dist_attn_plan(mq, bucket, block_q=64, block_k=64, overlap_config=
                                     OverlapConfig(degree=degree, min_stage_rows=64))
        plan, _ = ta.build_plan(4, "causal", degree=degree)
        assert ta.expected_plan_cast_collectives(plan) == \
            jax_ta.expected_plan_cast_collectives(jplan)


@pytest.mark.parametrize("cp,kind,impl,degree", [
    (2, "causal", None, 0), (2, "local", None, 0), (4, "causal", "hops", 0),
    (4, "causal", "a2a", 0), (4, "causal", "hops", 2), (4, "causal", "a2a", 2),
])
def test_every_cast_of_a_plan_issues_its_expectation(cp, kind, impl, degree):
    plan, _ = ta.build_plan(cp, kind, degree=degree, impl=impl)
    assert ta.audit_plan_collectives(plan) == []
    want = ta.expected_plan_cast_collectives(plan)
    for rank in range(cp):
        assert ta.collective_census(ta.plan_cast_records(plan, rank)) == want
        assert ta.collective_census(ta.plan_cast_records(plan, rank, backward=True)) == \
            ta._scale_counts(want, 2)


def test_hierarchical_plans_return_no_errors():
    plan, _ = ta.build_plan(4, "causal", cp_mesh_shape=(2, 2))
    assert ta.audit_plan_collectives(plan) == []


def test_a_planted_extra_exchange_breaks_the_census():
    plan, _ = ta.build_plan(2, "causal")
    want = ta.expected_plan_cast_collectives(plan)
    with record_collectives("dry") as records:
        ta.plan_cast_records(plan, 0)
        exchange(torch.zeros(4), 1, 1, DryGroup(0, 2))
    assert ta.collective_census(records) != want
    assert ta.collective_census(records)["ppermute"] == want["ppermute"] + 1


def test_the_runtime_matrix_and_group_collectives_issue_their_expectations():
    assert ta.audit_flex_matrix()[0] == []
    assert ta.audit_group_collectives()[0] == []
    errors, report = ta.audit_decode()
    assert errors == [] and all(not r["census"] for r in report.values())


def test_guard_census_is_zero_off_and_counts_under_check():
    errors, report = ta.audit_guard_ops()
    assert errors == []
    assert report["guard_census"]["off"] == 0 and report["guard_census"]["check_fwd"] >= 1


def test_kernels_count_as_opaque_calls():
    plan, _ = ta.build_plan(2, "causal")
    with ta.op_census() as c:
        ta.dry_dist_attn(plan, 0)
    assert c.kernels == {"_fwd_torch": 1, "_dq_torch": 1, "_dkv_torch": 1}


def test_upcast_census_matches_the_checked_in_table():
    errors, census = ta.audit_dtypes(ta.load_expectations())
    assert errors == []
    assert set(census) <= set(ta.load_expectations())


def test_planted_upcast_and_guard_sentinel_are_counted():
    assert ta.upcast_census(lambda: torch.zeros(4, dtype=torch.bfloat16).float())["_to_copy"] == 1
    assert ta.guard_census(lambda: torch.isfinite(torch.zeros(4))) == 1


def test_same_shape_new_values_build_nothing():
    assert ta.audit_retrace() == []
    assert ta.audit_decode_retrace() == []


def test_the_rebuild_counter_counts_a_cold_build():
    from magiattention_tpu_torch.ops import flex_attn as fa

    call = ta.count_traces(lambda: fa.flex_flash_attn_func(
        *(torch.zeros((192, 1, 64)) for _ in range(3)), [(0, 192)], [(0, 192)], [1]))
    fa._cached_meta.cache_clear()
    call()
    call()
    assert call.traces == 1


def test_patches_are_restored_after_an_exception():
    from magiattention_tpu_torch.ops import flex_attn as fa

    real = fa._fwd_torch
    with pytest.raises(RuntimeError):
        with ta.op_census():
            assert fa._fwd_torch is not real
            raise RuntimeError("inside the census")
    assert fa._fwd_torch is real
