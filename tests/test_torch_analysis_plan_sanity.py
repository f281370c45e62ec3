"""The port's plan sanitizer (``analysis/plan_sanity.py``) against the JAX
package's: the same plans validate clean through both, every planted
corruption of ``tests/test_analysis/test_plan_sanity.py`` is caught with
the JAX package's message, and ``MAGI_ATTENTION_VALIDATE=plan|trace`` runs
at the end of ``build_dist_attn_plan`` with its counters."""

import dataclasses

import numpy as np
import pytest

from magiattention_tpu.analysis import plan_sanity as jax_ps
from magiattention_tpu.comm.group_collective import GroupCollectiveMeta as JaxMeta
from magiattention_tpu_torch import env, telemetry
from magiattention_tpu_torch.analysis import plan_sanity as ps
from magiattention_tpu_torch.analysis import trace_audit as ta
from magiattention_tpu_torch.comm import group_collective as gc
from magiattention_tpu_torch.comm.group_collective import GroupCollectiveMeta
from magiattention_tpu_torch.parallel import dist_attn

BLOCK = 64  # both packages' plans at the port's tile


def _send_map(cp, t=32, seed=3):
    rng = np.random.default_rng(seed)
    return [[rng.choice(t, size=int(rng.integers(1, 10)), replace=False)
             if s != d else np.empty(0, np.int64) for d in range(cp)] for s in range(cp)]


def _plans(pkg, degree=0, cp=4, total=1024, varlen=False, mesh=None):
    """(plan, bucket) of a causal (or varlen block-causal) mask, built by
    ``pkg`` ("jax" or "torch") at the port's tile."""
    if pkg == "jax":
        from magiattention_tpu.common.enum import AttnMaskType
        from magiattention_tpu.common.ranges import AttnRanges
        from magiattention_tpu.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
        from magiattention_tpu.meta.solver.overlap_solver import OverlapConfig
        from magiattention_tpu.parallel.dist_attn import build_dist_attn_plan
    else:
        from magiattention_tpu_torch.common.enum import AttnMaskType
        from magiattention_tpu_torch.common.ranges import AttnRanges
        from magiattention_tpu_torch.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
        from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
        from magiattention_tpu_torch.parallel.dist_attn import build_dist_attn_plan
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    qr, kr, ty = (split_slices(varlen_block_causal(total)) if varlen
                  else ([(0, total)], [(0, total)], [1]))
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr), [AttnMaskType(t) for t in ty],
        total, total, chunk_size=total // 16, cp_size=cp)
    oc = OverlapConfig(degree=degree, min_stage_rows=64) if degree else None
    return build_dist_attn_plan(mq, bucket, block_q=BLOCK, block_k=BLOCK, overlap_config=oc,
                                cp_mesh_shape=mesh), bucket


@pytest.fixture
def counters():
    """Telemetry on, a clean registry; yields (checks, failures) readers."""
    telemetry.set_enabled(True)
    telemetry.reset()

    def read():
        c = telemetry.snapshot()["counters"]
        return (sum(v for k, v in c.items() if k.startswith("magi_validate_plan_checks")),
                sum(v for k, v in c.items() if k.startswith("magi_validate_failures")))

    yield read
    telemetry.reset()
    telemetry.set_enabled(None)


def _raises_like_jax(port_call, jax_call):
    with pytest.raises(jax_ps.PlanValidationError) as want:
        jax_call()
    with pytest.raises(ps.PlanValidationError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("degree,varlen,mesh", [(0, True, None), (2, False, None),
                                                (0, True, (2, 2))])
def test_both_plans_validate_clean_through_both_sanitizers(degree, varlen, mesh):
    for pkg in ("jax", "torch"):
        plan, bucket = _plans(pkg, degree=degree, varlen=varlen, mesh=mesh)
        ps.validate_plan(plan, total_area=bucket.area)
        jax_ps.validate_plan(plan, total_area=bucket.area)


def test_a_staged_hierarchical_plan_validates_clean():
    """A departure: the JAX sanitizer reads ``cp_size`` off each stage's
    meta, which a two-level meta does not have; the port counts its ranks
    as n_inter * n_intra, so staged hierarchical plans validate."""
    for pkg in ("jax", "torch"):
        plan, bucket = _plans(pkg, degree=2, mesh=(2, 2))
        assert plan.stages
        ps.validate_plan(plan, total_area=bucket.area)
        with pytest.raises(AttributeError, match="cp_size"):
            jax_ps.validate_plan(plan, total_area=bucket.area)


@pytest.mark.parametrize("bad", [
    (0, 128, 0, 64, 1), (-8, 64, 0, 64, 0), (0, 64, 0, 96, 0), (8, 8, 0, 64, 0),
    (0, 64, 16, 16, 0), (0, 64, 0, 64, 9), (0, 64, 0, 16, 3),
])
def test_malformed_slices_fail_with_the_jax_message(bad):
    _raises_like_jax(lambda: ps.validate_slices([bad], 64, 64),
                     lambda: jax_ps.validate_slices([bad], 64, 64))


def test_clean_slices_and_slice_objects_pass():
    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.range import AttnRange
    from magiattention_tpu_torch.meta.containers import AttnSlice

    ps.validate_slices([(0, 64, 0, 64, 1), (64, 128, 0, 128, 0), (0, 32, 0, 32, 3)], 128, 128)
    ps.validate_slices([AttnSlice(AttnRange(0, 64), AttnRange(0, 64), AttnMaskType.CAUSAL)],
                       64, 64)


def _pad_not_trash(m):
    rs = np.array(m.recv_sel, copy=True)
    d = next(i for i in range(4) if m.recv_total[i] < m.max_recv)
    rs[d, m.max_recv - 1] = 0
    return dataclasses.replace(m, recv_sel=rs)


def _non_permutation(m):
    rs = np.array(m.recv_sel, copy=True)
    d = next(i for i in range(4) if m.recv_total[i] >= 2)
    rs[d, 1] = rs[d, 0]
    return dataclasses.replace(m, recv_sel=rs)


def _send_total_mismatch(m):
    st = list(m.send_total)
    st[0] += 8
    return dataclasses.replace(m, send_total=tuple(st))


def _unpadded_hop(m):
    h0 = m.hops[0]
    bad = dataclasses.replace(h0, size=h0.size + 1,
                              send_idx=np.pad(h0.send_idx, ((0, 0), (0, 1))),
                              recv_pos=np.pad(h0.recv_pos, ((0, 0), (0, 1))),
                              seg_ids=np.pad(h0.seg_ids, ((0, 0), (0, 1))))
    return dataclasses.replace(m, hops=(bad,) + m.hops[1:])


META_PLANTS = {  # name -> (impls it applies to, mutation, num_local_rows)
    "non_permutation": (("a2a", "hops"), _non_permutation, None),
    "pad_not_trash": (("a2a", "hops"), _pad_not_trash, None),
    "scheduled_below_true": (("a2a", "hops"),
                             lambda m: dataclasses.replace(m, impl="hops", hops=()), None),
    "send_recv_total_mismatch": (("a2a", "hops"), _send_total_mismatch, None),
    "send_idx_oob": (("a2a", "hops"), lambda m: m, 4),
    "hop_unpadded_size": (("hops",), _unpadded_hop, None),
    "duplicate_hop_shift": (("hops",), lambda m: dataclasses.replace(
        m, hops=m.hops + (m.hops[0],)), None),
}


@pytest.mark.parametrize("plant,impl", [(p, i) for p in sorted(META_PLANTS)
                                         for i in META_PLANTS[p][0]])
def test_planted_meta_corruption_caught_with_the_jax_message(plant, impl):
    _impls, mutate, rows = META_PLANTS[plant]
    port = GroupCollectiveMeta.build(_send_map(4), [32] * 4, impl=impl)
    jax = JaxMeta.build(_send_map(4), [32] * 4, impl=impl)
    ps.validate_comm_meta(port, num_local_rows=32)
    _raises_like_jax(lambda: ps.validate_comm_meta(mutate(port), num_local_rows=rows),
                     lambda: jax_ps.validate_comm_meta(mutate(jax), num_local_rows=rows))


def _stage_comm_mismatch(p):
    sp = p.stages[0]
    bad = dataclasses.replace(sp, comm=_send_total_mismatch(sp.comm))
    return dataclasses.replace(p, stages=(bad,) + p.stages[1:])


PLAN_PLANTS = {  # name -> (degree, mutation, total_area offset)
    "wrong_total_area": (0, lambda p: p, 1),
    "lost_area": (0, lambda p: dataclasses.replace(
        p, max_rank_area=p.total_area // (2 * p.cp_size)), None),
    "stage_double_count": (2, lambda p: dataclasses.replace(
        p, stages=(dataclasses.replace(p.stages[0], max_rank_area=p.total_area),)
        + p.stages[1:]), None),
    "bad_stage_comm": (2, _stage_comm_mismatch, None),
}


@pytest.mark.parametrize("plant", sorted(PLAN_PLANTS))
def test_planted_plan_corruption_caught_with_the_jax_message(plant):
    degree, mutate, offset = PLAN_PLANTS[plant]
    port, bucket = _plans("torch", degree=degree)
    jax, jbucket = _plans("jax", degree=degree)
    area = None if offset is None else bucket.area + offset
    jarea = None if offset is None else jbucket.area + offset
    _raises_like_jax(lambda: ps.validate_plan(mutate(port), total_area=area),
                     lambda: jax_ps.validate_plan(mutate(jax), total_area=jarea))


@pytest.mark.parametrize("mesh", [None, (2, 2)])
@pytest.mark.parametrize("mode", ["plan", "trace"])
def test_the_build_hook_checks_every_plan(mode, mesh, counters, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", mode)
    for degree in (0, 2):
        _plans("torch", degree=degree, mesh=mesh)
    assert counters() == (2, 0)
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", "off")
    _plans("torch")
    assert counters() == (2, 0)  # off: the hook is one predicate


def _corrupting(real, mutate):
    def build(*args, **kwargs):
        return mutate(real(*args, **kwargs))

    return build


@pytest.mark.parametrize("degree", [0, 2])
def test_a_failing_check_raises_past_the_degradation_path(degree, counters, monkeypatch):
    """A corrupted plan raises PlanValidationError out of the builder — the
    fallback's ``except`` above the hook does not catch it — with one
    failure counted; under ``off`` it is returned unchecked."""
    monkeypatch.setattr(dist_attn, "_build_dist_attn_plan",
                        _corrupting(dist_attn._build_dist_attn_plan,
                                    lambda p: _replace_first_comm(p, _non_permutation)))
    _plans("torch", degree=degree)  # off
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", "plan")
    with pytest.raises(ps.PlanValidationError, match="not a permutation"):
        _plans("torch", degree=degree)
    assert counters() == (1, 1)


def _replace_first_comm(plan, mutate):
    if plan.merged_comm is not None:
        return dataclasses.replace(plan, merged_comm=mutate(plan.merged_comm))
    st0 = dataclasses.replace(plan.stages[0], comm=mutate(plan.stages[0].comm))
    return dataclasses.replace(plan, stages=(st0,) + plan.stages[1:])


def test_trace_mode_catches_a_planted_extra_exchange(counters, monkeypatch):
    real = gc.group_cast

    def extra_hop(x, rt, group):
        out = real(x, rt, group)
        gc.exchange(x[:1], (rt.rank + 1) % rt.cp_size, (rt.rank - 1) % rt.cp_size, group)
        return out

    monkeypatch.setattr(gc, "group_cast", extra_hop)
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", "plan")
    plan, _ = _plans("torch")  # the sanitizer reads tables only
    assert ta.audit_plan_collectives(plan)
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", "trace")
    with pytest.raises(ps.PlanValidationError, match="CommMeta expectation"):
        _plans("torch")
    assert counters() == (3, 1)  # two completed checks, and the failure's tick


def test_validate_is_no_longer_refused(monkeypatch):
    from magiattention_tpu_torch.api.interface import check_flag_comb

    for mode in ("off", "plan", "trace"):
        monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", mode)
        assert env.validate_mode() == mode
        check_flag_comb()
    monkeypatch.setenv("MAGI_ATTENTION_VALIDATE", "bogus")
    with pytest.raises(ValueError, match="MAGI_ATTENTION_VALIDATE"):
        check_flag_comb()
