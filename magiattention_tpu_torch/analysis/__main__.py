"""The port's static-analysis gate: ``python -m magiattention_tpu_torch.analysis``.

Runs the five passes of ``magiattention_tpu_torch/analysis/`` over the tree
(the passes and flags of the JAX package's ``exps/run_static_analysis.py``,
aimed at the port). Everything runs on the CPU:

1. **lint** (``lint.py``): MAGI002 / MAGI003 / MAGI005 over the package,
   filtered through ``analysis/allowlist.json``; a stale allowlist entry
   fails the gate too.
2. **trace** (``trace_audit.py``): the collective census of the cp
   runtime's forward and backward over plans x cp x impls and of the group
   cast / reduces (every rank recorded dry), the decode paths'
   zero-collective census and dtype contract, the guard census, the upcast
   census against ``trace_audit_expectations.json``, the hierarchical
   cast's per-level census and the rebuild guard.
3. **plan** (``plan_sanity.py``): canonical plans validate clean, and a
   battery of deliberately mutated slices, plans and metas each FAIL.
4. **spmd** (``spmd_audit.py``): per-rank collective signatures of every
   production collective path must be identical, with hop pairing
   well-formed; the keyed calc and grad, cp decode and the variants run
   live over gloo in one 4-rank pool.
5. **lifecycle** (``lifecycle.py``): every bounded event interleaving of
   the real serving host objects over the stubbed device layer, invariants
   at every canonical state (at least 10,000 states over the matrix).

``--self-test`` also proves each selected pass can fail on a planted
violation; ``--update`` re-records the upcast census; ``--only PASS``
(repeatable) restricts the run. Exit code 0 = clean, 1 = findings.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

PASSES = ("lint", "trace", "plan", "spmd", "lifecycle")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# pass 1: lint
# ---------------------------------------------------------------------------


def run_lint() -> list[str]:
    from .lint import lint_errors

    return lint_errors(REPO)


# ---------------------------------------------------------------------------
# pass 2: trace audit
# ---------------------------------------------------------------------------


def run_trace_audit(update: bool) -> list[str]:
    from . import trace_audit as ta

    errors: list[str] = []
    for fn in (ta.audit_flex_matrix, ta.audit_group_collectives, ta.audit_decode,
               ta.audit_guard_ops, ta.audit_hier_cast_levels):
        errors += fn()[0]
    if update:
        _, census = ta.audit_dtypes(None)
        ta.write_expectations(census)
        print(f"recorded upcast census -> {ta.EXPECTATIONS}")
    else:
        errors += ta.audit_dtypes(ta.load_expectations())[0]
    errors += ta.audit_retrace()
    errors += ta.audit_decode_retrace()
    return errors


# ---------------------------------------------------------------------------
# pass 3: plan sanitizer
# ---------------------------------------------------------------------------


def canonical_plans():
    """(label, plan, bucket area) for a merged varlen plan and a staged
    causal plan at cp=4: the two structural shapes the sanitizer covers."""
    from .. import env
    from ..common.enum import AttnMaskType
    from ..common.ranges import AttnRanges
    from ..meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from ..meta.solver.overlap_solver import OverlapConfig
    from ..parallel.dist_attn import build_dist_attn_plan
    from ..testing.workloads import varlen_block_causal

    out = []
    total, cp = 2048, 4
    chunk = total // (env.min_chunks_per_rank() * cp)
    slices = varlen_block_causal(total)
    qr = AttnRanges.from_ranges([(a, b) for a, b, _, _, _ in slices])
    kr = AttnRanges.from_ranges([(c, e) for _, _, c, e, _ in slices])
    mts = [AttnMaskType(t) for *_, t in slices]
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(qr, kr, mts, total, total,
                                                      chunk_size=chunk, cp_size=cp)
    out.append(("varlen merged", build_dist_attn_plan(mq, bucket), bucket.area))
    whole = AttnRanges.from_ranges([(0, total)])
    mq2, _, bucket2 = make_dispatch_meta_from_qk_ranges(
        whole, whole, [AttnMaskType.CAUSAL], total, total, chunk_size=chunk, cp_size=cp)
    staged = build_dist_attn_plan(mq2, bucket2,
                                  overlap_config=OverlapConfig(degree=2, min_stage_rows=64))
    out.append(("causal staged", staged, bucket2.area))
    return out


def _replace_comm(plan, comm):
    if plan.merged_comm is not None:
        return dataclasses.replace(plan, merged_comm=comm)
    st0 = dataclasses.replace(plan.stages[0], comm=comm)
    return dataclasses.replace(plan, stages=(st0,) + plan.stages[1:])


def mutations(plan):
    """Deliberately corrupted copies of ``plan`` (label, mutated): every one
    must FAIL validation."""
    import numpy as np

    out = []
    comm = plan.merged_comm or plan.stages[0].comm
    rs = np.array(comm.recv_sel, copy=True)
    d = next((i for i in range(comm.cp_size) if comm.recv_total[i] >= 2), None)
    if d is not None:  # two valid slots aimed at one source row
        rs[d, 1] = rs[d, 0]
        out.append(("non-permutation recv_sel",
                    _replace_comm(plan, dataclasses.replace(comm, recv_sel=rs))))
    if comm.impl == "hops" and comm.hops:  # claim zero scheduled volume
        out.append(("scheduled < true rows",
                    _replace_comm(plan, dataclasses.replace(comm, hops=()))))
    else:
        out.append(("scheduled < true rows",
                    _replace_comm(plan, dataclasses.replace(comm, impl="hops", hops=()))))
    st = list(comm.send_total)
    st[0] += 8
    out.append(("send/recv total mismatch",
                _replace_comm(plan, dataclasses.replace(comm, send_total=tuple(st)))))
    out.append(("lost mask area", dataclasses.replace(
        plan, max_rank_area=plan.total_area // (2 * plan.cp_size))))
    if plan.overlap_degree > 0 and plan.stages:
        big = dataclasses.replace(plan.stages[0], max_rank_area=plan.total_area)
        out.append(("stage double-counts area",
                    dataclasses.replace(plan, stages=(big,) + plan.stages[1:])))
    return out


MALFORMED_SLICES = (
    ("OOB q_range", [(0, 128, 0, 64, 1)]),
    ("OOB k_range", [(0, 64, 32, 96, 0)]),
    ("empty q_range", [(8, 8, 0, 64, 0)]),
    ("bad mask type", [(0, 64, 0, 64, 7)]),
    ("empty-row bicausal", [(0, 64, 0, 8, 3)]),
)


def run_plan_sanity() -> list[str]:
    from .plan_sanity import PlanValidationError, validate_plan, validate_slices

    errors: list[str] = []
    plans = canonical_plans()
    for label, plan, area in plans:
        try:
            validate_plan(plan, total_area=area)
        except PlanValidationError as exc:
            errors.append(f"clean plan '{label}' failed validation: {exc}")
    try:
        validate_slices([(0, 64, 0, 64, 1)], 64, 64)
    except PlanValidationError as exc:
        errors.append(f"clean slice failed validation: {exc}")
    for label, bad in MALFORMED_SLICES:
        try:
            validate_slices(bad, 64, 64)
            errors.append(f"malformed slice '{label}' PASSED validation")
        except PlanValidationError:
            pass
    for label, plan, _ in plans:
        for mut_label, mutated in mutations(plan):
            try:
                validate_plan(mutated)
                errors.append(f"mutated plan '{label} / {mut_label}' PASSED validation — the "
                              "sanitizer missed it")
            except PlanValidationError:
                pass
    return errors


# ---------------------------------------------------------------------------
# pass 4: SPMD collective consistency
# ---------------------------------------------------------------------------


def run_spmd_audit() -> list[str]:
    from ..testing.dist import RankPool
    from .spmd_audit import run_full_audit

    with RankPool(4) as pool:
        return run_full_audit(pool)[0]


# ---------------------------------------------------------------------------
# pass 5: serving lifecycle model check
# ---------------------------------------------------------------------------

LIFECYCLE_MIN_STATES = 10_000


def run_lifecycle() -> list[str]:
    from .lifecycle import run_lifecycle_check

    errors, report = run_lifecycle_check()
    total = sum(r["states"] for r in report.values())
    print(f"  lifecycle: {total} canonical states: "
          + ", ".join(f"{k} {r['states']}/{r['transitions']}" for k, r in report.items()))
    if not errors and total < LIFECYCLE_MIN_STATES:
        errors.append(f"lifecycle checker explored only {total} canonical states "
                      f"(< {LIFECYCLE_MIN_STATES}): the model matrix lost its depth or width")
    return errors


# ---------------------------------------------------------------------------
# --self-test: every pass must be able to fail
# ---------------------------------------------------------------------------

LINT_PLANTS = {
    "MAGI002": ("magiattention_tpu_torch/ops/planted.py",
                "import os\nflag = os.environ.get('X')\n"),
    "MAGI003": ("magiattention_tpu_torch/ops/planted.py",
                "import torch\ndef f(x: torch.Tensor):\n    return x.sum().item()\n"),
    "MAGI005": ("magiattention_tpu_torch/comm/planted.py",
                "import torch.distributed as dist\n"
                "def f(x, group):\n"
                "    rank = dist.get_rank(group)\n"
                "    if rank == 0:\n"
                "        dist.all_reduce(x, group=group)\n"
                "    return x\n"),
}


def self_test_lint() -> list[str]:
    from .lint import apply_allowlist, lint_source

    errors: list[str] = []
    for rule, (path, src) in LINT_PLANTS.items():
        if not any(v.rule == rule for v in lint_source(src, path)):
            errors.append(f"self-test: planted {rule} violation NOT flagged")
    path, src = LINT_PLANTS["MAGI003"]
    if lint_source(src.replace(".item()", ".item()  # magi-allow: MAGI003"), path):
        errors.append("self-test: magi-allow pragma did not suppress")
    stale = {"rule": "MAGI003", "path": path, "symbol": "gone", "justification": "planted"}
    if apply_allowlist([], [stale])[1] != [stale]:
        errors.append("self-test: a stale allowlist entry was not reported")
    return errors


def self_test_trace() -> list[str]:
    import torch

    from ..comm.group_collective import DryGroup, exchange, record_collectives
    from . import trace_audit as ta

    errors: list[str] = []
    plan, _ = ta.build_plan(2, "causal")
    want = ta.expected_plan_cast_collectives(plan)
    with record_collectives("dry") as records:
        ta.plan_cast_records(plan, 0)
        exchange(torch.zeros(4), 1, 1, DryGroup(0, 2))  # the planted extra hop
    got = ta.collective_census(records)
    if got == want:
        errors.append(f"self-test: planted extra exchange left the census at {got}")
    up = ta.upcast_census(lambda: torch.zeros(4, dtype=torch.bfloat16).float() * 2)
    if up.get("_to_copy", 0) != 1:
        errors.append(f"self-test: planted upcast census {up} missed the bf16->f32 copy")
    if ta.guard_census(lambda: torch.isfinite(torch.zeros(4))) != 1:
        errors.append("self-test: planted isfinite missed by the guard census")
    from ..ops import flex_attn as fa

    call = ta.count_traces(lambda: fa.flex_flash_attn_func(
        *(torch.zeros((128, 1, 64)) for _ in range(3)), [(0, 128)], [(0, 128)], [1]))
    fa._cached_meta.cache_clear()  # a cold cache: the first call must build its meta
    call()
    call()
    if call.traces != 1:
        errors.append(f"self-test: the rebuild counter gave {call.traces} builds for a cold "
                      "call and a warm one, not 1")
    return errors


def self_test_plan() -> list[str]:
    from .plan_sanity import PlanValidationError, validate_slices

    try:
        validate_slices([(0, 128, 0, 64, 1)], 64, 64)
    except PlanValidationError:
        return []
    return ["self-test: planted OOB slice PASSED the sanitizer"]


def self_test_spmd() -> list[str]:
    from .spmd_audit import self_test

    return self_test()


def self_test_lifecycle() -> list[str]:
    from .lifecycle import run_mutation_self_test

    return run_mutation_self_test()


SELF_TESTS = {"lint": self_test_lint, "trace": self_test_trace, "plan": self_test_plan,
              "spmd": self_test_spmd, "lifecycle": self_test_lifecycle}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m magiattention_tpu_torch.analysis",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--self-test", action="store_true",
                        help="also prove each selected pass can fail on a planted violation")
    parser.add_argument("--update", action="store_true",
                        help="re-record the bf16->f32 upcast census expectations")
    parser.add_argument("--only", action="append", choices=PASSES, default=None,
                        help="run only the named pass(es); repeatable")
    args = parser.parse_args(argv)
    selected = tuple(args.only) if args.only else PASSES
    if args.update and "trace" not in selected:
        parser.error("--update re-records the trace pass's census, but the trace pass is not "
                     "selected")
    runs = {"lint": run_lint, "trace": lambda: run_trace_audit(args.update),
            "plan": run_plan_sanity, "spmd": run_spmd_audit, "lifecycle": run_lifecycle}
    failures: list[str] = []
    t0 = time.perf_counter()
    for i, name in enumerate(PASSES, 1):
        if name not in selected:
            continue
        t = time.perf_counter()
        errors = runs[name]()
        if args.self_test:
            errors += SELF_TESTS[name]()
        failures += errors
        print(f"[pass {i}] {name}: {len(errors)} finding(s) ({time.perf_counter() - t:.1f}s)")
    for e in failures:
        print(f"  !! {e}")
    print(f"analysis: {'FAILED' if failures else 'clean'} ({len(failures)} finding(s), "
          f"{time.perf_counter() - t0:.1f}s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
