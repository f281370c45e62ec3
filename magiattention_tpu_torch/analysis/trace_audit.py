"""Collective census, op census and rebuild guard of the port's runtime.

The JAX package's ``analysis/trace_audit.py`` reads jaxprs. A PyTorch
program has no trace to read, so each of its checks takes its torch
meaning here:

- **collective census** — the comm layer's recorder
  (``comm.group_collective.record_collectives``) in place of a jaxpr: every
  ``all_to_all_rows`` / ``exchange`` / ``all_gather_v`` / gradient
  all-reduce appends a record named as JAX's census names the primitive
  (``all_to_all``, ``ppermute``, ``all_gather``, ``psum``). Recorded
  ``dry`` over a ``DryGroup`` for every rank, one process audits what every
  rank of a plan would issue, and the counts must equal the comm meta's
  expectation (:func:`expected_cast_collectives` and its siblings, the JAX
  package's host arithmetic, ported as they are): zero collectives for
  fully local plans and cp = 1, one ``all_to_all`` per a2a cast, one
  ``ppermute`` per active wire hop, twice that for a forward and backward;
- **op census** — a ``TorchFunctionMode`` and a ``TorchDispatchMode`` over a
  call (:func:`op_census`): the guard census counts ``torch.isfinite``
  calls (the guards' marker; ``isfinite`` is composite in torch and never
  reaches the dispatcher as itself, so it is counted where it is called),
  the upcast census counts dispatched aten ops that take a bfloat16 tensor
  and give a float32 one. The hand-written kernels are ctypes calls and
  never dispatch, so every kernel entry and its plain version count as one
  opaque call each: the CPU census and the card census are one table,
  checked in as ``trace_audit_expectations.json`` beside this module;
- **rebuild guard** — a second call at the same shapes with new values
  must build no new plan meta, table or kernel library
  (:func:`count_traces` over :func:`build_counts`): the torch meaning of a
  retrace.

Everything here runs on the CPU as well as on the card.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable

import numpy as np

MATRIX_CPS = (1, 2, 4)
EXPECTATIONS = os.path.join(os.path.dirname(__file__), "trace_audit_expectations.json")


class AuditFailure(AssertionError):
    """A recorded program violated a statically-checkable invariant."""


def _fmt(c: dict) -> str:
    return json.dumps(c, sort_keys=True)


# ---------------------------------------------------------------------------
# collective census
# ---------------------------------------------------------------------------


def collective_census(records) -> dict[str, int]:
    """Counts by op of a recorder's records (``record_collectives``)."""
    counts: dict[str, int] = {}
    for r in records:
        counts[r.op] = counts.get(r.op, 0) + 1
    return counts


def _active_wire_hops(comm) -> int:
    return sum(1 for h in comm.hops if h.shift % comm.cp_size != 0)


def expected_cast_collectives(comm) -> dict[str, int]:
    """Collectives ONE group cast of this meta must issue: the hops impl
    ships one ``ppermute`` per active wire hop (zero-volume plans and
    cp=1 resolve to zero hops -> no collective at all); the a2a impl
    always ships its single globally-padded ``all_to_all``."""
    if comm.cp_size == 1:
        return {}
    if comm.impl == "hops":
        n = _active_wire_hops(comm)
        return {"ppermute": n} if n else {}
    return {"all_to_all": 1}


def expected_reduce_collectives(comm, kind: str) -> dict[str, int]:
    """Collectives one explicit group reduce must issue. The a2a impl
    reverses with one ``all_to_all`` (lse reduces ship the lse payload
    in a second one); the hops impl reverses each active hop (lse: out
    and lse payloads reverse separately)."""
    assert kind in ("sum", "lse"), kind
    if comm.cp_size == 1:
        return {}
    factor = 2 if kind == "lse" else 1
    if comm.impl == "hops":
        n = _active_wire_hops(comm) * factor
        return {"ppermute": n} if n else {}
    return {"all_to_all": factor}


def expected_plan_cast_collectives(plan) -> dict[str, int]:
    """Sum of :func:`expected_cast_collectives` over the plan's comm
    metas — what one forward ``calc_attn`` must issue (a forward and
    backward issue exactly twice this: each cast plus its transpose)."""
    metas = (
        [plan.merged_comm]
        if plan.overlap_degree == 0
        else [sp.comm for sp in plan.stages]
    )
    total: dict[str, int] = {}
    for m in metas:
        for k, v in expected_cast_collectives(m).items():
            total[k] = total.get(k, 0) + v
    return total


def _scale_counts(counts: dict[str, int], factor: int) -> dict[str, int]:
    return {k: v * factor for k, v in counts.items()}


def _dry_casts(metas, rank: int, cp: int, t: int, tail, dtype, device: str,
               backward: bool) -> list:
    import torch

    from ..comm.group_collective import DryGroup, group_cast_m, rank_routing, record_collectives

    group = DryGroup(rank, cp)
    with record_collectives("dry") as records:
        outs = []
        for meta in metas:
            x = torch.zeros((t,) + tuple(tail), dtype=dtype, device=device,
                            requires_grad=backward)
            outs.append(group_cast_m(x, rank_routing(meta, rank, t, device), group))
        if backward and outs:
            torch.autograd.backward(outs, [torch.zeros_like(o) for o in outs])
    return records


def plan_cast_records(plan, rank: int, *, tail=(1,), dtype=None, device: str = "cpu",
                      backward: bool = False) -> list:
    """``rank``'s records of the plan's casts, recorded dry: each cast (the
    merged one at degree 0, else one per stage, in call order) of a zero
    payload ``[shard_k_len, *tail]``; with ``backward`` each cast's
    transpose too, in the order autograd runs them. ``tail`` / ``dtype``
    / ``device`` give the live payload's, for a comparison with a live
    run's records."""
    import torch

    return _dry_casts(plan.comms(), rank, plan.cp_size, max(plan.shard_k_len, 1), tail,
                      torch.float32 if dtype is None else dtype, device, backward)


def audit_plan_collectives(plan) -> list[str]:
    """Build-time census (``MAGI_ATTENTION_VALIDATE=trace``): each of the
    plan's casts recorded dry for every rank, and each rank's census held
    against :func:`expected_cast_collectives`. Returns error strings.
    Hierarchical plans return ``[]``, as in the JAX package: their per-level
    census is ``spmd_audit.audit_hier_matrix``'s."""
    import torch

    if plan.hier is not None:
        return []
    errors: list[str] = []
    t = max(plan.shard_k_len, 1)
    for i, meta in enumerate(plan.comms()):
        want = expected_cast_collectives(meta)
        for rank in range(plan.cp_size):
            got = collective_census(_dry_casts([meta], rank, plan.cp_size, t, (1,),
                                               torch.float32, "cpu", False))
            if got != want:
                errors.append(
                    f"plan comm meta {i} ({meta.impl}) rank {rank}: recorded census "
                    f"{_fmt(got)} != CommMeta expectation {_fmt(want)}"
                )
    return errors


# ---------------------------------------------------------------------------
# op census (guard sentinels, bf16 -> f32 upcasts)
# ---------------------------------------------------------------------------

# the kernel entries (and the plain versions in their place on the CPU):
# ctypes calls and their stand-ins, each counted as one opaque call
KERNEL_ENTRIES = {
    "ops.flex_attn": (
        "_fwd_torch", "_fwd_torch_online", "_fwd_torch_sparse", "_dq_torch", "_dkv_torch",
        "_fwd_kernel", "_fwd_hb_kernel", "_fwd_sparse_kernel", "_fwd_sparse_hb_kernel",
        "_dq_kernel", "_dkv_kernel", "_dq_sparse_kernel", "_dkv_sparse_kernel",
    ),
    "serving.decode_attn": ("_split_partial_torch", "_decode_partials_kernel"),
}


class OpCensus:
    """What :func:`op_census` counted: ``guard`` (``torch.isfinite`` calls),
    ``upcasts`` (aten op -> count of bf16-in, f32-out dispatches) and
    ``kernels`` (kernel entry -> opaque calls)."""

    def __init__(self):
        self.guard = 0
        self.upcasts: dict[str, int] = {}
        self.kernels: dict[str, int] = {}
        self.paused = 0


@contextlib.contextmanager
def op_census():
    """Count the torch ops of the block (see :class:`OpCensus`); the kernel
    entries of :data:`KERNEL_ENTRIES` run as opaque calls. Restores every
    entry on exit."""
    import importlib

    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    census = OpCensus()
    isfinite = {torch.isfinite, torch.Tensor.isfinite}

    class _Guards(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in isfinite and not census.paused:
                census.guard += 1
            return func(*args, **(kwargs or {}))

    class _Upcasts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not census.paused:
                ins = tree_leaves((args, kwargs or {}))
                if any(isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 for t in ins) \
                        and any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                                for t in tree_leaves(out)):
                    name = func.overloadpacket.__name__
                    census.upcasts[name] = census.upcasts.get(name, 0) + 1
            return out

    def opaque(name, fn):
        def run(*args, **kwargs):
            census.kernels[name] = census.kernels.get(name, 0) + 1
            census.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                census.paused -= 1

        return run

    saved = []
    for mod_name, names in KERNEL_ENTRIES.items():
        mod = importlib.import_module(f"..{mod_name}", __package__)
        for n in names:
            saved.append((mod, n, getattr(mod, n)))
    try:
        for mod, n, fn in saved:
            setattr(mod, n, opaque(n, fn))
        with _Guards(), _Upcasts():
            yield census
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def guard_census(fn: Callable, *args, **kwargs) -> int:
    """``torch.isfinite`` calls of ``fn(*args, **kwargs)``, the kernels
    opaque: the guards (``resilience/guards.py``) funnel every detection
    through it, so ``MAGI_ATTENTION_GUARD=off`` must count zero."""
    with op_census() as c:
        fn(*args, **kwargs)
    return c.guard


def upcast_census(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """Per aten op, the bf16 -> f32 boundary dispatches of
    ``fn(*args, **kwargs)``, the kernels opaque: a new silent promotion
    shows up as census drift."""
    with op_census() as c:
        fn(*args, **kwargs)
    return c.upcasts


# ---------------------------------------------------------------------------
# rebuild guard (the torch meaning of a retrace)
# ---------------------------------------------------------------------------


def build_counts() -> tuple:
    """Everything a call can build once and reuse: the flex plan metas
    (``ops/flex_attn.py::_cached_meta`` misses), their device tables
    (``fwd_tables`` / ``bwd_tables`` misses), the autotuner's memo entries
    and the kernel libraries built (the compile tracker's total)."""
    from ..ops import flex_attn as fa
    from ..telemetry.compile import get_compile_tracker
    from ..tuning import autotuner

    return (fa._cached_meta.cache_info().misses, fa.fwd_tables.cache_info().misses,
            fa.bwd_tables.cache_info().misses, len(autotuner._MEMO),
            get_compile_tracker().total()[0])


def count_traces(fn: Callable):
    """Wrap ``fn`` so each call that builds something new
    (:func:`build_counts` moves) bumps ``wrapper.traces``: call it with
    same-shape, different-value operands to prove values are not baked
    into what is built."""

    def wrapper(*args, **kwargs):
        before = build_counts()
        out = fn(*args, **kwargs)
        if build_counts() != before:
            wrapper.traces += 1
        return out

    wrapper.traces = 0
    return wrapper


def audit_retrace(*, total: int = 512, device: str = "cpu") -> list[str]:
    """A second flex call at the same shapes with new values must build
    nothing: its plan meta, tables, tuning decision and kernels all come
    from the first call's."""
    import torch

    from ..ops.flex_attn import flex_flash_attn_func

    gen = torch.Generator(device=device).manual_seed(0)

    def call(_seed):
        q, k, v = (torch.randn((total, 2, 64), generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        return flex_flash_attn_func(q, k, v, [(0, total)], [(0, total)], [1])

    body = count_traces(call)
    body(0)  # may build: a cold cache
    first = body.traces
    body(1)
    if body.traces != first:
        return [
            "retrace guard: a same-shape call with new values built a new plan, table, "
            f"tuning decision or kernel library ({first} -> {body.traces} builds)"
        ]
    return []


def audit_decode_retrace(*, device: str = "cpu") -> list[str]:
    """The serving decode under the same discipline: re-running
    ``decode_attn_paged`` with value-mutated same-shape block tables and
    lengths (one allocator tick's churn) must build nothing."""
    import torch

    from ..serving.decode_attn import decode_attn_paged
    from ..serving.kv_cache import assign_block_table, make_paged_kv_cache

    cache = make_paged_kv_cache(8, 8, 2, 32, max_seqs=2, max_pages_per_seq=4,
                                dtype=torch.bfloat16, device=device)
    assign_block_table(cache, 0, [1, 2], keep_len=13)
    assign_block_table(cache, 1, [3], keep_len=5)
    q = torch.zeros((2, 2, 32), dtype=torch.bfloat16, device=device)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=device)
    body = count_traces(lambda: decode_attn_paged(q, cache, slots, num_splits=2))
    body()
    first = body.traces
    assign_block_table(cache, 0, [2, 1], keep_len=12)
    assign_block_table(cache, 1, [4], keep_len=6)
    body()
    if body.traces != first:
        return [
            "decode retrace guard: value-mutated (same-shape) block tables built something "
            f"new in decode_attn_paged ({first} -> {body.traces} builds)"
        ]
    return []


# ---------------------------------------------------------------------------
# matrix audits (the CLI's trace pass)
# ---------------------------------------------------------------------------


class _pinned_env:
    """Temporarily pin one env var (None value = leave untouched)."""

    def __init__(self, name: str, value: str | None):
        self.name = name
        self.value = value

    def __enter__(self):
        # save/restore pin, not a config read
        self.prev = os.environ.get(self.name)  # magi-allow: MAGI002
        if self.value is not None:
            os.environ[self.name] = self.value  # magi-allow: MAGI002
        return self

    def __exit__(self, *exc):
        if self.value is not None:
            if self.prev is None:
                os.environ.pop(self.name, None)  # magi-allow: MAGI002
            else:
                os.environ[self.name] = self.prev  # magi-allow: MAGI002
        return False


class _pinned_impl(_pinned_env):
    """Temporarily pin MAGI_ATTENTION_GROUP_COLL_IMPL (None = leave)."""

    def __init__(self, impl: str | None):
        super().__init__("MAGI_ATTENTION_GROUP_COLL_IMPL", impl)


def _workload(kind: str, total: int, chunk: int):
    """(q_ranges, k_ranges, types): 'causal' = one dense causal slice
    (cross-rank comm), 'local' = chunk-diagonal FULL blocks (after
    dispatch every rank's K needs are its own rows -> zero comm)."""
    if kind == "causal":
        return [(0, total)], [(0, total)], [1]
    n = total // chunk
    blocks = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    return blocks, list(blocks), [0] * n


def build_plan(cp: int, kind: str, *, total: int = 512, chunk: int = 64, degree: int = 0,
               impl: str | None = None, cp_mesh_shape=None):
    """The cp plan of a :func:`_workload` mask, built on the host as the
    keyed API builds it (64 x 64 tile): ``(plan, bucket area)``."""
    from ..common.enum import AttnMaskType
    from ..common.ranges import AttnRanges
    from ..meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from ..meta.solver.overlap_solver import OverlapConfig
    from ..parallel.dist_attn import build_dist_attn_plan

    qr, kr, ts = _workload(kind, total, chunk)
    with _pinned_impl(impl):
        mq, _, bucket = make_dispatch_meta_from_qk_ranges(
            AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr),
            [AttnMaskType(t) for t in ts], total, total, chunk_size=chunk, cp_size=cp)
        plan = build_dist_attn_plan(mq, bucket, overlap_config=OverlapConfig(
            degree=degree, min_stage_rows=64), cp_mesh_shape=cp_mesh_shape)
    return plan, bucket.area


def dry_dist_attn(plan, rank: int, *, heads=(2, 2), head_dim: int = 64, grad: bool = True,
                  dtype=None, device: str = "cpu"):
    """``parallel.dist_attn.dist_attn_local`` for ``rank`` of ``plan`` on
    zero shards, recorded dry (no wire): ``(records, out, lse)``, the
    backward of ``out.sum()`` included with ``grad``."""
    import torch

    from ..comm.group_collective import DryGroup, record_collectives
    from ..parallel.dist_attn import dist_attn_local, make_attn_params

    dtype = torch.bfloat16 if dtype is None else dtype
    hq, hk = heads
    params = make_attn_params(plan, head_dim, out_dtype=dtype)
    q = torch.zeros((plan.shard_q_len, hq, head_dim), dtype=dtype, device=device,
                    requires_grad=grad)
    k, v = (torch.zeros((plan.shard_k_len, hk, head_dim), dtype=dtype, device=device,
                        requires_grad=grad) for _ in range(2))
    with record_collectives("dry") as records:
        out, lse = dist_attn_local(q, k, v, plan, params, DryGroup(rank, plan.cp_size))[:2]
        if grad:
            out.float().sum().backward()
    return records, out.detach(), lse.detach()


def audit_flex_matrix(*, total: int = 512, chunk: int = 64) -> tuple[list[str], dict]:
    """Collective census of the cp runtime's forward and backward, every
    rank recorded dry, over plans x cp x impls: local plans and cp=1 issue
    ZERO collectives; hops plans exactly their active-hop ppermutes and
    never an all_to_all; a2a plans exactly their per-stage all_to_alls; a
    forward and backward twice the forward."""
    errors: list[str] = []
    report: dict = {}
    cases = []
    for cp in MATRIX_CPS:
        cases.append((cp, "local", None, 0))
        cases.append((cp, "causal", None, 0))
    cases += [(4, "causal", "hops", 0), (4, "causal", "a2a", 0), (4, "causal", "hops", 2)]
    for cp, kind, impl, degree in cases:
        label = f"flex cp={cp} {kind}" + (f" impl={impl}" if impl else "") + (
            f" degree={degree}" if degree else "")
        plan, _ = build_plan(cp, kind, total=total, chunk=chunk, degree=degree, impl=impl)
        expect = expected_plan_cast_collectives(plan)
        for rank in range(cp):
            fwd = collective_census(dry_dist_attn(plan, rank, grad=False)[0])
            both = collective_census(dry_dist_attn(plan, rank)[0])
            report[f"{label} rank={rank}"] = {"fwd": fwd, "fwd_bwd": both,
                                              "expected_fwd": expect}
            if kind == "local" or cp == 1:
                if fwd or both:
                    errors.append(f"{label} rank {rank}: local/cp=1 plan must issue ZERO "
                                  f"collectives; got fwd={_fmt(fwd)} fwd_bwd={_fmt(both)}")
                continue
            if fwd != expect:
                errors.append(f"{label} rank {rank}: fwd census {_fmt(fwd)} != CommMeta "
                              f"expectation {_fmt(expect)}")
            if both != _scale_counts(expect, 2):
                errors.append(f"{label} rank {rank}: fwd+bwd census {_fmt(both)} != 2x cast "
                              f"expectation {_fmt(expect)}")
            if impl == "hops" and "all_to_all" in both:
                errors.append(f"{label} rank {rank}: hops impl still issues an all_to_all")
    return errors, report


def audit_group_collectives(*, cp: int = 4) -> tuple[list[str], dict]:
    """Group cast / reduce_sum / reduce_lse for both impls on a skewed
    synthetic send map, every rank recorded dry: each census equals the
    meta's expectation."""
    import torch

    from ..comm.group_collective import (
        DryGroup,
        GroupCollectiveMeta,
        group_cast,
        group_reduce_lse,
        group_reduce_sum,
        rank_routing,
        record_collectives,
    )

    errors: list[str] = []
    report: dict = {}
    rng = np.random.default_rng(0)
    t = 32
    send_map = [
        [
            rng.choice(t, size=int(rng.integers(0, 12)), replace=False)
            if s != d
            else np.empty(0, np.int64)
            for d in range(cp)
        ]
        for s in range(cp)
    ]
    for impl in ("a2a", "hops"):
        meta = GroupCollectiveMeta.build(send_map, [t] * cp, impl=impl)
        r_rows = meta.max_recv
        for rank in range(cp):
            rt, g = rank_routing(meta, rank, t, "cpu"), DryGroup(rank, cp)
            runs = {
                "cast": (lambda: group_cast(torch.zeros((t, 4)), rt, g),
                         expected_cast_collectives(meta)),
                "reduce_sum": (lambda: group_reduce_sum(torch.zeros((r_rows, 4)), rt, g),
                               expected_reduce_collectives(meta, "sum")),
                "reduce_lse": (lambda: group_reduce_lse(
                    torch.zeros((r_rows, 2, 4)), torch.zeros((r_rows, 2)),
                    torch.zeros((t, 2, 4)), torch.zeros((t, 2)), rt, g),
                    expected_reduce_collectives(meta, "lse")),
            }
            for kind, (run, expect) in runs.items():
                with record_collectives("dry") as records:
                    run()
                got = collective_census(records)
                report[f"group_{kind}_{impl}_rank{rank}"] = {"census": got, "expected": expect}
                if got != expect:
                    errors.append(f"group {kind} [{impl}] rank {rank}: census {_fmt(got)} != "
                                  f"expected {_fmt(expect)}")
    return errors, report


def audit_decode() -> tuple[list[str], dict]:
    """``decode_attn_paged`` and the cascade decode must issue no
    collective at all and return (bf16 out, f32 lse)."""
    import torch

    from ..comm.group_collective import record_collectives
    from ..serving.decode_attn import decode_attn_paged
    from ..serving.kv_cache import assign_block_table, make_paged_kv_cache
    from ..serving.prefix import CascadeGroup, cascade_decode_attn

    errors: list[str] = []
    cache = make_paged_kv_cache(8, 8, 2, 32, max_seqs=4, max_pages_per_seq=8,
                                dtype=torch.bfloat16, device="cpu")
    for slot, pages, n in ((0, [1, 2, 3], 22), (1, [1, 2, 4], 20), (2, [5, 6], 11)):
        assign_block_table(cache, slot, pages, keep_len=n)
    q = torch.zeros((3, 4, 32), dtype=torch.bfloat16)
    slots = torch.tensor([0, 1, 2], dtype=torch.int32)
    groups = [CascadeGroup(shared_pages=(1, 2), prefix_len=16, members=(0, 1))]
    report: dict = {}
    for name, run in (
        ("decode", lambda: decode_attn_paged(q, cache, slots, num_splits=2)),
        ("cascade_decode", lambda: cascade_decode_attn(q, cache, [0, 1, 2], groups,
                                                       num_splits=2)),
    ):
        with record_collectives("dry") as records:
            out, lse = run()
        census = collective_census(records)
        report[name] = {"census": census}
        if census:
            errors.append(f"{name} issued collectives {_fmt(census)}: the single-card "
                          "decode must be collective-free")
        if out.dtype != torch.bfloat16:
            errors.append(f"{name} out dtype {out.dtype} != bfloat16")
        if lse.dtype != torch.float32:
            errors.append(f"{name} lse dtype {lse.dtype} != float32")
    return errors, report


def audit_guard_ops(*, total: int = 512, chunk: int = 64) -> tuple[list[str], dict]:
    """Guard census over the cp runtime (rank 0 of a cp=2 causal plan,
    recorded dry): ``MAGI_ATTENTION_GUARD=off`` must count ZERO guard ops in
    the forward AND the backward; ``check`` at least one per guarded merge
    site, with the outputs' dtypes and shapes unchanged."""
    errors: list[str] = []
    plan, _ = build_plan(2, "causal", total=total, chunk=chunk)
    with _pinned_env("MAGI_ATTENTION_GUARD", "off"):
        with op_census() as c:
            _, out_off, lse_off = dry_dist_attn(plan, 0)
        n_off = c.guard
    with _pinned_env("MAGI_ATTENTION_GUARD", "check"):
        with op_census() as c:
            _, out_chk, lse_chk = dry_dist_attn(plan, 0, grad=False)
        n_chk = c.guard
    report = {"guard_census": {"off": n_off, "check_fwd": n_chk}}
    if n_off:
        errors.append(f"GUARD=off counted {n_off} guard op(s) (isfinite): the off path must "
                      "be provably free")
    if n_chk == 0:
        errors.append("GUARD=check counted zero guard ops: detection is not in the program")
    if [(t.dtype, tuple(t.shape)) for t in (out_off, lse_off)] != \
            [(t.dtype, tuple(t.shape)) for t in (out_chk, lse_chk)]:
        errors.append("GUARD=check changed the entry's output dtypes or shapes")
    return errors, report


def upcast_cases(*, total: int = 512, chunk: int = 64, device: str = "cpu") -> dict:
    """The recorded upcast censuses (name -> {aten op: count}) and output
    dtypes: the cp runtime's forward and forward + backward (rank 0 of a
    cp=2 causal plan, dry), and the single-card flex forward and backward,
    all bf16. The same table on the CPU and on the card."""
    import torch

    from ..ops.flex_attn import flex_flash_attn_func

    plan, _ = build_plan(2, "causal", total=total, chunk=chunk)
    out: dict = {}
    dtypes: dict = {}
    for grad, name in ((False, "dist_attn_fwd_bf16_cp2_causal"),
                       (True, "dist_attn_grad_bf16_cp2_causal")):
        with op_census() as c:
            _, o, lse = dry_dist_attn(plan, 0, grad=grad, device=device)
        out[name], dtypes[name] = c.upcasts, (o.dtype, lse.dtype)
    q, k, v = (torch.zeros((total, 2, 64), dtype=torch.bfloat16, device=device,
                           requires_grad=True) for _ in range(3))
    for grad, name in ((False, "flex_fwd_bf16_causal"), (True, "flex_grad_bf16_causal")):
        with op_census() as c:
            o, lse = flex_flash_attn_func(q, k, v, [(0, total)], [(0, total)], [1],
                                          block_q=64, block_k=64, grid="row_major")
            if grad:
                o.float().sum().backward()
        out[name], dtypes[name] = c.upcasts, (o.dtype, lse.dtype)
    return {"upcasts": out, "dtypes": dtypes}


def load_expectations(path: str = EXPECTATIONS) -> dict:
    with open(path) as f:
        return json.load(f)


def audit_dtypes(expectations: dict | None, *, device: str = "cpu") -> tuple[list[str], dict]:
    """bf16-path dtype audit: out is bf16, lse is f32, and each recorded
    upcast census equals the checked-in one (drift = a new silent
    promotion, or an intentional change that needs ``--update``)."""
    import torch

    errors: list[str] = []
    cases = upcast_cases(device=device)
    for name, (o, lse) in cases["dtypes"].items():
        if o != torch.bfloat16:
            errors.append(f"{name}: bf16 path out dtype is {o}, not bfloat16")
        if lse != torch.float32:
            errors.append(f"{name}: lse dtype is {lse}, not the documented float32")
    if expectations is not None:
        for name, census in cases["upcasts"].items():
            want = expectations.get(name)
            if want is None:
                errors.append(f"no upcast expectation recorded for {name}: run "
                              "python -m magiattention_tpu_torch.analysis --update")
            elif {k: int(v) for k, v in want.items()} != census:
                errors.append(f"{name}: upcast census {_fmt(census)} drifted from recorded "
                              f"{_fmt(want)}: a new bf16->f32 promotion appeared (fix it, or "
                              "--update after an intentional change)")
    return errors, cases["upcasts"]


def write_expectations(upcasts: dict, path: str = EXPECTATIONS) -> None:
    payload = {
        "_comment": ("bf16->f32 upcast census per audited entry (aten ops dispatched with a "
                     "bfloat16 tensor in and a float32 tensor out, the kernel entries opaque), "
                     "recorded by python -m magiattention_tpu_torch.analysis --update. Drift = "
                     "a new silent upcast on the bf16 path."),
    }
    payload.update({k: dict(sorted(v.items())) for k, v in upcasts.items()})
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def audit_hier_cast_levels() -> tuple[list[str], dict]:
    """Per-level census of the two-level hierarchical cast: the inter level
    is exactly one ``all_to_all``; the intra level one ``all_to_all`` (a2a
    impl) or exactly the meta's active intra hops as ``ppermute`` s (hops
    impl). The cross-rank uniformity of the same calls is the SPMD pass's
    job; this pins the level structure with one rank per case."""
    from .spmd_audit import audit_hier_matrix

    return audit_hier_matrix(meshes=((2, 2),), per_rank=False)
