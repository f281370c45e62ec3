"""Measured stage timelines: run a cp plan piece by piece and time each piece.

The port's copy of the JAX package's ``telemetry/timeline.py``. The overlap
solver picks the degree from a predicted pipelined timeline
(``simulate_overlap_timeline``); this module measures what the card did:

1. split a :class:`~..parallel.dist_attn.DistAttnPlan` into its pieces, the
   port's own: the host stage's kernel, each stage's cast (and, for a
   hop-scheduled or hierarchical cast, each hop or level alone) and each
   stage's kernel with its LSE merge (at degree 0: the one cast and the
   one kernel), each as ``dist_attn_local`` runs it, over the plan's
   ``torch.distributed`` group on the rank's device;
2. time each piece and the whole ``dist_attn_local``: each rep is fenced by
   ``torch.distributed.barrier()`` and timed with CUDA events (the host
   clock on the CPU), ``MAGI_ATTENTION_TIMELINE_INNER`` calls a rep,
   ``MAGI_ATTENTION_TIMELINE_REPS`` reps, the median kept, and the
   slowest rank's median taken, so that every rank holds the same numbers;
3. fold them into a :class:`MeasuredTimeline`: each stage's cast and kernel
   ms, the serial sum against the pipelined whole, the overlap efficiency,
   and the delta against the prediction priced with the same
   ``simulate_overlap_timeline`` at the card's datasheet rates
   (``utils/cost.py``).

Every rank of the plan's group calls :func:`profile_plan_timeline` (or
:func:`profile_key_timeline`) together. The pieces run with no sink (it
joins the softmax once, in the host stage, and moves no time). A piece's
own barrier and launch are in its time, so the serial sum over-counts a
little. ``overlap_efficiency`` divides by the hideable cast time only.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class StageTiming:
    """One piece's measured (and predicted) cost. ``stage`` is ``"host"``,
    ``"merged"`` or the remote stage's index as a string; ``comm_ms`` is 0
    for the host stage (no cast)."""

    stage: str
    comm_ms: float
    calc_ms: float
    predicted_comm_ms: float | None = None
    predicted_calc_ms: float | None = None


@dataclasses.dataclass(frozen=True)
class HopTiming:
    """One hop of a hop-scheduled cast (``hop``: its shift as a string), or
    one level of a hierarchical cast (``"inter"`` / ``"intra"``, or the
    intra level's hops), timed alone. ``axis``: the group it rides
    (``"cp"`` for a flat plan, ``"inter"`` / ``"intra"``)."""

    stage: str  # "merged" or the remote stage's index as a string
    axis: str
    hop: str
    rows: int  # padded payload rows per rank the hop ships
    ms: float


@dataclasses.dataclass(frozen=True)
class MeasuredTimeline:
    """One profiled plan: each piece, and the pipelined / serial /
    predicted totals."""

    overlap_degree: int
    cp_size: int
    stages: tuple[StageTiming, ...]
    measured_total_ms: float  # the whole dist_attn_local
    serial_total_ms: float  # the pieces' sum
    hideable_comm_ms: float  # the stages' cast time overlap could hide
    overlap_efficiency: float  # hidden / hideable, in [0, 1]
    predicted_total_ms: float | None  # simulate_overlap_timeline
    prediction_error_ratio: float | None  # measured_total / predicted
    hops: tuple[HopTiming, ...] = ()

    def report(self) -> str:
        """The predicted-against-measured table: a line a stage, then the
        totals."""

        def fmt(v, suffix=""):
            return "-" if v is None else f"{v:.3f}{suffix}"

        lines = [
            f"measured stage timeline: overlap_degree={self.overlap_degree} cp={self.cp_size}",
            f"  {'stage':<8} {'comm ms (pred)':<20} {'calc ms (pred)':<20}",
        ]
        for st in self.stages:
            comm = f"{st.comm_ms:.3f} ({fmt(st.predicted_comm_ms)})"
            calc = f"{st.calc_ms:.3f} ({fmt(st.predicted_calc_ms)})"
            lines.append(f"  {st.stage:<8} {comm:<20} {calc:<20}")
        lines.append(
            f"  end-to-end measured {self.measured_total_ms:.3f} ms | serial sum "
            f"{self.serial_total_ms:.3f} ms | predicted {fmt(self.predicted_total_ms, ' ms')}")
        # clamped as overlap_efficiency is: the serial sum over-counts each
        # piece's own barrier and launch
        hidden = min(max(self.serial_total_ms - self.measured_total_ms, 0.0),
                     self.hideable_comm_ms)
        lines.append(f"  overlap efficiency {self.overlap_efficiency:.1%}: {hidden:.3f} ms of "
                     f"{self.hideable_comm_ms:.3f} ms hideable comm hidden")
        if self.prediction_error_ratio is not None:
            lines.append("  solver model delta: measured/predicted = "
                         f"{self.prediction_error_ratio:.2f}x "
                         "(>1: hardware slower than the model priced)")
        if self.hops:
            lines.append("  per-hop cast attribution:")
            by_stage: dict[str, float] = {}
            for h in self.hops:
                lines.append(f"    stage {h.stage:<7} axis={h.axis} hop {h.hop}: {h.ms:.3f} ms "
                             f"({h.rows} rows/rank)")
                by_stage[h.stage] = by_stage.get(h.stage, 0.0) + h.ms
            cast_by_stage = {st.stage: st.comm_ms for st in self.stages if st.comm_ms}
            for stage, total in by_stage.items():
                cast = cast_by_stage.get(stage)
                if cast:
                    lines.append(f"    stage {stage:<7} hop sum {total:.3f} ms vs whole cast "
                                 f"{cast:.3f} ms (each hop alone re-pays its barrier)")
        return "\n".join(lines)


def _predicted_costs(
    plan,
    *,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int,
    bytes_per_elt: int,
    card: str | None,
    calc_cost_factor: float | None = None,
    comm_cost_factor: float | None = None,
    stage_overhead_s: float = 30e-6,
):
    """(host_calc_s, [stage_comm_s], [stage_calc_s], predicted_total_s),
    priced as the auto-degree search prices (comm at the rows the selected
    impl schedules); the factors default to ``card``'s datasheet rates.
    None when they cannot be resolved (no card, or an unknown one)."""
    from ..meta.solver.overlap_solver import simulate_overlap_timeline

    if calc_cost_factor is None or comm_cost_factor is None:
        from ..utils.cost import get_calc_cost_factor, get_comm_cost_factor

        if card is None:
            return None
        try:
            calc_cost_factor = get_calc_cost_factor(num_heads_q, head_dim, card)
            comm_cost_factor = get_comm_cost_factor(num_heads_kv, head_dim, card,
                                                    bytes_per_elt=bytes_per_elt)
        except ValueError:
            return None
    if plan.overlap_degree == 0:
        comm_s = [plan.merged_comm.scheduled_rows_per_rank * comm_cost_factor]
        calc_s = [plan.max_rank_area * calc_cost_factor]
        total = simulate_overlap_timeline(0.0, comm_s, calc_s, 0.0)
        return 0.0, comm_s, calc_s, total
    host_s = plan.host_max_rank_area * calc_cost_factor
    comm_s = [sp.comm.scheduled_rows_per_rank * comm_cost_factor for sp in plan.stages]
    calc_s = [sp.max_rank_area * calc_cost_factor for sp in plan.stages]
    total = simulate_overlap_timeline(host_s, comm_s, calc_s, stage_overhead_s)
    return host_s, comm_s, calc_s, total


def profile_plan_timeline(
    plan,
    params,
    group,
    *,
    q=None,
    k=None,
    v=None,
    num_heads: tuple[int, int] | None = None,
    head_dim: int | None = None,
    dtype=None,
    device=None,
    reps: int | None = None,
    inner: int | None = None,
    warmup: int = 1,
    seed: int = 0,
    card: str | None = None,
    calc_cost_factor: float | None = None,
    comm_cost_factor: float | None = None,
    stage_overhead_s: float = 30e-6,
    timer=None,
    record: bool = True,
) -> MeasuredTimeline:
    """Measure a plan's stage timeline; every rank of ``group`` (the flat cp
    group, or a hierarchical plan's ``HierCpGroups``) calls it together.

    ``q`` / ``k`` / ``v``: this rank's dispatched shards; omitted, random
    ones are made from ``seed`` and the rank, of ``num_heads`` = (hq, hkv),
    ``head_dim`` and ``dtype`` (default: ``params.out_dtype``), on
    ``device``: default the current CUDA device, raising without one; the
    plain versions on the host clock only with ``device="cpu"``. ``reps`` / ``inner`` default to
    ``MAGI_ATTENTION_TIMELINE_REPS`` / ``_INNER``. The prediction is priced
    on ``card`` (default: the card of a CUDA ``device``; none on the CPU)
    unless both cost factors are given. ``timer(fn) -> ms`` replaces the
    measurement of each piece (the pieces are still run once for their
    results): a fake clock for tests. With ``record`` (and telemetry on)
    the result is written as the ``magi_overlap_measured_*`` gauges.

    Self- and cross-attention plans, flat and hierarchical, merged and
    staged; a qo-comm plan has no stage split and is refused."""
    import torch
    import torch.distributed as dist

    from .. import env
    from ..comm.group_collective import group_cast
    from ..comm.hier import HierRouting
    from ..ops.correction import correct_attn_out_lse
    from ..ops.flex_attn import flex_attn_headmajor
    from ..parallel.dist_attn import (
        _cast,
        _cast_groups,
        _hm,
        _kv_buffer,
        _seq,
        dist_attn_local,
        rank_tables,
    )
    from .events import record_event
    from .roofline import device_ms

    if not hasattr(plan, "stages"):
        raise NotImplementedError(
            "profile_plan_timeline supports DistAttnPlan runtimes only (got "
            f"{type(plan).__name__}); qo-comm plans interleave comm and compute in one call "
            "and have no stage split to re-run")
    reps = env.timeline_reps() if reps is None else reps
    inner = env.timeline_inner() if inner is None else inner
    flat, cast_group = _cast_groups(plan, group)
    rank = dist.get_rank(flat)

    # ---- operands ----------------------------------------------------------
    if q is None:
        missing = [n for n, val in (("num_heads", num_heads), ("head_dim", head_dim))
                   if val is None]
        if missing:
            raise ValueError("profile_plan_timeline: synthesizing operands (q=None) needs "
                             f"num_heads=(hq, hkv) and head_dim; missing: {', '.join(missing)}")
        hq, hkv = num_heads
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("profile_plan_timeline: no CUDA device to make the operands "
                                   "on; pass device= (device=\"cpu\" times the plain versions "
                                   "on the host clock)")
            device = torch.device("cuda", torch.cuda.current_device())
        dev = torch.device(device)
        dt = params.out_dtype if dtype is None else dtype
        gen = torch.Generator(dev).manual_seed(seed * 1009 + rank)

        def rand(n, h):
            return torch.randn((n, h, head_dim), generator=gen, device=dev).to(dt)

        q, k, v = rand(plan.shard_q_len, hq), rand(plan.shard_k_len, hkv), \
            rand(plan.shard_k_len, hkv)
    hq, head_dim, hkv = int(q.shape[1]), int(q.shape[2]), int(k.shape[1])
    dev = q.device
    cuda = dev.type == "cuda"
    if card is None and cuda:
        card = torch.cuda.get_device_name(dev)
    tabs = rank_tables(plan, rank, str(dev))
    n = plan.shard_q_len
    calc_params = dataclasses.replace(params, has_sink=False)
    acc_dtype = torch.float32 if env.is_forward_high_precision_reduce() else params.out_dtype
    piece_params = dataclasses.replace(calc_params, out_dtype=acc_dtype)

    def t_ms(fn) -> float:
        if timer is not None:
            return float(timer(fn))
        return device_ms(fn, reps=reps, warmup=warmup, inner=inner, cuda=cuda, group=flat)

    # ---- per-hop attribution -------------------------------------------------
    hop_timings: list[HopTiming] = []

    def time_hops(rt, payload, stage_label):
        if isinstance(rt, HierRouting):
            levels = [("inter", "inter", rt.inter, cast_group.inter, payload)]
            gw = group_cast(payload, rt.inter, cast_group.inter)
            levels.append(("intra", "intra", rt.intra, cast_group.intra, gw))
        else:
            levels = [(None, "cp", rt, cast_group, payload)]
        pieces = []
        for label, axis, r, grp, x in levels:
            if r.impl == "hops":
                for h in r.hops:
                    one = dataclasses.replace(r, hops=(h,))
                    pieces.append((str(h.shift), axis, h.size,
                                   lambda one=one, grp=grp, x=x: group_cast(x, one, grp)))
            elif label is not None:
                pieces.append((label, axis, r.cp_size * r.max_send,
                               lambda r=r, grp=grp, x=x: group_cast(x, r, grp)))
        for hop_label, axis, rows, fn in pieces:
            t0 = time.perf_counter()
            ms = t_ms(fn)
            if record:  # record=False leaves the span ring alone
                record_event("hop_cast", t0, ms * 1e-3,
                             {"stage": stage_label, "hop": hop_label, "axis": axis,
                              "rows_per_rank": rows, "ms": ms},
                             track=f"hop {hop_label} ({axis})")
            hop_timings.append(HopTiming(stage=stage_label, axis=axis, hop=hop_label,
                                         rows=rows, ms=ms))

    predicted = _predicted_costs(
        plan, num_heads_q=hq, num_heads_kv=hkv, head_dim=head_dim,
        bytes_per_elt=k.element_size(), card=card, calc_cost_factor=calc_cost_factor,
        comm_cost_factor=comm_cost_factor, stage_overhead_s=stage_overhead_s)
    p_host_ms = p_comm_ms = p_calc_ms = predicted_total_ms = None
    if predicted is not None:
        host_s, comm_s, calc_s, total_s = predicted
        p_host_ms = host_s * 1e3
        p_comm_ms = [x * 1e3 for x in comm_s]
        p_calc_ms = [x * 1e3 for x in calc_s]
        predicted_total_ms = total_s * 1e3

    # each piece is its slice of dist_attn_local: the cast, or the K/V
    # buffer, the kernel, the head-major -> sequence layout and (a remote
    # stage) the lse merge, so that the serial sum prices the same work
    stages: list[StageTiming] = []
    with torch.no_grad():
        qh = _hm(q, plan.shard_q_pad)
        kv = torch.stack([k, v], dim=1)
        if plan.overlap_degree == 0:
            ftab, btab, kv_pad = tabs.kernel[0]
            rt = tabs.casts[0]

            def cast_fn():
                return _cast(kv, rt, cast_group)

            recv = cast_fn()

            def calc_fn():
                buf = _kv_buffer((kv, recv), kv_pad, k)
                return _seq(*flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab,
                                                 calc_params)[:2], n)

            comm_ms = t_ms(cast_fn)
            time_hops(rt, kv, "merged")
            calc_ms = t_ms(calc_fn)
            stages.append(StageTiming(
                stage="merged", comm_ms=comm_ms, calc_ms=calc_ms,
                predicted_comm_ms=p_comm_ms[0] if p_comm_ms else None,
                predicted_calc_ms=p_calc_ms[0] if p_calc_ms else None))
            serial_ms, hideable_ms = comm_ms + calc_ms, comm_ms
        else:
            ftab, btab, kv_pad = tabs.kernel[0]

            def host_fn():
                buf = _kv_buffer((kv,), kv_pad, k)
                return _seq(*flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab,
                                                 piece_params)[:2], n)

            acc_out, acc_lse = host_fn()
            host_ms = t_ms(host_fn)
            stages.append(StageTiming(stage="host", comm_ms=0.0, calc_ms=host_ms,
                                      predicted_comm_ms=None, predicted_calc_ms=p_host_ms))
            serial_ms, hideable_ms = host_ms, 0.0
            for i, ((ftab, btab, kv_pad), rt) in enumerate(zip(tabs.kernel[1:], tabs.casts)):

                def cast_fn(rt=rt):
                    return _cast(kv, rt, cast_group)

                recv = cast_fn()

                def calc_fn(recv=recv, ftab=ftab, btab=btab, kv_pad=kv_pad, acc_out=acc_out,
                            acc_lse=acc_lse):
                    buf = _kv_buffer((recv,), kv_pad, k)
                    out_i, lse_i = _seq(*flex_attn_headmajor(qh, buf[0], buf[1], ftab, btab,
                                                             piece_params)[:2], n)
                    return correct_attn_out_lse(acc_out, acc_lse, out_i, lse_i)

                comm_ms = t_ms(cast_fn)
                time_hops(rt, kv, str(i))
                calc_ms = t_ms(calc_fn)
                acc_out, acc_lse = calc_fn()
                stages.append(StageTiming(
                    stage=str(i), comm_ms=comm_ms, calc_ms=calc_ms,
                    predicted_comm_ms=p_comm_ms[i] if p_comm_ms else None,
                    predicted_calc_ms=p_calc_ms[i] if p_calc_ms else None))
                serial_ms += comm_ms + calc_ms
                hideable_ms += comm_ms

        # the whole pipelined path with the pieces' no-sink parameters
        measured_total_ms = t_ms(lambda: dist_attn_local(q, k, v, plan, calc_params, group))

    hidden_ms = max(serial_ms - measured_total_ms, 0.0)
    efficiency = min(hidden_ms / hideable_ms, 1.0) if hideable_ms > 0 else 0.0
    tl = MeasuredTimeline(
        overlap_degree=plan.overlap_degree,
        cp_size=plan.cp_size,
        stages=tuple(stages),
        measured_total_ms=measured_total_ms,
        serial_total_ms=serial_ms,
        hideable_comm_ms=hideable_ms,
        overlap_efficiency=efficiency,
        predicted_total_ms=predicted_total_ms,
        prediction_error_ratio=(measured_total_ms / predicted_total_ms
                                if predicted_total_ms else None),
        hops=tuple(hop_timings),
    )
    if record:
        from .collectors import record_measured_timeline

        record_measured_timeline(tl)
    return tl


def profile_key_timeline(
    key=None,
    *,
    reps: int | None = None,
    inner: int | None = None,
    warmup: int = 1,
    seed: int = 0,
    timer=None,
    record: bool = True,
) -> MeasuredTimeline:
    """Profile the runtime planned for a ``DistAttnRuntimeKey`` (default:
    the most recently planned key) on operands of the key's shape and dtype
    made on its device; every rank of its group calls it together. The
    measured twin of ``get_runtime_mgr(key).calc_attn``."""
    from ..api import interface as api_interface
    from ..parallel.dist_attn import make_attn_params

    if key is None:
        key = api_interface.get_most_recent_key()
    mgr = api_interface.get_runtime_mgr(key)
    plan = mgr.plan
    if not hasattr(plan, "stages"):
        raise NotImplementedError("profile_key_timeline supports group-cast runtimes only "
                                  "(qo-comm plans have no stage split to re-run)")
    _, _, head_block = key.block_config
    params = make_attn_params(plan, key.head_dim, softcap=key.softcap, has_sink=False,
                              out_dtype=api_interface.key_dtype(key), head_block=head_block)
    return profile_plan_timeline(
        plan, params, mgr.cp_group, num_heads=(key.num_heads_q, key.num_heads_kv),
        head_dim=key.head_dim, device=key.device, reps=reps, inner=inner, warmup=warmup,
        seed=seed, timer=timer, record=record)
