"""Metric collectors: the catalog of metric names and the ``record_*``
hooks the runtime calls.

The JAX package's ``telemetry/collectors.py``. The catalog (every ``M_*`` /
``H_*`` name and every ``REQUIRED_*_METRICS`` set) is the JAX package's, name
for name, so a dashboard reads either package. Each ``record_*`` returns at
once while telemetry is off: a hot path pays one predicate call.

The port carries the recorders whose callers it has: the serving engine,
scheduler and tiers, the memory and compile tracking, the request traces
and the flight recorder, the resilience hooks, the plan solver's seconds,
the cp planner, comm and keyed cache, the cost model, the roofline, the
measured timeline, the value census, the kernel autotuner, the plan
sanitizer (``record_validate``) and the interleaving checker
(``record_analysis_run``) and the fleet simulator and autopilot
(``record_fleet_*``).
"""

from __future__ import annotations

import time

from .events import DROPPED_COUNTER as M_TRACE_DROPPED
from .registry import get_registry


def _marker_event(name: str, attrs: dict) -> None:
    """Zero-duration marker on the same perf_counter clock ``span()``
    stamps real spans with (a ts=0 marker would stretch the Chrome trace's
    time axis back to system boot)."""
    from .events import record_event

    record_event(name, time.perf_counter(), 0.0, attrs)


# ---------------------------------------------------------------------------
# metric catalog
# ---------------------------------------------------------------------------

# counters: the cp planner and the keyed plan cache
M_PLAN_BUILDS = "magi_plan_builds_total"  # build_dist_attn_plan completions
M_DISPATCH_BUILDS = "magi_dispatch_meta_builds_total"
M_GRPCOLL_BUILDS = "magi_group_collective_builds_total"
M_CACHE_HITS = "magi_runtime_cache_hits_total"
M_CACHE_MISSES = "magi_runtime_cache_misses_total"
M_PLAN_CACHE_HITS = "magi_plan_cache_hits"
M_PLAN_CACHE_MISSES = "magi_plan_cache_misses"
M_VALIDATE_CHECKS = "magi_validate_plan_checks"
M_VALIDATE_FAILURES = "magi_validate_failures"

# gauges: the dispatch layer
M_DISPATCH_NUM_CHUNKS = "magi_dispatch_num_chunks"
M_DISPATCH_CHUNKS_RANK = "magi_dispatch_chunks_per_rank"  # {rank=}
M_DISPATCH_TOKEN_IMBALANCE = "magi_dispatch_token_imbalance_ratio"
M_DISPATCH_UNEVEN = "magi_dispatch_uneven"  # 0/1
M_SOLVER_MINIMAX = "magi_dispatch_solver_minimax_workload"
M_SOLVER_BALANCE = "magi_dispatch_solver_balance_ratio"  # max/mean bucket
M_DYN_SOLVER_BALANCE = "magi_dynamic_solver_balance_ratio"  # qo-comm plane

# gauges: the comm layer (payload rows; bytes per rank)
M_COMM_SEND_ROWS = "magi_comm_send_rows"  # {rank=}
M_COMM_RECV_ROWS = "magi_comm_recv_rows"  # {rank=}
M_COMM_PADDED_ROWS = "magi_comm_padded_payload_rows"
M_COMM_BYTES_RANK = "magi_comm_bytes_per_rank"  # {rank=}, bytes
M_COMM_SCHEDULED_ROWS = "magi_comm_scheduled_payload_rows"
M_COMM_TRUE_ROWS = "magi_comm_true_rows_total"
M_COMM_PADDING_OVERHEAD = "magi_comm_padding_overhead_ratio"
M_COMM_IMPL_CHOICE = "magi_comm_impl_choice"

# gauges: the plan layer
M_PLAN_OVERLAP_DEGREE = "magi_plan_overlap_degree"
M_PLAN_NUM_STAGES = "magi_plan_num_stages"
M_PLAN_TOTAL_AREA = "magi_plan_total_area"
M_PLAN_MAX_RANK_AREA = "magi_plan_max_rank_area"
M_PLAN_AREA_IMBALANCE = "magi_plan_area_imbalance_ratio"
M_PLAN_KERNEL_STEPS_FWD = "magi_plan_kernel_steps_fwd"
M_PLAN_KERNEL_STEPS_BWD = "magi_plan_kernel_steps_bwd"
M_OVERLAP_AUTO_DEGREE = "magi_overlap_auto_degree"
M_OVERLAP_MAKESPAN = "magi_overlap_modeled_makespan_s"

# gauges: the cost model
M_MODELED_FLOPS = "magi_plan_modeled_flops"
M_MODELED_CALC_S = "magi_plan_modeled_calc_seconds"
M_MODELED_COMM_S = "magi_plan_modeled_comm_seconds"

# counters and gauges: the kernel autotuner
M_AUTOTUNE_CACHE_HITS = "magi_autotune_cache_hits_total"  # {layer=}
M_AUTOTUNE_CACHE_MISSES = "magi_autotune_cache_misses_total"
M_AUTOTUNE_MEASUREMENTS = "magi_autotune_measurements_total"
M_AUTOTUNE_MEASURE_FAILURES = "magi_autotune_measure_failures_total"
M_AUTOTUNE_BLOCK_Q = "magi_autotune_block_q"
M_AUTOTUNE_BLOCK_K = "magi_autotune_block_k"
M_AUTOTUNE_HEAD_BLOCK = "magi_autotune_head_block"
M_AUTOTUNE_PREDICTED_MS = "magi_autotune_predicted_ms"
M_AUTOTUNE_MEASURED_MS = "magi_autotune_measured_ms"
M_AUTOTUNE_CHOICE = "magi_autotune_choice"

# gauges: measured stage timelines
M_TL_MEASURED_TOTAL_MS = "magi_overlap_measured_total_ms"  # pipelined e2e
M_TL_SERIAL_MS = "magi_overlap_measured_serial_ms"  # sum of fenced pieces
M_TL_COMM_MS = "magi_overlap_measured_comm_ms"  # {stage=}
M_TL_CALC_MS = "magi_overlap_measured_calc_ms"  # {stage=} incl stage=host
M_TL_EFFICIENCY = "magi_overlap_measured_efficiency"
M_TL_PREDICTED_MS = "magi_overlap_predicted_total_ms"  # solver's model
M_TL_PRED_ERROR = "magi_overlap_prediction_error_ratio"  # measured/pred

# gauges: the mask-aware roofline
M_ROOF_PEAK = "magi_roofline_peak_tflops"
M_ROOF_ACHIEVED = "magi_roofline_achieved_tflops"
M_ROOF_EFFICIENCY = "magi_roofline_efficiency"  # achieved / peak [0, ~1]
M_ROOF_MASK_FLOPS = "magi_roofline_mask_flops"  # true (A)
M_ROOF_SCHED_FLOPS = "magi_roofline_scheduled_flops"  # tile-granular (B)
M_ROOF_DENSITY = "magi_roofline_mask_density"  # A / dense Sq*Sk
M_ROOF_DEAD_FRAC = "magi_roofline_dead_step_fraction"
M_ROOF_PARTIAL_FRAC = "magi_roofline_partial_tile_fraction"
M_ROOF_MASKED_FRAC = "magi_roofline_masked_overcompute_fraction"
M_HOP_MS = "magi_hop_ms"

# serving: decode steps, prefill tokens and the page pool
M_DECODE_STEPS = "magi_decode_steps_total"
M_DECODE_TOKENS = "magi_decode_tokens_total"  # one per sequence per step
M_DECODE_BATCH = "magi_decode_batch_size"
M_DECODE_SPLITS = "magi_decode_num_splits"
M_DECODE_MAX_SEQ_LEN = "magi_decode_max_seq_len"
M_DECODE_CASCADE_GROUPS = "magi_decode_cascade_groups"
M_PREFILL_TOKENS = "magi_prefill_tokens_total"
M_KVCACHE_PAGES_TOTAL = "magi_kvcache_pages_total"
M_KVCACHE_PAGES_USED = "magi_kvcache_pages_in_use"
M_KVCACHE_OCCUPANCY = "magi_kvcache_occupancy_ratio"
M_KVCACHE_ACTIVE_SEQS = "magi_kvcache_active_seqs"
M_KVCACHE_PAGE_SIZE = "magi_kvcache_page_size"
M_KVCACHE_SHARED = "magi_kvcache_shared_pages"

# serving: the shared-prefix cache
M_PREFIX_HITS = "magi_prefix_cache_hits_total"
M_PREFIX_MISSES = "magi_prefix_cache_misses_total"
M_PREFIX_MATCHED_TOKENS = "magi_prefix_matched_tokens_total"
M_PREFIX_RESIDENT = "magi_prefix_resident_pages"  # gauge: trie-pinned
M_PREFIX_REGISTERED = "magi_prefix_registered_pages_total"  # newly pinned
M_PREFIX_COW = "magi_prefix_cow_splits_total"  # pages privatized on write
M_PREFIX_EVICTED = "magi_prefix_evicted_pages_total"  # LRU pressure drops

# serving: the scheduler, per tick, and the per-request SLO histograms
M_SCHED_STEPS = "magi_sched_steps_total"
M_SCHED_PREFILL_CHUNKS = "magi_sched_prefill_chunks_total"
M_SCHED_DECODE_STEPS = "magi_sched_decode_steps_total"
M_SCHED_WAITING = "magi_sched_waiting_requests"  # gauge: queued
M_SCHED_ACTIVE = "magi_sched_active_requests"  # gauge: prefilling+decoding
M_SCHED_STEP_TOKENS = "magi_sched_step_tokens"  # gauge: last step's usage
M_SCHED_BUDGET_UTIL = "magi_sched_budget_utilization"
M_SCHED_QUEUE_DEPTH = "magi_sched_queue_depth"
H_REQ_QUEUE_S = "magi_request_queue_seconds"
H_REQ_TTFT_S = "magi_request_ttft_seconds"
H_REQ_TOKLAT_S = "magi_request_token_latency_seconds"

# serving: disaggregated tiers (page streams, tier faults, tier occupancy)
M_PAGE_STREAMS = "magi_page_streams_total"
M_STREAM_PAGES = "magi_page_stream_pages_total"
M_STREAM_BYTES = "magi_page_stream_bytes_total"
M_STREAM_QUEUE = "magi_page_stream_queue_depth"  # gauge
M_TIER_FAULTS = "magi_tier_faults_total"  # {tier=, replica=}
M_TIER_PAGES_USED = "magi_tier_pages_in_use"  # {tier=, replica=}
M_TIER_ACTIVE = "magi_tier_active_requests"  # {tier=}

# memory: the ledger ({ledger=, phase=}) against the measured program
# ({program=, kind=}); pool forensics ({pool=}, {pool=, state=}); the
# device allocator sampler ({device=}, empty on the CPU, so in no REQUIRED
# set); the admission watermark
M_MEM_PREDICTED = "magi_mem_predicted_bytes"  # {ledger=, phase=}
M_MEM_MEASURED = "magi_mem_measured_bytes"  # {program=, kind=}
M_MEM_DELTA = "magi_mem_delta_ratio"  # {program=} predicted/measured io
M_MEM_UNATTRIBUTED = "magi_mem_unattributed_bytes"  # {program=}
M_MEM_POOL_FRAG = "magi_mem_pool_fragmentation_ratio"  # {pool=}
M_MEM_POOL_FREE_RUN = "magi_mem_pool_free_run_max"  # {pool=}
M_MEM_POOL_PAGES = "magi_mem_pool_pages"  # {pool=, state=}
M_MEM_POOL_PEAK = "magi_mem_pool_peak_pages"  # {pool=}
M_MEM_HBM_IN_USE = "magi_mem_hbm_bytes_in_use"  # {device=}
M_MEM_HBM_PEAK = "magi_mem_hbm_peak_bytes"  # process high-water
M_SCHED_HEADROOM = "magi_sched_admission_headroom"
M_KVCACHE_FREE = "magi_kvcache_free_pages"

# request traces and flight-recorder dumps ({trigger=})
M_REQ_TRACES = "magi_request_traces_total"
M_FLIGHT_DUMPS = "magi_flight_recorder_dumps_total"

# resilience: guards by {site=}, admission, degradation by {reason=}
M_GUARD_CHECKS = "magi_guard_checks"
M_GUARD_VIOLATIONS = "magi_guard_violations"
M_GUARD_REPAIRS = "magi_guard_repairs"
M_ADMISSION_REJECTED = "magi_admission_rejected"
M_ADMISSION_EVICTIONS = "magi_admission_evictions"
M_DEGRADED_PATH = "magi_degraded_path"
M_TUNING_CACHE_IO = "magi_tuning_cache_io_errors"

# histograms (seconds)
H_PLAN_BUILD_S = "magi_plan_build_seconds"
H_DISPATCH_SOLVE_S = "magi_dispatch_solve_seconds"

# program observability: builds by {program=}, build seconds, libraries
# built, distinct launches a scheduler tick, plan solver seconds by
# {outcome=} and the ms a cache hit saved; the plan-reuse counters
M_COMPILE_TOTAL = "magi_compile_total"  # {program=}
H_COMPILE_S = "magi_compile_seconds"
M_JIT_CACHE_ENTRIES = "magi_jit_cache_entries"
M_SCHED_LAUNCHES = "magi_sched_launches_per_tick"
H_PLAN_SOLVER_S = "magi_plan_solver_seconds"  # {outcome=}
M_SOLVER_MS_SAVED = "magi_plan_solver_ms_saved_total"
M_PLAN_CACHE_EVICTIONS = "magi_plan_cache_evictions_total"  # {cache=}
M_PLAN_BUCKET_HITS = "magi_plan_bucket_hits_total"
M_PLAN_BUCKET_MISSES = "magi_plan_bucket_misses_total"
M_PLAN_INCR_PATCHES = "magi_plan_incremental_patches_total"
M_PLAN_INCR_FALLBACKS = "magi_plan_incremental_fallbacks_total"

# the synthetic Chrome-trace track the tick decomposition spans land on
TICK_TRACK = "scheduler ticks"

# the series each check populates, the JAX package's sets name for name
REQUIRED_PLAN_METRICS: tuple[str, ...] = (
    M_PLAN_BUILDS,
    M_DISPATCH_BUILDS,
    M_GRPCOLL_BUILDS,
    M_DISPATCH_TOKEN_IMBALANCE,
    M_PLAN_AREA_IMBALANCE,
    M_PLAN_OVERLAP_DEGREE,
    M_PLAN_KERNEL_STEPS_FWD,
    M_PLAN_KERNEL_STEPS_BWD,
    M_COMM_SEND_ROWS,
    M_COMM_RECV_ROWS,
    M_COMM_BYTES_RANK,
    M_COMM_PADDING_OVERHEAD,
    M_COMM_SCHEDULED_ROWS,
    M_COMM_TRUE_ROWS,
    M_COMM_IMPL_CHOICE,
    M_MODELED_FLOPS,
    M_MODELED_CALC_S,
    M_MODELED_COMM_S,
    H_PLAN_BUILD_S,
)

REQUIRED_PLAN_CACHE_METRICS: tuple[str, ...] = (
    M_PLAN_CACHE_HITS,
    M_PLAN_CACHE_MISSES,
)

REQUIRED_TIMELINE_METRICS: tuple[str, ...] = (
    M_TL_MEASURED_TOTAL_MS,
    M_TL_SERIAL_MS,
    M_TL_COMM_MS,
    M_TL_CALC_MS,
    M_TL_EFFICIENCY,
    M_TL_PREDICTED_MS,
    M_TL_PRED_ERROR,
)

REQUIRED_ROOFLINE_METRICS: tuple[str, ...] = (
    M_ROOF_PEAK,
    M_ROOF_ACHIEVED,
    M_ROOF_EFFICIENCY,
    M_ROOF_MASK_FLOPS,
    M_ROOF_SCHED_FLOPS,
    M_ROOF_DENSITY,
    M_ROOF_DEAD_FRAC,
    M_ROOF_PARTIAL_FRAC,
    M_ROOF_MASKED_FRAC,
)

REQUIRED_SERVING_METRICS: tuple[str, ...] = (
    M_DECODE_STEPS,
    M_DECODE_TOKENS,
    M_DECODE_BATCH,
    M_DECODE_SPLITS,
    M_DECODE_MAX_SEQ_LEN,
    M_DECODE_CASCADE_GROUPS,
    M_PREFILL_TOKENS,
    M_KVCACHE_PAGES_TOTAL,
    M_KVCACHE_PAGES_USED,
    M_KVCACHE_OCCUPANCY,
    M_KVCACHE_ACTIVE_SEQS,
    M_KVCACHE_PAGE_SIZE,
    M_KVCACHE_SHARED,
)

REQUIRED_PREFIX_METRICS: tuple[str, ...] = (
    M_PREFIX_HITS,
    M_PREFIX_MISSES,
    M_PREFIX_MATCHED_TOKENS,
    M_PREFIX_RESIDENT,
    M_PREFIX_REGISTERED,
    M_PREFIX_COW,
    M_PREFIX_EVICTED,
)

REQUIRED_SCHED_METRICS: tuple[str, ...] = (
    M_SCHED_STEPS,
    M_SCHED_PREFILL_CHUNKS,
    M_SCHED_DECODE_STEPS,
    M_SCHED_WAITING,
    M_SCHED_ACTIVE,
    M_SCHED_STEP_TOKENS,
    M_SCHED_BUDGET_UTIL,
    M_SCHED_QUEUE_DEPTH,
    H_REQ_QUEUE_S,
    H_REQ_TTFT_S,
    H_REQ_TOKLAT_S,
)

REQUIRED_DISTSERVE_METRICS: tuple[str, ...] = (
    M_PAGE_STREAMS,
    M_STREAM_PAGES,
    M_STREAM_BYTES,
    M_STREAM_QUEUE,
    M_TIER_FAULTS,
    M_TIER_PAGES_USED,
    M_TIER_ACTIVE,
)

REQUIRED_TRACE_METRICS: tuple[str, ...] = (
    M_REQ_TRACES,
    M_TRACE_DROPPED,
    M_FLIGHT_DUMPS,
)

REQUIRED_MEMORY_METRICS: tuple[str, ...] = (
    M_MEM_PREDICTED,
    M_MEM_MEASURED,
    M_MEM_DELTA,
    M_MEM_UNATTRIBUTED,
    M_MEM_POOL_FRAG,
    M_MEM_POOL_FREE_RUN,
    M_MEM_POOL_PAGES,
    M_MEM_POOL_PEAK,
    M_SCHED_HEADROOM,
    M_KVCACHE_FREE,
)


REQUIRED_RESILIENCE_METRICS: tuple[str, ...] = (
    M_GUARD_CHECKS,
    M_GUARD_VIOLATIONS,
    M_GUARD_REPAIRS,
    M_ADMISSION_REJECTED,
    M_ADMISSION_EVICTIONS,
    M_DEGRADED_PATH,
    M_TUNING_CACHE_IO,
)


REQUIRED_VALIDATE_METRICS: tuple[str, ...] = (
    M_VALIDATE_CHECKS,
    M_VALIDATE_FAILURES,
)


# the interleaving checker
M_ANALYSIS_STATES = "magi_analysis_states_explored"
M_ANALYSIS_CEX = "magi_analysis_counterexamples"

REQUIRED_ANALYSIS_METRICS: tuple[str, ...] = (
    M_ANALYSIS_STATES,
    M_ANALYSIS_CEX,
)


REQUIRED_COMPILE_METRICS: tuple[str, ...] = (
    M_COMPILE_TOTAL,
    H_COMPILE_S,
    M_JIT_CACHE_ENTRIES,
    M_SCHED_LAUNCHES,
    H_PLAN_SOLVER_S,
    M_SOLVER_MS_SAVED,
)


# numerics: the in-graph census ({layer=, site=, stat=}) and the
# shadow check's checks, ulp divergence and breaches
M_NUMERICS_CENSUS = "magi_numerics_census"  # {layer=, site=, stat=}
H_NUMERICS_OUT_MAX_ABS = "magi_numerics_out_max_abs"  # {layer=}
H_NUMERICS_MASS_DEV = "magi_numerics_mass_dev"  # {layer=}
M_NUMERICS_SHADOW_CHECKS = "magi_numerics_shadow_checks"
H_NUMERICS_SHADOW_DIVERGENCE = "magi_numerics_shadow_divergence"
M_NUMERICS_SHADOW_BREACHES = "magi_numerics_shadow_breaches"

# histogram bounds: out max-abs, mass deviation, shadow ulps
_OUT_MAX_ABS_BOUNDS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0)
_MASS_DEV_BOUNDS = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)
_SHADOW_ULP_BOUNDS = (
    1.0, 8.0, 64.0, 512.0, 4096.0, 32768.0, 2.0**20, 2.0**30,
)

REQUIRED_NUMERICS_METRICS: tuple[str, ...] = (
    M_NUMERICS_CENSUS,
    H_NUMERICS_OUT_MAX_ABS,
    H_NUMERICS_MASS_DEV,
    M_NUMERICS_SHADOW_CHECKS,
    H_NUMERICS_SHADOW_DIVERGENCE,
    M_NUMERICS_SHADOW_BREACHES,
)

# the fleet simulator and autopilot (tick-denominated)
M_FLEET_OFFERED = "magi_fleet_offered_requests_total"
M_FLEET_SERVED = "magi_fleet_served_requests_total"
M_FLEET_SLO_OK = "magi_fleet_slo_ok_total"  # finished inside SLO
M_FLEET_SLO_ATTAINMENT = "magi_fleet_slo_attainment"  # gauge 0..1 window
M_FLEET_GOODPUT = "magi_fleet_goodput_tokens_total"
M_FLEET_CONCURRENT = "magi_fleet_concurrent_requests"  # gauge: in flight
M_FLEET_AUTOPILOT_ACTIONS = "magi_fleet_autopilot_actions_total"
M_FLEET_AUTOPILOT_HOLDS = "magi_fleet_autopilot_holds_total"
M_FLEET_KNOB = "magi_fleet_knob_value"  # gauge {knob=}
H_FLEET_TTFT_TICKS = "magi_fleet_ttft_ticks"
H_FLEET_TOKLAT_TICKS = "magi_fleet_token_latency_ticks"

_FLEET_TICK_BOUNDS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
)

REQUIRED_FLEET_METRICS: tuple[str, ...] = (
    M_FLEET_OFFERED,
    M_FLEET_SERVED,
    M_FLEET_SLO_OK,
    M_FLEET_SLO_ATTAINMENT,
    M_FLEET_GOODPUT,
    M_FLEET_CONCURRENT,
    M_FLEET_AUTOPILOT_ACTIONS,
    M_FLEET_AUTOPILOT_HOLDS,
    M_FLEET_KNOB,
    H_FLEET_TTFT_TICKS,
    H_FLEET_TOKLAT_TICKS,
)


def record_numerics_census(layer: str, site: str, stats: dict) -> None:
    """One consumed value census of one guard site: a gauge for every
    value, and the out max-abs / mass-deviation histograms (``site='final'``
    carries only ``mass_dev``)."""
    if not _enabled():
        return
    reg = get_registry()
    for stat, val in stats.items():
        v = float(val)
        reg.gauge_set(M_NUMERICS_CENSUS, v, layer=layer, site=site, stat=stat)
        if stat == "out_max_abs":
            reg.histogram_observe(H_NUMERICS_OUT_MAX_ABS, v, bounds=_OUT_MAX_ABS_BOUNDS,
                                  layer=layer)
        elif stat == "mass_dev":
            reg.histogram_observe(H_NUMERICS_MASS_DEV, v, bounds=_MASS_DEV_BOUNDS, layer=layer)


def record_shadow_check(
    divergence_ulp: float, *, breached: bool
) -> None:
    """One drift-sentinel shadow re-computation: the max-ulp score of
    production vs f32 reference, and whether it breached the error
    budget (0 increments still materialize the breach series)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_NUMERICS_SHADOW_CHECKS)
    reg.histogram_observe(
        H_NUMERICS_SHADOW_DIVERGENCE,
        max(float(divergence_ulp), 0.0),
        bounds=_SHADOW_ULP_BOUNDS,
    )
    reg.counter_inc(M_NUMERICS_SHADOW_BREACHES, 1 if breached else 0)


def record_analysis_run(states_explored: int, counterexamples: int) -> None:
    """One interleaving-checker exploration (``analysis/lifecycle.py``):
    canonical states visited and counterexamples found (0 increments still
    materialize the series, so the catalog check sees a clean run)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_ANALYSIS_STATES, max(int(states_explored), 0))
    reg.counter_inc(M_ANALYSIS_CEX, max(int(counterexamples), 0))


def record_validate(failed: bool) -> None:
    """One plan-sanitizer outcome (``analysis/plan_sanity.py``): every
    call ticks the checks counter, failures additionally tick the failure
    counter."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_VALIDATE_CHECKS)
    if failed:
        reg.counter_inc(M_VALIDATE_FAILURES)


def _enabled() -> bool:
    from . import enabled

    return enabled()


# ---------------------------------------------------------------------------
# resilience layer (resilience/ + its call sites)
# ---------------------------------------------------------------------------


def record_guard_check(site: str) -> None:
    """One numerical guard applied at ``site`` (``resilience/guards.py``).
    The port runs eagerly, so this counts once per guard call, where the
    JAX package counts once per traced program."""
    if not _enabled():
        return
    get_registry().counter_inc(M_GUARD_CHECKS, site=site)


def record_guard_violation(site: str) -> None:
    """A check-mode guard's error code decoded nonzero at the call
    boundary — a non-finite partial reached ``site``. Alarm on this."""
    if not _enabled():
        return
    get_registry().counter_inc(M_GUARD_VIOLATIONS, site=site)


def record_guard_repair(site: str) -> None:
    """A repair-mode guard quarantined a poisoned partial at ``site``
    (the merge proceeded with that contribution weighted to zero)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_GUARD_REPAIRS, site=site)


def record_admission(result) -> None:
    """One ``ServingEngine.admit`` outcome (``AdmissionResult``):
    rejections count by reason, evictions by the retry policy count
    regardless of the final verdict."""
    if not _enabled():
        return
    reg = get_registry()
    if result.evicted:
        reg.counter_inc(M_ADMISSION_EVICTIONS, len(result.evicted))
    if not result.admitted:
        reg.counter_inc(M_ADMISSION_REJECTED, reason=result.reason)


def record_degraded_path(reason: str) -> None:
    """A degradation path engaged (plan-build -> dense degree-0 plan,
    hops build -> a2a impl): gauge value 1 labeled with the reason, plus
    a marker event so traces show WHEN it happened. Also arms/writes a
    flight-recorder dump (outside the telemetry gate — the recorder is
    always-on) and, when a request context is live, a ``degraded`` span
    on that request's trace."""
    from .trace import SPAN_DEGRADED, get_flight_recorder, span_for_current

    get_flight_recorder().trigger("degraded_path", reason=reason)
    if not _enabled():
        return
    span_for_current(SPAN_DEGRADED, reason=reason)
    get_registry().gauge_set(M_DEGRADED_PATH, 1, reason=reason)
    _marker_event("degraded_path", {"reason": reason})


def record_tuning_cache_io_error(op: str) -> None:
    """A tuning-cache disk load or store failed (``tuning/cache.py``): still
    a miss or a skipped store, but counted."""
    if not _enabled():
        return
    get_registry().counter_inc(M_TUNING_CACHE_IO, op=op)


# ---------------------------------------------------------------------------
# kernel autotuner (tuning/)
# ---------------------------------------------------------------------------


def record_autotune_cache(hit: bool, layer: str) -> None:
    """A tuning-cache lookup: hits labelled with the layer that answered
    (memory | disk)."""
    if not _enabled():
        return
    reg = get_registry()
    if hit:
        reg.counter_inc(M_AUTOTUNE_CACHE_HITS, layer=layer)
    else:
        reg.counter_inc(M_AUTOTUNE_CACHE_MISSES)


def record_autotune_measurement() -> None:
    """One measure-mode candidate timed on the card."""
    if not _enabled():
        return
    get_registry().counter_inc(M_AUTOTUNE_MEASUREMENTS)


def record_autotune_measure_failure(candidate: str, error: str) -> None:
    """A measure-mode candidate raised: disqualified, not fatal."""
    if not _enabled():
        return
    get_registry().counter_inc(M_AUTOTUNE_MEASURE_FAILURES)
    _marker_event("autotune_measure_failed", {"candidate": candidate, "error": error[:200]})


def record_autotune_decision(decision) -> None:
    """One resolved kernel choice (``tuning/autotuner.py``): the choice, its
    source (static rule, cost model, measured, cache layer) and its
    predicted and measured cost."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_AUTOTUNE_BLOCK_Q, decision.block_q)
    reg.gauge_set(M_AUTOTUNE_BLOCK_K, decision.block_k)
    reg.gauge_set(M_AUTOTUNE_HEAD_BLOCK, decision.head_block)
    reg.gauge_set(M_AUTOTUNE_PREDICTED_MS, decision.predicted_ms)
    if decision.measured_ms is not None:
        reg.gauge_set(M_AUTOTUNE_MEASURED_MS, decision.measured_ms)
    reg.clear_metric(M_AUTOTUNE_CHOICE)  # one live choice series at a time
    rung = f"{decision.block_q}x{decision.block_k}x{decision.head_block}"
    reg.gauge_set(M_AUTOTUNE_CHOICE, 1, rung=rung, source=decision.source)
    _marker_event("autotune_decision", {
        "rung": rung, "source": decision.source, "cache_layer": decision.cache_layer,
        "fingerprint": decision.fingerprint_hash, "reason": decision.reason,
    })


# ---------------------------------------------------------------------------
# serving subsystem (serving/)
# ---------------------------------------------------------------------------


def record_decode_step(
    *,
    batch_size: int,
    num_splits: int,
    max_seq_len: int,
    cascade_groups: int = 0,
) -> None:
    """One continuous-batching decode step (``serving/engine.py``):
    counts steps/tokens and keeps the latest batch geometry — the
    resolved split count is what the flat split-KV kernel ran
    (``num_splits = 0`` means the step ran cascade attention, which
    resolves splits per phase; ``cascade_groups`` is then the
    shared-prefix group count)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_DECODE_STEPS)
    reg.counter_inc(M_DECODE_TOKENS, batch_size)
    reg.gauge_set(M_DECODE_BATCH, int(batch_size))
    reg.gauge_set(M_DECODE_SPLITS, int(num_splits))
    reg.gauge_set(M_DECODE_MAX_SEQ_LEN, int(max_seq_len))
    reg.gauge_set(M_DECODE_CASCADE_GROUPS, int(cascade_groups))


def record_prefill(num_tokens: int) -> None:
    """One prefill written into the paged cache (``prefill_into_cache``
    via the engine)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_PREFILL_TOKENS, int(num_tokens))


def record_kvcache_state(occupancy: dict) -> None:
    """Page-pool occupancy after an admission/growth/free event
    (``serving/kv_cache.PageAllocator.occupancy`` payload)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_KVCACHE_PAGES_TOTAL, int(occupancy["pages_total"]))
    reg.gauge_set(M_KVCACHE_PAGES_USED, int(occupancy["pages_in_use"]))
    reg.gauge_set(M_KVCACHE_OCCUPANCY, float(occupancy["occupancy_ratio"]))
    reg.gauge_set(M_KVCACHE_ACTIVE_SEQS, int(occupancy["active_seqs"]))
    reg.gauge_set(M_KVCACHE_PAGE_SIZE, int(occupancy["page_size"]))
    reg.gauge_set(M_KVCACHE_SHARED, int(occupancy.get("shared_pages", 0)))
    # magi_kvcache_free_pages is deliberately NOT set here: every
    # engine's _record_pool runs this collector, and on a TieredEngine
    # the decode replicas would overwrite the admission-facing prefill
    # pool's figure — the one the headroom gauge pairs with. The
    # scheduler's per-tick record_admission_watermark is the single
    # source (it reads the admission-facing allocator).


# ---------------------------------------------------------------------------
# memory observability (telemetry/memory.py)
# ---------------------------------------------------------------------------


def record_memory_ledger(ledger) -> None:
    """One static memory-ledger pricing (``telemetry/memory.py``
    :class:`MemoryLedger`): per-phase predicted bytes plus the total,
    labeled with the ledger name so plan/serving/tier ledgers keep
    separate series. Overwrite semantics per (ledger, phase): a
    re-priced configuration with FEWER phases should use a fresh name
    (how the checks do) rather than rely on stale-phase clearing."""
    if not _enabled():
        return
    reg = get_registry()
    for phase, b in ledger.by_phase().items():
        reg.gauge_set(M_MEM_PREDICTED, int(b), ledger=ledger.name,
                      phase=phase)
    reg.gauge_set(M_MEM_PREDICTED, int(ledger.total()),
                  ledger=ledger.name, phase="total")


def record_memory_measurement(program: str, measured: dict) -> None:
    """One measured program (``measure_program_memory`` payload):
    argument/output/temp/alias bytes of a call on the card."""
    if not _enabled():
        return
    reg = get_registry()
    for kind in ("argument", "output", "temp", "alias"):
        v = measured.get(f"{kind}_bytes")
        if v is not None:
            reg.gauge_set(M_MEM_MEASURED, int(v), program=program,
                          kind=kind)


def record_memory_comparison(cmp) -> None:
    """One predicted-vs-measured verdict
    (``telemetry/memory.MemoryComparison``): the gated io delta ratio
    and the honest unattributed temp residual."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_MEM_DELTA, float(cmp.delta_ratio), program=cmp.program)
    reg.gauge_set(
        M_MEM_UNATTRIBUTED, int(cmp.unattributed_bytes),
        program=cmp.program,
    )
    _marker_event(
        "memory_probe",
        {
            "program": cmp.program,
            "predicted_io_bytes": cmp.predicted_io_bytes,
            "measured_io_bytes": cmp.measured_io_bytes,
            "delta_ratio": cmp.delta_ratio,
            "unattributed_bytes": cmp.unattributed_bytes,
        },
    )


def record_memory_pool(fmap) -> None:
    """One pool-forensics snapshot (``telemetry/memory.
    PoolFragmentationMap``): fragmentation ratio, longest free run,
    per-state page counts, lifetime peak."""
    if not _enabled():
        return
    reg = get_registry()
    p = fmap.pool
    reg.gauge_set(M_MEM_POOL_FRAG, float(fmap.fragmentation_ratio), pool=p)
    reg.gauge_set(M_MEM_POOL_FREE_RUN, int(fmap.free_run_max), pool=p)
    reg.gauge_set(M_MEM_POOL_PEAK, int(fmap.peak_pages), pool=p)
    for state, count in fmap.state_counts().items():
        reg.gauge_set(M_MEM_POOL_PAGES, int(count), pool=p, state=state)


def record_hbm_sample(samples: dict) -> None:
    """One device memory_stats sample (``telemetry/memory.
    sample_memory_stats``): bytes_in_use per device plus the running
    process-wide peak. Empty samples (CPU) record nothing."""
    if not _enabled() or not samples:
        return
    reg = get_registry()
    peak = 0
    for dev, b in samples.items():
        reg.gauge_set(M_MEM_HBM_IN_USE, int(b), device=str(dev))
        peak = max(peak, int(b))
    prev = reg.gauge_value(M_MEM_HBM_PEAK, default=0)
    reg.gauge_set(M_MEM_HBM_PEAK, max(int(prev or 0), peak))


def record_admission_watermark(headroom: int, free_pages: int) -> None:
    """The scheduler's per-tick admission watermark: pages an
    evictionless admission must leave free for decode growth, next to the
    pool's actual free pages — ``free - headroom`` trending to 0 is
    backpressure arriving."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_SCHED_HEADROOM, int(headroom))
    reg.gauge_set(M_KVCACHE_FREE, int(free_pages))


# ---------------------------------------------------------------------------
# shared-prefix cache + scheduler (serving/prefix.py, serving/scheduler.py)
# ---------------------------------------------------------------------------


def record_prefix_lookup(*, hit: bool, matched_tokens: int = 0) -> None:
    """One token-carrying admission consulted the prefix trie
    (``ServingEngine.admit``); on a hit, ``matched_tokens`` prompt
    tokens were installed by reference instead of prefilled."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_PREFIX_HITS if hit else M_PREFIX_MISSES)
    if matched_tokens:
        reg.counter_inc(M_PREFIX_MATCHED_TOKENS, int(matched_tokens))


def record_prefix_registered(newly_pinned: int, resident_pages: int) -> None:
    """One prompt registered as shareable (``ServingEngine.commit_prefix``):
    counts the pages newly pinned by the trie and refreshes the resident
    gauge (registered - evicted = resident, reconcilable offline)."""
    if not _enabled():
        return
    reg = get_registry()
    if newly_pinned:
        reg.counter_inc(M_PREFIX_REGISTERED, int(newly_pinned))
    reg.gauge_set(M_PREFIX_RESIDENT, int(resident_pages))


def record_prefix_cow() -> None:
    """One copy-on-write page split: a sequence needed to write into a
    still-shared tail page and got its private copy. When a request
    context is live (the scheduler wraps engine calls), the split also
    lands as a ``cow`` span on that request's trace."""
    if not _enabled():
        return
    from .trace import SPAN_COW, span_for_current

    span_for_current(SPAN_COW)
    get_registry().counter_inc(M_PREFIX_COW)


def record_prefix_eviction(pages_freed: int, resident_pages: int) -> None:
    """Pool pressure dropped LRU unreferenced prefix pages
    (``PrefixCache.evict`` via admission)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_PREFIX_EVICTED, int(pages_freed))
    reg.gauge_set(M_PREFIX_RESIDENT, int(resident_pages))


def record_sched_step(
    *,
    waiting: int,
    active: int,
    tokens_used: int,
    prefill_chunks: int,
    decode_ran: bool,
    budget_utilization: float | None = None,
    queue_depth: int | None = None,
) -> None:
    """One ``Scheduler.step`` tick: queue depths and what the token
    budget actually bought (chunks started, decode step or not), plus
    the tick's budget utilization and start-of-tick queue depth
    (saturation without trace replay)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_SCHED_STEPS)
    if prefill_chunks:
        reg.counter_inc(M_SCHED_PREFILL_CHUNKS, int(prefill_chunks))
    if decode_ran:
        reg.counter_inc(M_SCHED_DECODE_STEPS)
    reg.gauge_set(M_SCHED_WAITING, int(waiting))
    reg.gauge_set(M_SCHED_ACTIVE, int(active))
    reg.gauge_set(M_SCHED_STEP_TOKENS, int(tokens_used))
    if budget_utilization is not None:
        reg.gauge_set(M_SCHED_BUDGET_UTIL, float(budget_utilization))
    if queue_depth is not None:
        reg.gauge_set(M_SCHED_QUEUE_DEPTH, int(queue_depth))


def record_compile(
    program: str, seconds: float, total_programs: int
) -> None:
    """One kernel library that nvcc or g++ built, attributed to its
    program label (``telemetry/compile.py`` ingestion — the tracker's own
    accumulators are always on; only this registry mirror is gated).
    ``total_programs`` is the process-cumulative build count, the
    ``magi_jit_cache_entries`` gauge (built libraries are never evicted,
    so it is the live count)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_COMPILE_TOTAL, program=program)
    reg.histogram_observe(H_COMPILE_S, float(seconds))
    reg.gauge_set(M_JIT_CACHE_ENTRIES, int(total_programs))


def record_plan_solver(seconds: float, *, cache_hit: bool) -> None:
    """One host-solver resolution: a plan-LRU lookup that hit
    (``api/interface.py``) or a cold ``build_dist_attn_plan``
    (``parallel/dist_attn.py``, the miss path's dominant cost).

    ALWAYS feeds the compile tracker's solver accumulator (plain module
    state outside the registry — the scheduler's per-tick cost
    attribution must work with telemetry off; the disabled-mode no-op
    contract covers the registry only). With telemetry on, the seconds
    land on ``magi_plan_solver_seconds{outcome=}`` and each hit credits
    ``magi_plan_solver_ms_saved_total`` with the mean measured
    cold-build latency."""
    from . import compile as _compile

    _compile.add_solver_seconds(float(seconds))
    if not cache_hit:
        _compile.get_compile_tracker().note_plan_build(float(seconds))
    if not _enabled():
        return
    reg = get_registry()
    reg.histogram_observe(
        H_PLAN_SOLVER_S,
        float(seconds),
        outcome="hit" if cache_hit else "miss",
    )
    if cache_hit:
        mean_s = _compile.get_compile_tracker().plan_build_mean_s()
        if mean_s:
            reg.counter_inc(M_SOLVER_MS_SAVED, mean_s * 1e3)


def record_tick_programs(
    *,
    step: int,
    start_s: float,
    wall_s: float,
    programs: list,
    compiles: int,
    solver_s: float,
    compile_s: float,
    device_s: float,
    residual_s: float,
) -> None:
    """One scheduler tick's launch ledger + cost decomposition: the
    distinct-program launch count lands on the
    ``magi_sched_launches_per_tick`` histogram, and the full
    decomposition — geometry census (label -> launches), compile count,
    solver/compile/device ms and the HONEST unattributed residual
    (negative when attribution over-counts; surfaced, never folded into
    a gate) — rides a span on the dedicated tick-decomposition
    Chrome-trace track."""
    if not _enabled():
        return
    from .events import record_event

    census: dict[str, int] = {}
    for p in programs:
        census[p] = census.get(p, 0) + 1
    reg = get_registry()
    reg.histogram_observe(
        M_SCHED_LAUNCHES,
        float(len(census)),
        bounds=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
    )
    record_event(
        "sched_tick",
        start_s,
        wall_s,
        {
            "step": int(step),
            "launches": len(census),
            "programs": census,
            "compiles": int(compiles),
            "solver_ms": round(solver_s * 1e3, 3),
            "compile_ms": round(compile_s * 1e3, 3),
            "device_ms": round(device_s * 1e3, 3),
            "residual_ms": round(residual_s * 1e3, 3),
            "wall_ms": round(wall_s * 1e3, 3),
        },
        track=TICK_TRACK,
    )


def record_request_traced() -> None:
    """One request entered the traced lifecycle (``trace.span_submit``)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_REQ_TRACES)


def record_flight_dump(trigger: str) -> None:
    """One flight-recorder post-mortem dump was written ({trigger=})."""
    if not _enabled():
        return
    get_registry().counter_inc(M_FLIGHT_DUMPS, trigger=trigger)
    _marker_event("flight_recorder_dump", {"trigger": trigger})


def _slo_observe(name: str, seconds: float, tier: str | None) -> None:
    """``tier=`` threading for the SLO histograms: every sample lands on
    the unlabeled series (the fleet-wide aggregate, which must not go
    blank when a deployment switches to tiered serving), and a tiered
    sample also lands on a ``tier=``-labeled series so each tier's p99 is
    scrapeable on its own."""
    reg = get_registry()
    reg.histogram_observe(name, seconds)
    if tier is not None:
        reg.histogram_observe(name, seconds, tier=tier)


def record_request_queue_time(seconds: float, *, tier: str | None = None) -> None:
    """Submission -> admission wait of one request (SLO surface)."""
    if not _enabled():
        return
    _slo_observe(H_REQ_QUEUE_S, float(seconds), tier)


def record_request_ttft(seconds: float, *, tier: str | None = None) -> None:
    """Submission -> first decoded token of one request (SLO surface)."""
    if not _enabled():
        return
    _slo_observe(H_REQ_TTFT_S, float(seconds), tier)


def record_request_token_latency(
    seconds: float, *, tier: str | None = None
) -> None:
    """Inter-token decode latency of one generated token (SLO surface)."""
    if not _enabled():
        return
    _slo_observe(H_REQ_TOKLAT_S, float(seconds), tier)


# ---------------------------------------------------------------------------
# disaggregated serving (serving/distributed.py)
# ---------------------------------------------------------------------------


def record_page_stream(
    *, pages: int, nbytes: int, queue_depth: int
) -> None:
    """One committed prompt's pages streamed prefill -> decode tier
    (``TieredEngine.pump_streams``): the wire traffic of the
    disaggregation hand-off, plus the post-pump queue depth."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_PAGE_STREAMS)
    reg.counter_inc(M_STREAM_PAGES, int(pages))
    reg.counter_inc(M_STREAM_BYTES, int(nbytes))
    reg.gauge_set(M_STREAM_QUEUE, int(queue_depth))


def record_stream_queue_depth(depth: int) -> None:
    """Streams parked waiting for decode-tier capacity (a stream that
    could not place this tick). Sustained nonzero = decode tier is the
    fleet bottleneck — admission backpressure follows."""
    if not _enabled():
        return
    get_registry().gauge_set(M_STREAM_QUEUE, int(depth))


def record_tier_fault(tier: str, replica: int) -> None:
    """One tier chip/replica failed (chaos-injected or organic) and was
    absorbed by the requeue+replay path."""
    if not _enabled():
        return
    get_registry().counter_inc(M_TIER_FAULTS, tier=tier, replica=replica)


def record_tier_state(
    tier: str, *, pages_in_use: int, active: int, replica: int | None = None
) -> None:
    """One tier member's pool occupancy + live-request count (after an
    admission / stream / free)."""
    if not _enabled():
        return
    reg = get_registry()
    labels = {"tier": tier}
    if replica is not None:
        labels["replica"] = replica
    reg.gauge_set(M_TIER_PAGES_USED, int(pages_in_use), **labels)
    reg.gauge_set(M_TIER_ACTIVE, int(active), tier=tier)


def record_fleet_offered(n: int = 1) -> None:
    """``n`` trace arrivals presented to the fleet this tick (counted
    whether or not admission accepted them — offered load)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_FLEET_OFFERED, int(n))


def record_fleet_finished(
    *, ttft_ticks: float, token_latency_ticks: float,
    tokens: int, slo_ok: bool,
) -> None:
    """One request finished: served counter, tick-unit latency
    histograms, and — only when it met its SLO — the slo-ok counter and
    its tokens into goodput."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_FLEET_SERVED)
    reg.histogram_observe(
        H_FLEET_TTFT_TICKS, float(ttft_ticks), bounds=_FLEET_TICK_BOUNDS
    )
    reg.histogram_observe(
        H_FLEET_TOKLAT_TICKS, float(token_latency_ticks),
        bounds=_FLEET_TICK_BOUNDS,
    )
    if slo_ok:
        reg.counter_inc(M_FLEET_SLO_OK)
        reg.counter_inc(M_FLEET_GOODPUT, int(tokens))


def record_fleet_window(
    *, slo_attainment: float, concurrent: int
) -> None:
    """End of one autopilot window: the window's SLO attainment (of the
    requests that finished in it) and the in-flight request count."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_FLEET_SLO_ATTAINMENT, float(slo_attainment))
    reg.gauge_set(M_FLEET_CONCURRENT, int(concurrent))


def record_fleet_autopilot_action(
    knob: str, direction: str, value: float
) -> None:
    """The autopilot retuned one knob (``direction`` up|down) to
    ``value`` — action counter + live knob gauge."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_FLEET_AUTOPILOT_ACTIONS, knob=knob,
                    direction=direction)
    reg.gauge_set(M_FLEET_KNOB, float(value), knob=knob)


def record_fleet_autopilot_hold(reason: str) -> None:
    """The autopilot evaluated a window and deliberately did NOT act
    (``reason``: steady|cooldown|hysteresis|fault|bounds|reversal)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_FLEET_AUTOPILOT_HOLDS, reason=reason)


def record_fleet_knob(knob: str, value: float) -> None:
    """Seed/refresh a knob gauge without an action (initial values)."""
    if not _enabled():
        return
    get_registry().gauge_set(M_FLEET_KNOB, float(value), knob=knob)


# ---------------------------------------------------------------------------
# dispatch layer
# ---------------------------------------------------------------------------


def record_dispatch_meta(meta) -> None:
    """One DispatchMeta built (``meta/dispatch_meta.py``): chunk counts and
    the token imbalance of the physical shard (1.0 = even; above 1 the
    lighter ranks of an uneven shard hold pad slots)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_DISPATCH_BUILDS)
    reg.gauge_set(M_DISPATCH_NUM_CHUNKS, meta.num_chunks)
    reg.gauge_set(M_DISPATCH_UNEVEN, int(meta.is_uneven))
    valid = meta.rank_valid_lens
    mean_valid = sum(valid) / max(len(valid), 1)
    reg.gauge_set(M_DISPATCH_TOKEN_IMBALANCE,
                  (meta.shard_seqlen / mean_valid) if mean_valid else 1.0)
    reg.clear_metric(M_DISPATCH_CHUNKS_RANK)  # cp may shrink between plans
    for r, p in enumerate(meta.partitions):
        reg.gauge_set(M_DISPATCH_CHUNKS_RANK, len(p), rank=r)


def record_dispatch_solution(alg: str, minimax_workload: float, bucket_workloads,
                             solve_seconds: float) -> None:
    """The dispatch solver's result (``meta/solver/dispatch_solver.py``):
    the minimax objective, the max / mean balance and the solve seconds."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_SOLVER_MINIMAX, float(minimax_workload), alg=alg)
    loads = list(bucket_workloads)
    mean = sum(loads) / max(len(loads), 1)
    reg.gauge_set(M_SOLVER_BALANCE, (max(loads) / mean) if mean else 1.0, alg=alg)
    reg.histogram_observe(H_DISPATCH_SOLVE_S, solve_seconds, alg=alg)


def record_dynamic_solution(solver: str, balance_ratio: float) -> None:
    """The qo-comm plane partition's balance (``parallel/qo_comm.py``)."""
    if not _enabled():
        return
    get_registry().gauge_set(M_DYN_SOLVER_BALANCE, float(balance_ratio), solver=solver)


# ---------------------------------------------------------------------------
# comm layer
# ---------------------------------------------------------------------------


def record_group_collective_build(comm) -> None:
    """One cast routed (``comm/group_collective.py``, ``comm/hier.py``):
    counts builds and keeps the latest true, padded and scheduled rows and
    the scheduled / true ratio of the cast, and the impl chosen. Per-rank
    rows are recorded with the plan (:func:`record_plan`), where the
    plan's own comm is known: builds also run for each stage's cast."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_GRPCOLL_BUILDS)
    reg.gauge_set(M_COMM_PADDED_ROWS, comm.padded_rows_per_rank)
    reg.gauge_set(M_COMM_SCHEDULED_ROWS, comm.scheduled_rows_per_rank)
    reg.gauge_set(M_COMM_TRUE_ROWS, comm.true_rows_total)
    reg.gauge_set(M_COMM_PADDING_OVERHEAD, comm.padding_overhead_ratio, kind="cast")
    reg.clear_metric(M_COMM_IMPL_CHOICE)  # one live choice at a time
    reg.gauge_set(M_COMM_IMPL_CHOICE, 1, impl=comm.impl, reason=comm.impl_reason)


def record_comm_op(comm, kind: str) -> None:
    """One group reduce run against a cast's routing (``group_reduce_sum``,
    ``group_reduce_lse``): its scheduled / true ratio by kind."""
    if not _enabled():
        return
    get_registry().gauge_set(M_COMM_PADDING_OVERHEAD, comm.padding_overhead_ratio, kind=kind)


# ---------------------------------------------------------------------------
# plan layer
# ---------------------------------------------------------------------------


def record_overlap_choice(degree: int, modeled_makespan_s: float) -> None:
    """The auto overlap degree's search result (``_choose_overlap_degree``)."""
    if not _enabled():
        return
    reg = get_registry()
    reg.gauge_set(M_OVERLAP_AUTO_DEGREE, degree)
    reg.gauge_set(M_OVERLAP_MAKESPAN, modeled_makespan_s)


def record_plan(plan, build_seconds: float | None = None) -> None:
    """One DistAttnPlan built (``parallel/dist_attn.py``): overlap degree,
    stages, per-rank comm rows, the mask-area balance and the kernels'
    row-major step extents."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_PLAN_BUILDS)
    reg.gauge_set(M_PLAN_OVERLAP_DEGREE, plan.overlap_degree)
    reg.gauge_set(M_PLAN_NUM_STAGES, len(plan.stages))
    reg.gauge_set(M_PLAN_TOTAL_AREA, plan.total_area)
    reg.gauge_set(M_PLAN_MAX_RANK_AREA, plan.max_rank_area)
    reg.gauge_set(M_PLAN_AREA_IMBALANCE,
                  plan.max_rank_area / max(plan.total_area / plan.cp_size, 1))
    comm = plan.comm
    reg.clear_metric(M_COMM_SEND_ROWS)  # cp may shrink between plans
    reg.clear_metric(M_COMM_RECV_ROWS)
    for r in range(plan.cp_size):
        reg.gauge_set(M_COMM_SEND_ROWS, comm.send_total[r], rank=r)
        reg.gauge_set(M_COMM_RECV_ROWS, comm.recv_total[r], rank=r)
    fwd = bwd = 0
    for t in plan.table_sets():
        a, b = t.kernel_steps()
        fwd, bwd = max(fwd, a), max(bwd, b)
    reg.gauge_set(M_PLAN_KERNEL_STEPS_FWD, fwd)
    reg.gauge_set(M_PLAN_KERNEL_STEPS_BWD, bwd)
    if build_seconds is not None:
        reg.histogram_observe(H_PLAN_BUILD_S, build_seconds)


def record_runtime_costs(plan, *, num_heads_q: int, num_heads_kv: int, head_dim: int,
                         bytes_per_elt: int, card: str | None) -> None:
    """The keyed API's rows -> bytes and area -> seconds: per-rank comm
    bytes of the K+V payload, the modeled FLOPs, and the calc and comm
    seconds ``utils/cost.py`` prices them at on ``card`` (none for a card
    the table does not know, or for ``card=None``: a CPU key)."""
    if not _enabled():
        return
    from ..utils.cost import get_calc_cost_factor, get_comm_cost_factor

    reg = get_registry()
    comm = plan.comm
    row_bytes = 2 * num_heads_kv * head_dim * bytes_per_elt  # K + V
    reg.clear_metric(M_COMM_BYTES_RANK)  # cp may shrink between plans
    for r in range(plan.cp_size):
        reg.gauge_set(M_COMM_BYTES_RANK, comm.recv_total[r] * row_bytes, rank=r)
    reg.gauge_set(M_MODELED_FLOPS, 4.0 * plan.total_area * num_heads_q * head_dim)
    if card is None:
        return
    try:
        calc_f = get_calc_cost_factor(num_heads_q, head_dim, card)
        comm_f = get_comm_cost_factor(num_heads_kv, head_dim, card, bytes_per_elt=bytes_per_elt)
    except ValueError:  # an unknown card must never take planning down
        return
    reg.gauge_set(M_MODELED_CALC_S, plan.max_rank_area * calc_f)
    reg.gauge_set(M_MODELED_COMM_S, max(comm.recv_total, default=0) * comm_f)


def record_roofline(report) -> None:
    """One mask-aware roofline (``telemetry/roofline.py``): true and
    scheduled FLOPs, the achieved fraction of peak where measured, and the
    gap's fractions, labelled by workload."""
    if not _enabled():
        return
    reg = get_registry()
    w = report.workload
    reg.gauge_set(M_ROOF_PEAK, report.peak_tflops, workload=w)
    reg.gauge_set(M_ROOF_MASK_FLOPS, report.mask_flops, workload=w)
    reg.gauge_set(M_ROOF_SCHED_FLOPS, report.scheduled_flops, workload=w)
    reg.gauge_set(M_ROOF_DENSITY, report.mask_density, workload=w)
    f = report.gap_fractions()
    reg.gauge_set(M_ROOF_DEAD_FRAC, f["dead_steps"], workload=w)
    reg.gauge_set(M_ROOF_PARTIAL_FRAC, f["partial_tile"], workload=w)
    reg.gauge_set(M_ROOF_MASKED_FRAC, f["masked_overcompute"], workload=w)
    if report.measured_tflops is not None:
        reg.gauge_set(M_ROOF_ACHIEVED, report.measured_tflops, workload=w)
        reg.gauge_set(M_ROOF_EFFICIENCY, report.efficiency, workload=w)
    else:
        # a measurement-less re-record must not pair an earlier run's
        # achieved rate with this run's fractions
        reg.clear_series(M_ROOF_ACHIEVED, workload=w)
        reg.clear_series(M_ROOF_EFFICIENCY, workload=w)
    _marker_event("roofline", {
        "workload": w,
        "rung": f"{report.block_q}x{report.block_k}x{report.head_block}"
        + (f":{report.grid}" if report.grid != "row_major" else ""),
        "mask_density": report.mask_density,
        "measured_tflops": report.measured_tflops,
        "efficiency": report.efficiency,
        "dominant_waste": report.dominant_waste,
    })


def record_measured_timeline(tl) -> None:
    """One measured stage timeline (``telemetry/timeline.py``): each
    stage's cast and kernel ms beside the prediction, the pipelined and
    serial totals and the overlap efficiency. The stage-labelled series are
    cleared first: a re-profile at another degree leaves no stale stage."""
    if not _enabled():
        return
    reg = get_registry()
    reg.clear_metric(M_TL_COMM_MS)
    reg.clear_metric(M_TL_CALC_MS)
    reg.clear_metric(M_HOP_MS)
    for ht in getattr(tl, "hops", ()):
        reg.gauge_set(M_HOP_MS, ht.ms, hop=ht.hop, axis=ht.axis, stage=ht.stage)
    for st in tl.stages:
        if st.stage != "host":  # the host stage has no cast
            reg.gauge_set(M_TL_COMM_MS, st.comm_ms, stage=st.stage)
        reg.gauge_set(M_TL_CALC_MS, st.calc_ms, stage=st.stage)
    reg.gauge_set(M_TL_MEASURED_TOTAL_MS, tl.measured_total_ms)
    reg.gauge_set(M_TL_SERIAL_MS, tl.serial_total_ms)
    reg.gauge_set(M_TL_EFFICIENCY, tl.overlap_efficiency)
    # clear, then set: a re-profile that could not be priced must not pair
    # fresh measurements with an earlier plan's prediction
    reg.clear_metric(M_TL_PREDICTED_MS)
    reg.clear_metric(M_TL_PRED_ERROR)
    if tl.predicted_total_ms is not None:
        reg.gauge_set(M_TL_PREDICTED_MS, tl.predicted_total_ms)
    if tl.prediction_error_ratio is not None:
        reg.gauge_set(M_TL_PRED_ERROR, tl.prediction_error_ratio)
    _marker_event("measured_timeline", {
        "overlap_degree": tl.overlap_degree,
        "measured_total_ms": tl.measured_total_ms,
        "serial_total_ms": tl.serial_total_ms,
        "overlap_efficiency": tl.overlap_efficiency,
        "predicted_total_ms": tl.predicted_total_ms,
    })


def record_cache_access(hit: bool) -> None:
    """The keyed plan cache (``api/interface.py``): one tick a key
    resolution, under the ``magi_plan_cache_*`` names and the
    ``magi_runtime_cache_*`` ones."""
    if not _enabled():
        return
    reg = get_registry()
    reg.counter_inc(M_CACHE_HITS if hit else M_CACHE_MISSES)
    reg.counter_inc(M_PLAN_CACHE_HITS if hit else M_PLAN_CACHE_MISSES)


def record_plan_cache_eviction(cache: str) -> None:
    """One entry dropped by a bounded plan cache: ``cache`` is ``runtime``
    (the exact-key LRU) or ``fingerprint`` (the bucketed second level)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_PLAN_CACHE_EVICTIONS, cache=cache)


def record_plan_bucket(hit: bool) -> None:
    """One fingerprint lookup after an exact-key miss
    (``MAGI_ATTENTION_PLAN_REUSE=bucket`` only)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_PLAN_BUCKET_HITS if hit else M_PLAN_BUCKET_MISSES)


def record_plan_incremental(patched: bool) -> None:
    """A bucket hit's row maps: ``patched`` when the tail-extend patch
    applied, else rebuilt (both skip the solver)."""
    if not _enabled():
        return
    get_registry().counter_inc(M_PLAN_INCR_PATCHES if patched else M_PLAN_INCR_FALLBACKS)


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------


def telemetry_summary(snapshot: dict | None = None) -> str:
    """Human-readable block of the headline metrics. Works on any
    snapshot dict (defaults to the live registry's)."""
    if snapshot is None:
        snapshot = get_registry().snapshot()
    g = snapshot.get("gauges", {})
    c = snapshot.get("counters", {})

    def fmt(v):
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)

    def series(prefix):
        vals = {
            k: v for k, v in g.items() if k.startswith(prefix + "{")
        }
        # (len, str) orders rank=2 before rank=10 without parsing labels
        return [v for _, v in sorted(vals.items(), key=lambda kv: (len(kv[0]), kv[0]))]

    lines = [
        "telemetry summary:",
        f"  plans built: {fmt(c.get(M_PLAN_BUILDS, 0))}  "
        f"dispatch metas: {fmt(c.get(M_DISPATCH_BUILDS, 0))}  "
        f"cache hits/misses: {fmt(c.get(M_CACHE_HITS, 0))}/"
        f"{fmt(c.get(M_CACHE_MISSES, 0))}",
        f"  overlap degree: {fmt(g.get(M_PLAN_OVERLAP_DEGREE))}  "
        f"stages: {fmt(g.get(M_PLAN_NUM_STAGES))}  "
        f"kernel steps fwd/bwd: {fmt(g.get(M_PLAN_KERNEL_STEPS_FWD))}/"
        f"{fmt(g.get(M_PLAN_KERNEL_STEPS_BWD))}",
        f"  area imbalance: {fmt(g.get(M_PLAN_AREA_IMBALANCE))}  "
        f"token imbalance: {fmt(g.get(M_DISPATCH_TOKEN_IMBALANCE))}",
        f"  comm recv rows/rank: {[int(v) for v in series(M_COMM_RECV_ROWS)]}",
        f"  comm bytes/rank: {[int(v) for v in series(M_COMM_BYTES_RANK)]}",
    ]
    impl_choice = [k for k in g if k.startswith(M_COMM_IMPL_CHOICE + "{")]
    if impl_choice or g.get(M_COMM_SCHEDULED_ROWS) is not None:
        lines.append(
            f"  comm impl: {impl_choice[0][len(M_COMM_IMPL_CHOICE):] if impl_choice else '-'}  "
            f"scheduled rows/rank {fmt(g.get(M_COMM_SCHEDULED_ROWS))} "
            f"(legacy padded {fmt(g.get(M_COMM_PADDED_ROWS))})  "
            f"true rows total {fmt(g.get(M_COMM_TRUE_ROWS))}"
        )
    lines += [
        f"  modeled flops: {fmt(g.get(M_MODELED_FLOPS))}  "
        f"calc s: {fmt(g.get(M_MODELED_CALC_S))}  "
        f"comm s: {fmt(g.get(M_MODELED_COMM_S))}",
    ]
    choice = [
        k for k in g if k.startswith(M_AUTOTUNE_CHOICE + "{")
    ]
    if choice:
        hits = sum(
            v for k, v in c.items()
            if k.startswith(M_AUTOTUNE_CACHE_HITS)
        )
        lines.append(
            f"  autotune: {choice[0][len(M_AUTOTUNE_CHOICE):]} "
            f"predicted {fmt(g.get(M_AUTOTUNE_PREDICTED_MS))} ms  "
            f"cache hits/misses: {fmt(hits)}/"
            f"{fmt(c.get(M_AUTOTUNE_CACHE_MISSES, 0))}"
        )
    # one line per profiled workload: achieved % of peak + the dead-step
    # share of the gap (the satellite's headline pair). Keyed on the
    # peak gauge, which record_roofline ALWAYS sets — a static analysis
    # (no measurement, so no efficiency gauge) still gets its line
    roof_keys = [k for k in g if k.startswith(M_ROOF_PEAK + "{")]
    if g.get(M_ROOF_PEAK) is not None:
        roof_keys.append(M_ROOF_PEAK)
    for key in sorted(roof_keys):
        labels = key[len(M_ROOF_PEAK):]
        eff = g.get(M_ROOF_EFFICIENCY + labels)
        achieved = (
            f"achieved {eff:.1%} of" if eff is not None else "modeled vs"
        )
        lines.append(
            f"  roofline probe{labels or ''}: {achieved} "
            f"{fmt(g.get(key))} TF/s peak "
            f"({fmt(g.get(M_ROOF_ACHIEVED + labels))} TF/s), "
            f"dead-step fraction "
            f"{fmt(g.get(M_ROOF_DEAD_FRAC + labels))}, "
            f"density {fmt(g.get(M_ROOF_DENSITY + labels))}"
        )
    if g.get(M_TL_MEASURED_TOTAL_MS) is not None:
        lines.append(
            f"  measured overlap: e2e {fmt(g.get(M_TL_MEASURED_TOTAL_MS))} ms"
            f"  serial {fmt(g.get(M_TL_SERIAL_MS))} ms"
            f"  efficiency {fmt(g.get(M_TL_EFFICIENCY))}"
            f"  predicted {fmt(g.get(M_TL_PREDICTED_MS))} ms"
        )
    if c.get(M_DECODE_STEPS):
        lines.append(
            f"  decode: steps {fmt(c.get(M_DECODE_STEPS))}  "
            f"tokens {fmt(c.get(M_DECODE_TOKENS))}  "
            f"batch {fmt(g.get(M_DECODE_BATCH))}  "
            f"splits {fmt(g.get(M_DECODE_SPLITS))}  "
            f"max len {fmt(g.get(M_DECODE_MAX_SEQ_LEN))}"
        )
    if g.get(M_KVCACHE_PAGES_TOTAL) is not None:
        lines.append(
            f"  kv cache: {fmt(g.get(M_KVCACHE_PAGES_USED))}/"
            f"{fmt(g.get(M_KVCACHE_PAGES_TOTAL))} pages "
            f"({fmt(g.get(M_KVCACHE_OCCUPANCY))} occupancy)  "
            f"active seqs {fmt(g.get(M_KVCACHE_ACTIVE_SEQS))}  "
            f"page size {fmt(g.get(M_KVCACHE_PAGE_SIZE))}  "
            f"prefill tokens {fmt(c.get(M_PREFILL_TOKENS, 0))}"
        )
    # program observability: builds by label + the plan
    # solver's saved-ms credit, when any compile was attributed
    compile_keys = [
        k for k in c if k.startswith(M_COMPILE_TOTAL + "{")
    ]
    if compile_keys:
        total_compiles = sum(c[k] for k in compile_keys)
        lines.append(
            f"  programs: {len(compile_keys)} labels, "
            f"{fmt(total_compiles)} builds  "
            f"libraries built {fmt(g.get(M_JIT_CACHE_ENTRIES))}  "
            f"solver ms saved "
            f"{fmt(c.get(M_SOLVER_MS_SAVED, 0))}"
        )
    # one line per compared program: predicted-vs-measured io bytes +
    # the honest unattributed temp residual
    from .registry import series_key

    for key in sorted(k for k in g if k.startswith(M_MEM_DELTA + "{")):
        labels = key[len(M_MEM_DELTA):]
        prog = labels[len("{program="):-1]
        pred = g.get(series_key(
            M_MEM_PREDICTED, {"ledger": prog, "phase": "total"}
        ))
        lines.append(
            f"  memory probe{labels}: predicted {fmt(pred)} B, "
            f"io delta {fmt(g.get(key))}, unattributed "
            f"{fmt(g.get(M_MEM_UNATTRIBUTED + labels))} B temp"
        )
    return "\n".join(lines)
