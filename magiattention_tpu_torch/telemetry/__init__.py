"""Runtime telemetry of the port: metrics registry, span events, request
traces, flight recorder, exposition, memory forensics, numerics, and the
device profilers.

The JAX package's ``telemetry/``:

- :mod:`.registry`    — process-global counters/gauges/histograms +
  ``snapshot()``/``dump``
- :mod:`.events`      — the host span ring + Chrome-trace export
- :mod:`.collectors`  — the metric-name catalog and the ``record_*`` hooks
- :mod:`.compile`     — program labels and the build tracker
- :mod:`.trace`       — request-lifecycle traces and the flight recorder
- :mod:`.aggregate`   — cross-rank snapshot and trace merges
- :mod:`.exposition`  — Prometheus text, snapshot deltas, the scrape server
- :mod:`.memory`      — ledgers, measured call memory, pool forensics
- :mod:`.numerics`    — error budgets, divergence reports, the value census
  (``MAGI_ATTENTION_NUMERICS=census``)
- :mod:`.timeline`    — a cp plan's measured stage timeline (CUDA events)
- :mod:`.roofline`    — the mask-aware roofline at the card's peak
- :mod:`.occupancy`   — block-occupancy maps (the sparse grid's input)
- :mod:`.logger`      — ``MAGI_ATTENTION_LOG_LEVEL`` -> logging config

Gating: recording is OFF by default. ``MAGI_ATTENTION_TELEMETRY=1`` (or
``set_enabled(True)``, as tests and benches do) turns it on; while off,
every hook is a single predicate call — no dict churn, no clock reads. No
hook reads a device tensor; the value census, when on, reads one packed
vector a call. The flight recorder and the compile tracker are always on,
as in the JAX package.

Typical use::

    from magiattention_tpu_torch import telemetry
    telemetry.set_enabled(True)
    ... serve ...
    snap = telemetry.snapshot()
    telemetry.dump_metrics("metrics.json")
    telemetry.dump_events("trace.json")   # chrome://tracing format

The bench-history baseline (``baseline``) comes with a benchmark (ROADMAP
A.19).
"""

from __future__ import annotations

from .aggregate import (  # noqa: F401
    aggregate_across_mesh,
    merge_chrome_traces,
    merge_snapshots,
)
from .collectors import (  # noqa: F401
    REQUIRED_ANALYSIS_METRICS,
    REQUIRED_COMPILE_METRICS,
    REQUIRED_DISTSERVE_METRICS,
    REQUIRED_FLEET_METRICS,
    REQUIRED_MEMORY_METRICS,
    REQUIRED_NUMERICS_METRICS,
    REQUIRED_PLAN_CACHE_METRICS,
    REQUIRED_PLAN_METRICS,
    REQUIRED_PREFIX_METRICS,
    REQUIRED_RESILIENCE_METRICS,
    REQUIRED_ROOFLINE_METRICS,
    REQUIRED_SCHED_METRICS,
    REQUIRED_SERVING_METRICS,
    REQUIRED_TIMELINE_METRICS,
    REQUIRED_TRACE_METRICS,
    REQUIRED_VALIDATE_METRICS,
    record_admission,
    record_admission_watermark,
    record_analysis_run,
    record_autotune_cache,
    record_autotune_decision,
    record_autotune_measure_failure,
    record_autotune_measurement,
    record_cache_access,
    record_comm_op,
    record_compile,
    record_decode_step,
    record_degraded_path,
    record_dispatch_meta,
    record_dispatch_solution,
    record_dynamic_solution,
    record_group_collective_build,
    record_guard_check,
    record_guard_repair,
    record_guard_violation,
    record_hbm_sample,
    record_kvcache_state,
    record_memory_comparison,
    record_memory_ledger,
    record_memory_measurement,
    record_measured_timeline,
    record_memory_pool,
    record_numerics_census,
    record_overlap_choice,
    record_page_stream,
    record_plan,
    record_plan_bucket,
    record_plan_cache_eviction,
    record_plan_incremental,
    record_plan_solver,
    record_prefill,
    record_prefix_cow,
    record_prefix_eviction,
    record_prefix_lookup,
    record_prefix_registered,
    record_request_queue_time,
    record_request_token_latency,
    record_request_ttft,
    record_roofline,
    record_runtime_costs,
    record_sched_step,
    record_shadow_check,
    record_stream_queue_depth,
    record_tick_programs,
    record_tier_fault,
    record_tier_state,
    record_tuning_cache_io_error,
    record_validate,
    telemetry_summary,
)
from .compile import (  # noqa: F401
    CompileTracker,
    add_solver_seconds,
    current_program,
    decode_program_label,
    get_compile_tracker,
    prefill_program_label,
    program,
    reset_compile_tracker,
    tick_program_label,
)
from .events import (  # noqa: F401
    EventBuffer,
    get_event_buffer,
    record_event,
    span,
    trace_metadata_events,
)
from .exposition import (  # noqa: F401
    MetricsServer,
    ensure_metrics_server,
    parse_prometheus_text,
    render_prometheus,
    snapshot_delta,
    start_metrics_server,
    stop_metrics_server,
)
from .logger import configure_logging, get_logger  # noqa: F401
from .memory import (  # noqa: F401
    LedgerEntry,
    MemoryComparison,
    MemoryLedger,
    MemPressureWatcher,
    PoolFragmentationMap,
    engine_memory_snapshot,
    fragmentation_map,
    ledger_vs_measured,
    measure_program_memory,
    plan_memory_ledger,
    sample_memory_stats,
    serving_memory_ledger,
    tiered_memory_ledger,
)
from .numerics import (  # noqa: F401
    DEFAULT_BUDGETS,
    DivergenceReport,
    ErrorBudget,
    ErrorBudgetExceeded,
    NumericsCensus,
    assert_within_budget,
    budget_for_dtype,
    census_active,
    census_keys,
    consume_census,
    divergence_report,
    get_numerics_census,
    mass_deviation,
    nudge_ulps,
    pack_census,
    reset_numerics_census,
    site_summary,
    ulp_distance,
)
from .occupancy import BlockOccupancyMap, block_occupancy_map  # noqa: F401
from .roofline import (  # noqa: F401
    CPU_PEAK_TFLOPS,
    RooflineReport,
    StepFees,
    analyze_workload,
    profile_roofline,
    resolve_peak_tflops,
)
from .registry import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    scoped_registry,
    series_key,
)
from .trace import (  # noqa: F401
    FlightRecorder,
    RequestTrace,
    dump_request_traces,
    dump_request_traces_jsonl,
    export_request_traces,
    get_flight_recorder,
    record_request_span,
    request_context,
    request_traces_to_chrome,
    reset_flight_recorder,
    reset_request_traces,
)
from .timeline import (  # noqa: F401
    HopTiming,
    MeasuredTimeline,
    StageTiming,
    profile_key_timeline,
    profile_plan_timeline,
)

# tri-state programmatic override: None -> defer to the env flag
_enabled_override: bool | None = None


def enabled() -> bool:
    """Is telemetry recording on? Programmatic override first, then the
    ``MAGI_ATTENTION_TELEMETRY`` env flag. This is THE gate every hook
    checks; keep it a couple of dict lookups."""
    if _enabled_override is not None:
        return _enabled_override
    from .. import env

    return env.is_telemetry_enabled()


def set_enabled(value: bool | None) -> None:
    """Force telemetry on/off (``True``/``False``) or restore env-flag
    control (``None``)."""
    global _enabled_override
    _enabled_override = value


def snapshot() -> dict:
    """Plain-dict snapshot of the global registry (always available, even
    when disabled — it is then simply empty)."""
    return get_registry().snapshot()


def reset() -> None:
    """Clear the global registry, the span ring buffer, and the
    per-request trace sequence counters."""
    get_registry().reset()
    get_event_buffer().clear()
    reset_request_traces()


def dump_metrics(path: str) -> str:
    """Write the registry snapshot as JSON; returns ``path``."""
    return get_registry().dump(path)


def dump_events(path: str) -> str:
    """Write buffered spans as Chrome trace-event JSON; returns ``path``."""
    return get_event_buffer().dump(path)


__all__ = [
    "BlockOccupancyMap",
    "CPU_PEAK_TFLOPS",
    "CompileTracker",
    "DEFAULT_BUDGETS",
    "DivergenceReport",
    "ErrorBudget",
    "ErrorBudgetExceeded",
    "EventBuffer",
    "FlightRecorder",
    "HopTiming",
    "LedgerEntry",
    "MeasuredTimeline",
    "MemPressureWatcher",
    "MemoryComparison",
    "MemoryLedger",
    "MetricsRegistry",
    "MetricsServer",
    "NumericsCensus",
    "PoolFragmentationMap",
    "REQUIRED_ANALYSIS_METRICS",
    "REQUIRED_COMPILE_METRICS",
    "REQUIRED_DISTSERVE_METRICS",
    "REQUIRED_FLEET_METRICS",
    "REQUIRED_MEMORY_METRICS",
    "REQUIRED_NUMERICS_METRICS",
    "REQUIRED_PLAN_CACHE_METRICS",
    "REQUIRED_PLAN_METRICS",
    "REQUIRED_PREFIX_METRICS",
    "REQUIRED_RESILIENCE_METRICS",
    "REQUIRED_ROOFLINE_METRICS",
    "REQUIRED_SCHED_METRICS",
    "REQUIRED_SERVING_METRICS",
    "REQUIRED_TIMELINE_METRICS",
    "REQUIRED_TRACE_METRICS",
    "REQUIRED_VALIDATE_METRICS",
    "RequestTrace",
    "RooflineReport",
    "StageTiming",
    "StepFees",
    "add_solver_seconds",
    "aggregate_across_mesh",
    "analyze_workload",
    "assert_within_budget",
    "block_occupancy_map",
    "budget_for_dtype",
    "census_active",
    "census_keys",
    "configure_logging",
    "consume_census",
    "current_program",
    "decode_program_label",
    "divergence_report",
    "dump_events",
    "dump_metrics",
    "dump_request_traces",
    "dump_request_traces_jsonl",
    "enabled",
    "engine_memory_snapshot",
    "ensure_metrics_server",
    "export_request_traces",
    "fragmentation_map",
    "get_compile_tracker",
    "get_event_buffer",
    "get_flight_recorder",
    "get_logger",
    "get_numerics_census",
    "get_registry",
    "ledger_vs_measured",
    "mass_deviation",
    "measure_program_memory",
    "merge_chrome_traces",
    "merge_snapshots",
    "nudge_ulps",
    "pack_census",
    "parse_prometheus_text",
    "plan_memory_ledger",
    "prefill_program_label",
    "profile_key_timeline",
    "profile_plan_timeline",
    "profile_roofline",
    "program",
    "record_admission",
    "record_admission_watermark",
    "record_analysis_run",
    "record_autotune_cache",
    "record_autotune_decision",
    "record_autotune_measure_failure",
    "record_autotune_measurement",
    "record_cache_access",
    "record_comm_op",
    "record_compile",
    "record_decode_step",
    "record_degraded_path",
    "record_dispatch_meta",
    "record_dispatch_solution",
    "record_dynamic_solution",
    "record_event",
    "record_group_collective_build",
    "record_guard_check",
    "record_guard_repair",
    "record_guard_violation",
    "record_hbm_sample",
    "record_kvcache_state",
    "record_measured_timeline",
    "record_memory_comparison",
    "record_memory_ledger",
    "record_memory_measurement",
    "record_memory_pool",
    "record_numerics_census",
    "record_overlap_choice",
    "record_page_stream",
    "record_plan",
    "record_plan_bucket",
    "record_plan_cache_eviction",
    "record_plan_incremental",
    "record_plan_solver",
    "record_prefill",
    "record_prefix_cow",
    "record_prefix_eviction",
    "record_prefix_lookup",
    "record_prefix_registered",
    "record_request_queue_time",
    "record_request_span",
    "record_request_token_latency",
    "record_request_ttft",
    "record_roofline",
    "record_runtime_costs",
    "record_sched_step",
    "record_shadow_check",
    "record_stream_queue_depth",
    "record_tick_programs",
    "record_tier_fault",
    "record_tier_state",
    "record_tuning_cache_io_error",
    "record_validate",
    "render_prometheus",
    "request_context",
    "request_traces_to_chrome",
    "reset",
    "reset_compile_tracker",
    "reset_flight_recorder",
    "reset_numerics_census",
    "reset_request_traces",
    "resolve_peak_tflops",
    "sample_memory_stats",
    "scoped_registry",
    "series_key",
    "serving_memory_ledger",
    "set_enabled",
    "site_summary",
    "snapshot",
    "snapshot_delta",
    "span",
    "start_metrics_server",
    "stop_metrics_server",
    "telemetry_summary",
    "tick_program_label",
    "tiered_memory_ledger",
    "trace_metadata_events",
    "ulp_distance",
]
