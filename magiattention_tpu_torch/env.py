"""Environment-variable flags read by the port.

Same ``MAGI_ATTENTION_*`` names and defaults as the JAX package's
``env.py`` for the accessors the port reads; the TPU-only flags
(compile caches, generation, SMEM budgets) have no counterpart here.
"""

from __future__ import annotations

import os

# flags are read through the encoded mapping ``os.environ`` keeps and writes:
# ``os.environ.get`` raises and catches a KeyError for each unset name, a
# microsecond or two apiece, and a keyed call or a flex call reads dozens
_ENV_DATA = os.environ._data
_ENCODED: dict = {}


def _encoded(name: str):
    key = _ENCODED.get(name)
    if key is None:
        key = _ENCODED[name] = os.environ.encodekey(name)
    return key


def _get(name: str, default=None):
    """``os.environ.get(name, default)``."""
    v = _ENV_DATA.get(_encoded(name))
    return default if v is None else os.environ.decodevalue(v)


def raw_flags(names) -> tuple:
    """The encoded values of ``names`` (None where unset), as a memo key
    reads them."""
    return tuple(_ENV_DATA.get(_encoded(n)) for n in names)


def _env_int(name: str, default: int) -> int:
    v = _get(name)
    return int(v) if v is not None else default


def _env_str(name: str, default: str) -> str:
    return _get(name, default)


def _env_float(name: str, default: float) -> float:
    v = _get(name)
    return float(v) if v is not None else default


def log_level() -> str:
    """Level of the ``magiattention_tpu_torch`` logger tree
    (``MAGI_ATTENTION_LOG_LEVEL``), applied by
    ``telemetry.logger.configure_logging``."""
    return _env_str("MAGI_ATTENTION_LOG_LEVEL", "WARNING")


def log_level_explicit() -> bool:
    """Whether ``MAGI_ATTENTION_LOG_LEVEL`` is set at all: only then does the
    logging config claim the logger tree (an embedder's own
    ``logging.basicConfig`` keeps control otherwise)."""
    return "MAGI_ATTENTION_LOG_LEVEL" in os.environ


# -- telemetry (the same names, defaults and validation as the JAX package's
# env.py; observability only, so none of them is in flags_fingerprint) ----------


def is_telemetry_enabled() -> bool:
    """Whether the telemetry layer records (``MAGI_ATTENTION_TELEMETRY``;
    ``telemetry.set_enabled`` overrides it). Off by default: every hook is
    then one predicate call."""
    return _env_bool("MAGI_ATTENTION_TELEMETRY")


def telemetry_ring_size() -> int:
    """Capacity of the host span ring (``telemetry/events.py``): the most
    recent N spans are kept."""
    return _env_int("MAGI_ATTENTION_TELEMETRY_RING_SIZE", 4096)


def trace_dir() -> str:
    """Where the flight recorder writes its dumps (``telemetry/trace.py``)."""
    return _env_str("MAGI_ATTENTION_TRACE_DIR", "./magi_attention_trace")


def metrics_port() -> int:
    """TCP port of the Prometheus endpoint (``telemetry/exposition.py``):
    0 (the default) starts no server; a port starts one stdlib HTTP thread
    per process at the first ``ServingEngine`` (``GET /metrics``,
    ``/metrics.json``, ``/healthz``)."""
    v = _env_int("MAGI_ATTENTION_METRICS_PORT", 0)
    if v < 0 or v > 65535:
        raise ValueError(
            f"MAGI_ATTENTION_METRICS_PORT={v} must be 0 (off) or a valid "
            "TCP port"
        )
    return v


def flight_recorder_depth() -> int:
    """Tick capacity of the serving flight recorder (``telemetry/trace.py``),
    on whatever the telemetry flag says; 0 disables it."""
    v = _env_int("MAGI_ATTENTION_FLIGHT_RECORDER_DEPTH", 64)
    if v < 0:
        raise ValueError(
            f"MAGI_ATTENTION_FLIGHT_RECORDER_DEPTH={v} must be >= 0 "
            "(0 disables the recorder)"
        )
    return v


def mem_pressure_threshold() -> float:
    """Free-page fraction under which the scheduler's
    ``MemPressureWatcher`` counts a tick as pressured (8 such ticks in a
    row dump ``mem_pressure``); 0.0 (the default) disables it."""
    v = _env_float("MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD", 0.0)
    if not 0.0 <= v <= 1.0:
        raise ValueError(
            f"MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD={v} must be in "
            "[0, 1] (a free-page fraction; 0 disables)"
        )
    return v


def recompile_storm_threshold() -> int:
    """Builds of one program label inside the compile tracker's 30 s window
    that dump ``recompile_storm`` (``telemetry/compile.py``); 0 (the
    default) disables the detector."""
    v = _env_int("MAGI_ATTENTION_RECOMPILE_STORM_THRESHOLD", 0)
    if v < 0:
        raise ValueError(
            f"MAGI_ATTENTION_RECOMPILE_STORM_THRESHOLD={v} must be >= 0 "
            "(compiles of one label per window; 0 disables)"
        )
    return v


def shadow_sample_rate() -> int:
    """Every Nth decode batch is recomputed by the plain f32 decode and
    scored against the production output (``ServingEngine``'s shadow
    check); 0 (the default) disables it."""
    v = _env_int("MAGI_ATTENTION_SHADOW_SAMPLE_RATE", 0)
    if v < 0:
        raise ValueError(
            f"MAGI_ATTENTION_SHADOW_SAMPLE_RATE={v} must be >= 0 "
            "(re-check every Nth decode batch; 0 disables)"
        )
    return v


def mask_skip_disabled() -> bool:
    """Debug: force the diagnostic needs-mask flag (``RUN_FIELDS`` slot 6)
    to 1 on every entry in ``ops/block_meta.py``. The kernels mask every
    tile unconditionally, so this affects plan diagnostics only. Any
    non-empty value sets it."""
    return bool(_get("MAGI_DISABLE_MASK_SKIP"))


def block_q() -> int | None:
    """Explicitly-set flex tile height, or None when unset: the flex
    forward then takes its Hopper tile table (``ops/flex_attn.py``)."""
    v = _get("MAGI_ATTENTION_BLOCK_Q")
    return int(v) if v else None


def block_k() -> int | None:
    """Explicitly-set flex tile width, or None (the Hopper tile table)."""
    v = _get("MAGI_ATTENTION_BLOCK_K")
    return int(v) if v else None


def page_size() -> int:
    """KV-cache page size in tokens (``serving/kv_cache.py``): the unit of
    paged allocation and the decode kernel's page granularity."""
    return _env_int("MAGI_ATTENTION_PAGE_SIZE", 128)


def prefill_chunk() -> int | None:
    """Chunked-prefill chunk size in tokens (``serving/engine.py``):
    prompts longer than this are prefilled in chunk-sized steps, each
    attending to the already-written cache. Unset/0/'off' (default) =
    single-shot prefill."""
    v = _env_str("MAGI_ATTENTION_PREFILL_CHUNK", "0").strip().lower()
    if v in ("", "0", "off", "none"):
        return None
    iv = int(v)
    if iv < 1:
        raise ValueError(
            f"MAGI_ATTENTION_PREFILL_CHUNK={v!r} must be a positive token "
            "count (or 0/off to disable chunking)"
        )
    return iv


def decode_splits() -> int | None:
    """Split-KV decode split count (``serving/decode_attn.py``): an integer
    pins the number of KV splits per sequence; 'auto' (default) resolves
    through the split tuner (``tuning.select_decode_splits``)."""
    v = _env_str("MAGI_ATTENTION_DECODE_SPLITS", "auto").strip().lower()
    return None if v in ("", "auto") else int(v)


def grid_override() -> str | None:
    """Pinned flex-kernel grid, or None (auto: ``auto_kernel_config``'s
    density rule). 'row_major' keeps the (heads, q blocks) walk, 'sparse'
    forces the compact sparse-grid kernels (``ops/flex_attn.py``
    GRID_KINDS)."""
    v = _env_str("MAGI_ATTENTION_GRID", "auto").strip().lower()
    if v in ("", "auto"):
        return None
    if v not in ("row_major", "sparse"):
        raise ValueError(
            f"MAGI_ATTENTION_GRID={v!r} must be 'auto', 'row_major', or 'sparse'"
        )
    return v


def head_block_override() -> int | None:
    """Explicitly-set head_block (q heads per kernel work item), or None
    when the flag is unset."""
    v = _get("MAGI_ATTENTION_HEAD_BLOCK")
    return int(v) if v else None


AUTOTUNE_MODES = ("off", "model", "measure")


def autotune_mode() -> str:
    """Kernel choice mode (``tuning/autotuner.py``), validated here, as in
    the JAX package: 'off' = the static rule (``ops.flex_attn.
    _static_block_config``: the Hopper tile, head_block G, the row-major
    grid; the model harness's legacy blocking); 'model' (default) = the
    cost model's ranking of the candidates (``tuning/cost_model.py``, its
    fees fitted on the H100), cached by workload fingerprint; 'measure' =
    the model's top candidates timed on the caller's own operands on the
    card, the winner cached in memory and on disk
    (:func:`autotune_cache_dir`). A caller that cannot time (the keyed cp
    API, a pinned head_block) takes 'model' there."""
    v = _env_str("MAGI_ATTENTION_AUTOTUNE", "model").strip().lower()
    if v not in AUTOTUNE_MODES:
        raise ValueError(f"MAGI_ATTENTION_AUTOTUNE={v!r} must be one of {AUTOTUNE_MODES}")
    return v


def autotune_cache_dir() -> str:
    """Disk directory backing the tuning cache ('' = the process's memory
    only): one JSON file per workload fingerprint
    (``tuning/cache.py``)."""
    return _env_str("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR", "")


CASCADE_MODES = ("auto", "on", "off")


def cascade_mode() -> str:
    """Cascade (two-level shared-prefix) decode attention mode
    (``serving/prefix.py``), validated here: 'auto' (default) = cascade
    whenever two or more decode-batch members share a resident full-page
    prefix, flat split-KV otherwise; 'on' = cascade for every
    prefix-carrying sequence, singleton groups included; 'off' = always
    the flat path (prefix pages are still shared for memory). The paths
    agree within the dtype's tolerance, so the mode is a performance
    choice, not a semantic one."""
    v = _env_str("MAGI_ATTENTION_CASCADE", "auto").strip().lower()
    if v not in CASCADE_MODES:
        raise ValueError(f"MAGI_ATTENTION_CASCADE={v!r} must be one of {CASCADE_MODES}")
    return v



UNIFIED_TICK_MODES = ("auto", "on", "off")


def unified_tick_mode() -> str:
    """Unified serving-tick mode of ``serving/scheduler.py``
    (``MAGI_ATTENTION_UNIFIED_TICK``), validated here:

    - ``off`` (default): the per-request path, one flex launch per
      prefilling request and one decode call per tick;
    - ``auto``: the whole tick as one ``paged_decode`` launch
      (``ServingEngine.unified_tick``) whenever the per-request path would
      launch two or more programs (a decode group beside a prefill chunk,
      or two chunks);
    - ``on``: every tick with attention work takes the one launch.

    Part of ``api/interface.py::flags_fingerprint``, as the JAX package
    folds it into its key."""
    v = _env_str("MAGI_ATTENTION_UNIFIED_TICK", "off").strip().lower()
    if v not in UNIFIED_TICK_MODES:
        raise ValueError(f"MAGI_ATTENTION_UNIFIED_TICK={v!r} must be one of {UNIFIED_TICK_MODES}")
    return v

# -- serving topology (serving/distributed.py) ------------------------------------

SERVING_TIERS = ("prefill", "decode")


def serving_mesh() -> dict | None:
    """Disaggregated-serving layout (``serving/distributed.py``), validated
    here: ``MAGI_ATTENTION_SERVING_MESH`` names how many devices each tier
    owns, e.g. ``"prefill=1,decode=4"`` (four one-device decode replicas)
    or ``"prefill=2,decode=2x2"`` (decode = 2 data-parallel replicas x
    tensor-parallel degree 2). Unset/'' (the default) returns None: one
    engine, the :class:`~.serving.engine.ServingEngine` path.

    Returns ``{"prefill": P, "decode_dp": D, "decode_tp": T}``. Whether the
    device list is long enough is checked where the tiers are built. Not
    in ``flags_fingerprint`` (serving-host topology only), as in the JAX
    package."""
    v = _env_str("MAGI_ATTENTION_SERVING_MESH", "").strip().lower()
    if not v:
        return None
    out = {"prefill": 1, "decode_dp": 1, "decode_tp": 1}
    seen = set()
    for item in v.split(","):
        tier, eq, count = item.partition("=")
        tier = tier.strip()
        if not eq or tier not in SERVING_TIERS:
            raise ValueError(f"MAGI_ATTENTION_SERVING_MESH: bad clause {item!r} "
                             f"(want tier=count with tier in {SERVING_TIERS})")
        if tier in seen:
            raise ValueError(f"MAGI_ATTENTION_SERVING_MESH: duplicate tier {tier!r}")
        seen.add(tier)
        count = count.strip()
        try:
            if tier == "decode" and "x" in count:
                dp, _, tp = count.partition("x")
                out["decode_dp"], out["decode_tp"] = int(dp), int(tp)
            elif tier == "decode":
                out["decode_dp"] = int(count)
            else:
                out[tier] = int(count)
        except ValueError:
            raise ValueError(f"MAGI_ATTENTION_SERVING_MESH: {item!r} count must be an integer "
                             "(decode also takes DxT for dp x tp)") from None
    if out["prefill"] < 1 or out["decode_dp"] < 1 or out["decode_tp"] < 1:
        raise ValueError(f"MAGI_ATTENTION_SERVING_MESH={v!r}: every tier count must be >= 1")
    return out


def tier_token_budget(tier: str) -> int:
    """Per-tier token budget of one ``TieredScheduler`` tick
    (``MAGI_ATTENTION_TIER_BUDGET_PREFILL`` / ``_DECODE``, default 256;
    constructor arguments win). Decode counts one token per decoding
    sequence, prefill a chunk's rows. Not in ``flags_fingerprint``."""
    if tier not in SERVING_TIERS:
        raise ValueError(f"tier_token_budget: unknown tier {tier!r}")
    v = _env_int(f"MAGI_ATTENTION_TIER_BUDGET_{tier.upper()}", 256)
    if v < 1:
        raise ValueError(f"MAGI_ATTENTION_TIER_BUDGET_{tier.upper()}={v} must be a positive "
                         "token count")
    return v


# -- context parallelism (the same names, defaults and validation as the JAX
# package's env.py) -------------------------------------------------------------


def _env_bool(name: str, default: bool = False) -> bool:
    v = _get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


GROUP_COLL_IMPLS = ("a2a", "hops", "auto")


def group_coll_impl() -> str:
    """Group-collective realization (``comm/group_collective.py``):
    'a2a' = one globally-padded ``all_to_all_single`` per cast, 'hops' =
    hop-scheduled exact-size exchanges (one ``batch_isend_irecv`` per hop;
    hop k pads only to that hop's max pair size, zero-volume hops are
    skipped), 'auto' (default) = pick per collective by predicted wire
    volume at plan-build time. Validated at use (``GroupCollectiveMeta.build``)."""
    return _env_str("MAGI_ATTENTION_GROUP_COLL_IMPL", "auto").strip().lower()


def comm_pad_to() -> int:
    """Row-count rung of the group-collective buffers
    (``MAGI_ATTENTION_COMM_PAD_TO``): every padded send/recv extent is
    rounded up to a multiple of this power of two."""
    v = _env_int("MAGI_ATTENTION_COMM_PAD_TO", 8)
    if v < 1 or (v & (v - 1)) != 0:
        raise ValueError(f"MAGI_ATTENTION_COMM_PAD_TO={v} must be a power of two >= 1")
    return v


def overlap_degree_default() -> int | None:
    """Default multi-stage-overlap degree when no overlap config is given:
    an integer (default 0: one merged cast and one kernel call), or 'auto'
    for the degree=None cost-model search."""
    v = _env_str("MAGI_ATTENTION_OVERLAP_DEGREE", "0").strip().lower()
    return None if v == "auto" else int(v)


def min_stage_rows() -> int:
    return _env_int("MAGI_ATTENTION_MIN_STAGE_ROWS", 512)


def dynamic_max_degree() -> int:
    """Auto-degree search cap (``OverlapConfig.dynamic_max_degree``)."""
    return _env_int("MAGI_ATTENTION_DYNAMIC_MAX_DEGREE", 8)


def is_forward_high_precision_reduce() -> bool:
    """Keep the staged out/lse merge accumulator in fp32
    (``MAGI_ATTENTION_FORWARD_HIGH_PRECISION_REDUCE``; default on)."""
    return _env_bool("MAGI_ATTENTION_FORWARD_HIGH_PRECISION_REDUCE", True)


def is_backward_high_precision_reduce() -> bool:
    """Carry the KV cast payload in fp32 so that the dK/dV reduce of its
    backward accumulates in fp32, at twice the comm volume
    (``MAGI_ATTENTION_BACKWARD_HIGH_PRECISION_REDUCE``; default off)."""
    return _env_bool("MAGI_ATTENTION_BACKWARD_HIGH_PRECISION_REDUCE", False)


def min_chunks_per_rank() -> int:
    """Auto chunk size of the keyed API: total / (this x cp), floored to
    128 (``MAGI_ATTENTION_MIN_CHUNKS_PER_RANK``)."""
    return _env_int("MAGI_ATTENTION_MIN_CHUNKS_PER_RANK", 8)


def runtime_dict_size() -> int:
    """LRU capacity of the keyed API's runtime cache
    (``MAGI_ATTENTION_RUNTIME_DICT_SIZE``)."""
    return _env_int("MAGI_ATTENTION_RUNTIME_DICT_SIZE", 100)


# -- flags that pick a planner or check its inputs (the same names as the JAX
# package's; the keyed API honours or refuses each one, never ignores it) -------


def is_qo_comm_enable() -> bool:
    """Route ``magi_attn_flex_key`` through the qo-comm runtime
    (``parallel/qo_comm.py``: a dynamic partition of the attention plane,
    Q/O moving as well as K/V; ``MAGI_ATTENTION_QO_COMM``, default off).
    Refused with hierarchical comm and with an uneven shard
    (``api/interface.py::check_flag_comb``)."""
    return _env_bool("MAGI_ATTENTION_QO_COMM", False)


def is_sanity_check_enabled() -> bool:
    """Check a key's slices for overlapping (q, k) coverage before planning
    (``common/sanity.py``; ``MAGI_ATTENTION_SANITY_CHECK``, default off)."""
    return _env_bool("MAGI_ATTENTION_SANITY_CHECK", False)


def is_deterministic_mode_enabled() -> bool:
    """``MAGI_ATTENTION_DETERMINISTIC_MODE`` (default off), read as the JAX
    package reads it. The port's kernels are deterministic by construction
    (a fixed walk and merge order, no atomics), so the flag changes no
    result; it is keyed in ``flags_fingerprint`` as in the JAX package."""
    return _env_bool("MAGI_ATTENTION_DETERMINISTIC_MODE", False)


def is_auto_range_merge_enable() -> bool:
    """Merge duplicate slices and the overlapping k-ranges of FULL slices
    before planning (``ops/range_merge.py``; ``MAGI_ATTENTION_AUTO_RANGE_MERGE``,
    default off): the keyed API merges before it keys the mask,
    ``flex_flash_attn_func`` before it builds its tables."""
    return _env_bool("MAGI_ATTENTION_AUTO_RANGE_MERGE", False)


def is_hierarchical_comm_enable() -> bool:
    """Two-level (inter, intra) group collectives
    (``MAGI_ATTENTION_HIERARCHICAL_COMM``, default off). The layout comes
    from the cp group (``comm.make_hier_cp_groups``); with a flat group the
    keyed API raises (``api/interface.py::check_flag_comb``)."""
    return _env_bool("MAGI_ATTENTION_HIERARCHICAL_COMM", False)


PLAN_REUSE_MODES = ("off", "bucket")


def plan_reuse_mode() -> str:
    """Fingerprint-bucketed plan reuse (``meta/plan_fingerprint.py``;
    ``MAGI_ATTENTION_PLAN_REUSE``, validated here):

    - ``off`` (default): every new mask pays the full host solve;
    - ``bucket``: on an exact-key miss, ``magi_attn_flex_key`` /
      ``magi_attn_varlen_key`` canonicalise the mask onto length buckets
      and look its fingerprint up in a second-level cache; a hit serves the
      request through a padded-dispatch adapter over the canonical plan
      instead of solving again.

    Part of ``api/interface.py::flags_fingerprint``: for the same mask the
    served runtime differs between the modes (the exact plan or the
    adapter), so a change of mode re-keys."""
    mode = _env_str("MAGI_ATTENTION_PLAN_REUSE", "off").lower()
    if mode not in PLAN_REUSE_MODES:
        raise ValueError(f"MAGI_ATTENTION_PLAN_REUSE={mode!r} is not one of {PLAN_REUSE_MODES}")
    return mode


def plan_cache_size() -> int:
    """Capacity of the fingerprint -> canonical-plan cache
    (``MAGI_ATTENTION_PLAN_CACHE_SIZE``; default: the runtime cache's).
    Not in ``flags_fingerprint``: the capacity changes when an entry is
    evicted, never what a plan holds."""
    size = _env_int("MAGI_ATTENTION_PLAN_CACHE_SIZE", runtime_dict_size())
    if size < 1:
        raise ValueError(f"MAGI_ATTENTION_PLAN_CACHE_SIZE={size} must be >= 1 (the second-level "
                         "plan cache cannot hold zero fingerprints)")
    return size


# -- the kernel backend and the native planner ----------------------------------

KERNEL_BACKENDS = ("cuda", "torch", "torch_online")
# the JAX package's names for the same three paths
_JAX_KERNEL_BACKENDS = {"pallas": "cuda", "jnp": "torch", "jnp_online": "torch_online"}


def kernel_backend() -> str:
    """What runs the flex and decode attention on CUDA tensors
    (``MAGI_ATTENTION_KERNEL_BACKEND``, validated here; the JAX package's
    ``pallas|jnp|jnp_online``):

    - ``cuda`` (default): the hand-written kernels (``csrc/``); CPU tensors
      take their plain versions under the same autograd Function;
    - ``torch``: dense attention over the mask the entry table encodes, in
      plain torch ops on the tensors' device, with a plain autograd backward
      (``ops/flex_attn.py::_fwd_torch``; decode: ``_decode_torch``);
    - ``torch_online``: the same over k blocks with a running (max, sum,
      accumulator) and checkpointed steps (``_fwd_torch_online``; decode as
      ``torch``).

    A JAX name raises with the port's counterpart in the message. Part of
    ``api/interface.py::flags_fingerprint``."""
    v = _env_str("MAGI_ATTENTION_KERNEL_BACKEND", "cuda").strip().lower()
    if v in _JAX_KERNEL_BACKENDS:
        raise ValueError(f"MAGI_ATTENTION_KERNEL_BACKEND={v!r} is the JAX package's name: the "
                         f"port calls it {_JAX_KERNEL_BACKENDS[v]!r} (one of {KERNEL_BACKENDS})")
    if v not in KERNEL_BACKENDS:
        raise ValueError(f"MAGI_ATTENTION_KERNEL_BACKEND={v!r} is not one of {KERNEL_BACKENDS}")
    return v


def cuda_home() -> str:
    """The CUDA toolkit's root (``CUDA_HOME``, default ``/usr/local/cuda``):
    ``csrc`` looks for ``nvcc`` in its ``bin`` when ``nvcc`` is not on
    ``PATH``. Not a ``MAGI_ATTENTION_*`` flag, and not in
    ``flags_fingerprint``: it picks the compiler, and the kernel library's
    name hashes its sources."""
    return _env_str("CUDA_HOME", "/usr/local/cuda")


def is_cpp_backend_enabled() -> bool:
    """Build the host tables with the native entry emitter
    (``csrc/entry_table.cpp``, built with g++ on first use;
    ``MAGI_ATTENTION_CPP_BACKEND``, default on: only 0/false/off/no turns
    it off, as in the JAX package). Off, the Python loops run, which give
    the same bytes. On, a build or load failure raises. Not in
    ``flags_fingerprint``: it changes how a plan is built, not what it
    holds."""
    v = _get("MAGI_ATTENTION_CPP_BACKEND")
    if v is None:
        return True
    return v.strip().lower() not in ("0", "false", "off", "no")


# -- the validate, numerics, guard and chaos flags ---------------------------------
# (the JAX package's accepted values and messages; the port honours guard,
# chaos and numerics, and refuses validate until the sanitizer is ported:
# env.refuse_unhonoured_flags)

VALIDATE_MODES = ("off", "plan", "trace")


def validate_mode() -> str:
    """Plan-sanitizer mode (``MAGI_ATTENTION_VALIDATE``: off | plan |
    trace), validated here, as in the JAX package:

    - ``off`` (default): the plan-build hook is one predicate call;
    - ``plan``: every ``build_dist_attn_plan`` output runs through
      ``analysis.plan_sanity.validate_plan`` before it is returned;
    - ``trace``: ``plan``, then the plan's collective audit
      (``analysis.trace_audit.audit_plan_collectives``: each cast recorded
      dry for every rank and counted against its comm meta).

    A failing check raises ``analysis.PlanValidationError``. Not in
    ``flags_fingerprint``: it never changes what is built, as in the JAX
    package."""
    v = _env_str("MAGI_ATTENTION_VALIDATE", "off").strip().lower()
    if v not in VALIDATE_MODES:
        raise ValueError(f"MAGI_ATTENTION_VALIDATE={v!r} must be one of {VALIDATE_MODES}")
    return v


NUMERICS_MODES = ("off", "census")


def numerics_mode() -> str:
    """Numerics-census mode (``MAGI_ATTENTION_NUMERICS``: off | census),
    validated here:

    - ``off`` (default): no census, no extra tensor op, outputs unchanged;
    - ``census``: each guard site of ``parallel/dist_attn.py`` and
      ``serving/decode_attn.py`` also reduces its partial to a few values
      (max logit, lse min / max, out max-abs) and the merge to its
      softmax-mass deviation, read to the host once a call into the
      ``magi_numerics_*`` series and the flight dumps' ``numerics``
      section (``telemetry/numerics.py``).

    In ``flags_fingerprint``, as in the JAX package."""
    v = _env_str("MAGI_ATTENTION_NUMERICS", "off").strip().lower()
    if v not in NUMERICS_MODES:
        raise ValueError(f"MAGI_ATTENTION_NUMERICS={v!r} must be one of {NUMERICS_MODES}")
    return v


GUARD_MODES = ("off", "check", "repair")


def guard_mode() -> str:
    """Numerical-guard mode (``MAGI_ATTENTION_GUARD``: off | check |
    repair), validated here; ``resilience/guards.py`` reads it. In
    ``flags_fingerprint``."""
    v = _env_str("MAGI_ATTENTION_GUARD", "off").strip().lower()
    if v not in GUARD_MODES:
        raise ValueError(f"MAGI_ATTENTION_GUARD={v!r} must be one of {GUARD_MODES}")
    return v


def chaos_spec() -> str:
    """Raw fault-injection spec (``MAGI_ATTENTION_CHAOS``; '' = off, the
    default), grammar-validated here; ``resilience/chaos.py`` parses it and
    its injectors read it. In ``flags_fingerprint``."""
    v = _env_str("MAGI_ATTENTION_CHAOS", "").strip()
    if v:
        from .resilience.chaos import parse_chaos_spec

        parse_chaos_spec(v)
    return v


def refuse_unhonoured_flags(where: str) -> None:
    """Check the domains of the guard, chaos, numerics and validate flags
    at an entry point (``where``): a value outside a flag's domain raises
    its accessor's ``ValueError``, the JAX package's message. The port
    honours every one of them, so no value inside its domain is refused."""
    guard_mode()
    chaos_spec()
    numerics_mode()
    validate_mode()


def peak_tflops_override() -> float | None:
    """The roofline's peak rate in TF/s (``MAGI_ATTENTION_PEAK_TFLOPS``),
    or None to take the card's row of ``utils/cost.py`` (the CPU's
    placeholder on the CPU). Set it for a card the table does not know, or
    to hold a kernel against a measured ceiling instead of the datasheet.
    Observability only: not in ``flags_fingerprint``."""
    v = _get("MAGI_ATTENTION_PEAK_TFLOPS")
    if v is None or not v.strip():
        return None
    f = float(v)
    if f <= 0:
        raise ValueError(f"MAGI_ATTENTION_PEAK_TFLOPS={v!r} must be a positive TF/s rate")
    return f


def timeline_reps() -> int:
    """Timed reps per piece in the measured-timeline profiler
    (``telemetry/timeline.py``; the median is kept), as in the JAX
    package (``MAGI_ATTENTION_TIMELINE_REPS``, default 5)."""
    return _env_int("MAGI_ATTENTION_TIMELINE_REPS", 5)


def timeline_inner() -> int:
    """Calls per timed rep in the measured-timeline profiler
    (``MAGI_ATTENTION_TIMELINE_INNER``, default 2): a rep's time is their
    mean, which spreads the barrier's fixed cost."""
    return _env_int("MAGI_ATTENTION_TIMELINE_INNER", 2)
