"""Environment-variable flags read by the port.

Same ``MAGI_ATTENTION_*`` names and defaults as the JAX package's
``env.py`` for the accessors this slice reads; the TPU-only flags
(compile caches, generation, SMEM budgets) have no counterpart here.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def mask_skip_disabled() -> bool:
    """Debug: force the diagnostic needs-mask flag (``RUN_FIELDS`` slot 6)
    to 1 on every entry in ``ops/block_meta.py``. The kernels mask every
    tile unconditionally, so this affects plan diagnostics only. Any
    non-empty value sets it."""
    return bool(os.environ.get("MAGI_DISABLE_MASK_SKIP"))


def block_q() -> int | None:
    """Explicitly-set flex tile height, or None when unset: the flex
    forward then takes its Hopper tile table (``ops/flex_attn.py``)."""
    v = os.environ.get("MAGI_ATTENTION_BLOCK_Q")
    return int(v) if v else None


def block_k() -> int | None:
    """Explicitly-set flex tile width, or None (the Hopper tile table)."""
    v = os.environ.get("MAGI_ATTENTION_BLOCK_K")
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
    through ``resolve_num_splits``'s Hopper rule."""
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
    v = os.environ.get("MAGI_ATTENTION_HEAD_BLOCK")
    return int(v) if v else None


AUTOTUNE_MODES = ("off", "model", "measure")


def autotune_mode() -> str:
    """Kernel blocking mode of the model harness
    (``models/_common.resolve_harness_blocking``), validated here: 'off' =
    the legacy harness blocking (the env's tile, head_block 1 unless
    ``MAGI_ATTENTION_HEAD_BLOCK`` is set); 'model' (default) and 'measure'
    both take the port's Hopper rule (``ops.auto_kernel_config`` on the
    row-major grid). The reference's modes rank its rungs with a TPU cost
    model or TPU timings; neither carries over to Hopper, so the port reads
    only 'off'."""
    v = _env_str("MAGI_ATTENTION_AUTOTUNE", "model").strip().lower()
    if v not in AUTOTUNE_MODES:
        raise ValueError(f"MAGI_ATTENTION_AUTOTUNE={v!r} must be one of {AUTOTUNE_MODES}")
    return v


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
