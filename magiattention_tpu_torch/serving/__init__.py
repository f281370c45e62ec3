"""Serving: paged KV cache, split-KV decode, the continuous-batching engine.

- :mod:`.kv_cache`    — page pool, block tables, in-place append/gather,
  host-side :class:`PageAllocator`
- :mod:`.decode_attn` — split-KV decode (the ``paged_decode`` kernel on
  CUDA, its plain version on the CPU)
- :mod:`.prefix`      — the shared-prefix trie :class:`PrefixCache`,
  cascade decode (``plan_cascade_groups``, ``cascade_decode_attn``)
- :mod:`.cp_decode`   — cross-rank LSE merge of decode partials for
  cp-sharded KV histories (cp = 1 stays local)
- :mod:`.engine`      — :class:`DecodeBatch`, ``magi_attn_decode``,
  ``prefill_into_cache`` / ``continue_prefill_into_cache``, the
  :class:`ServingEngine`
- :mod:`.scheduler`   — the token-budget chunked-prefill :class:`Scheduler`
- :mod:`.unified_tick` — a whole tick's prefill chunks and decode steps as
  rows of one ``paged_decode`` launch (:func:`unified_tick_attn`), behind
  ``MAGI_ATTENTION_UNIFIED_TICK``
- :mod:`.distributed` — disaggregated serving over a device list: TP decode
  over a KV-head-sharded pool (:func:`tp_decode_attn`), the
  :class:`TieredEngine` (prefill tier, page streams, decode replicas) and
  the :class:`TieredScheduler`, behind ``MAGI_ATTENTION_SERVING_MESH``
- :mod:`.plan_probe` — :class:`PlanReuseProbe`, the scheduler's request
  shapes through the keyed planner
"""

from .cp_decode import cp_decode_attn, cp_merge_partials  # noqa: F401
from .decode_attn import (  # noqa: F401
    DecodeParams,
    decode_attn_paged,
    decode_partials_for_tables,
    decode_reference,
    resolve_num_splits,
)
from .distributed import (  # noqa: F401
    DecodeReplica,
    DecodeTierFault,
    PendingStream,
    StreamReport,
    TieredEngine,
    TieredScheduler,
    gather_pages,
    pages_digest,
    tp_decode_attn,
)
from .engine import (  # noqa: F401
    AdmissionResult,
    DecodeBatch,
    ServingEngine,
    continue_prefill_into_cache,
    magi_attn_decode,
    prefill_into_cache,
)
from .kv_cache import (  # noqa: F401
    InvalidFreeError,
    PageAllocator,
    PageAllocatorError,
    PagedKVCache,
    PageShareError,
    ShardedPagedKVCache,
    append_kv,
    assign_block_table,
    copy_page,
    gather_kv,
    make_paged_kv_cache,
    reset_slot,
    shard_kv_cache,
    swap_block_table_page,
    write_prefill_kv,
)
from .plan_probe import PlanProbeStats, PlanReuseProbe  # noqa: F401
from .prefix import (  # noqa: F401
    CascadeGroup,
    PrefixCache,
    PrefixMatch,
    cascade_decode_attn,
    plan_cascade_groups,
)
from .scheduler import Request, RequestState, Scheduler, StepReport  # noqa: F401
from .unified_tick import demux_tick, resolve_tick_splits, unified_tick_attn  # noqa: F401
