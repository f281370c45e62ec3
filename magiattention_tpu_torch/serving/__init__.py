"""Serving: paged KV cache, split-KV decode, the continuous-batching engine.

- :mod:`.kv_cache`    — page pool, block tables, in-place append/gather,
  host-side :class:`PageAllocator`
- :mod:`.decode_attn` — split-KV decode (the ``paged_decode`` kernel on
  CUDA, its plain version on the CPU)
- :mod:`.prefix`      — the shared-prefix trie :class:`PrefixCache`,
  cascade decode (``plan_cascade_groups``, ``cascade_decode_attn``)
- :mod:`.engine`      — :class:`DecodeBatch`, ``magi_attn_decode``,
  ``prefill_into_cache`` / ``continue_prefill_into_cache``, the
  :class:`ServingEngine`
"""

from .decode_attn import (  # noqa: F401
    DecodeParams,
    decode_attn_paged,
    decode_partials_for_tables,
    decode_reference,
    resolve_num_splits,
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
    append_kv,
    assign_block_table,
    copy_page,
    gather_kv,
    make_paged_kv_cache,
    reset_slot,
    swap_block_table_page,
    write_prefill_kv,
)
from .prefix import (  # noqa: F401
    CascadeGroup,
    PrefixCache,
    PrefixMatch,
    cascade_decode_attn,
    plan_cascade_groups,
)
