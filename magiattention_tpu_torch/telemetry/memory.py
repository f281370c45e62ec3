"""Memory observability: the ledger, its measured confirmation, pool forensics.

The JAX package's ``telemetry/memory.py`` on the card's caching allocator:

1. **Static memory ledger** (:func:`plan_memory_ledger` /
   :func:`serving_memory_ledger` / :func:`tiered_memory_ledger`): price a
   ``DistAttnPlan`` or a serving configuration from the structures that
   already exist — per-stage comm buffers from the comm meta's
   ``scheduled_rows_per_rank``, kernel partials and LSE scratch per stage,
   page-pool bytes split live / trie-resident / free (a CoW-shared page
   counted once), decode split partials. The result is a
   :class:`MemoryLedger`: typed ``(phase, component, bytes)`` entries with
   per-phase rollups. Host arithmetic only.

2. **Measured confirmation** (:func:`measure_program_memory` /
   :func:`sample_memory_stats`). The JAX package asks XLA for a compiled
   executable's static memory analysis; the port has no compiler to ask,
   so it measures one real call on the card instead: the call runs once
   between ``torch.cuda.reset_peak_memory_stats`` and
   ``torch.cuda.max_memory_allocated``, and the peak above what was
   allocated before it, less the outputs, is the call's temporary bytes.
   That is what the caching allocator handed out (blocks rounded to its
   granularity), not a plan: a different input can take a different
   amount, and nothing is compiled. :func:`sample_memory_stats` reads
   ``torch.cuda.memory_stats`` (host-side allocator counters, no device
   sync). Both are empty / None on the CPU. :func:`ledger_vs_measured`
   turns a ledger and a measurement into a predicted-vs-measured delta
   with an honest unattributed residual, recorded as ``magi_mem_*``
   gauges.

3. **Pool forensics** (:func:`fragmentation_map` /
   :class:`PoolFragmentationMap` / :class:`MemPressureWatcher`): page-state
   maps (ASCII heatmap + JSON dump/load), a fragmentation ratio (the
   unusable-free-run fraction at the current reservation granularity),
   the allocator's high-water mark, and the triggers — ``pool_exhausted``
   admissions, rejection storms and sustained ``mem_pressure`` arm the
   flight recorder, whose dumps then embed a ledger + fragmentation
   snapshot of every registered engine.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping, Sequence

# ---------------------------------------------------------------------------
# layer 1: the static memory ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """One priced allocation: ``nbytes`` attributed to a ``phase``
    (when the bytes are live: ``prefill`` / ``decode`` / ``stageN_cast``
    / ``stageN_kernel`` / ``pool`` ...) and a ``component`` (what the
    bytes are: ``comm_buffer`` / ``partials`` / ``pages_live`` ...).
    ``detail`` carries the shape arithmetic the price came from, so a
    mispriced entry is auditable from the dump alone."""

    phase: str
    component: str
    nbytes: int
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "phase": self.phase,
            "component": self.component,
            "nbytes": int(self.nbytes),
            "detail": dict(self.detail),
        }


@dataclasses.dataclass(frozen=True)
class MemoryLedger:
    """A named set of priced allocations with per-phase rollups.

    Per-rank convention: a plan ledger prices ONE rank's buffers (the
    shard one rank's program touches), matching how
    ``scheduled_rows_per_rank`` and ``shard_q_pad`` are per-rank
    figures; a serving ledger prices one engine's pool + scratch.
    """

    name: str
    entries: tuple[LedgerEntry, ...]

    def total(self, phase: str | None = None) -> int:
        return sum(
            e.nbytes for e in self.entries
            if phase is None or e.phase == phase
        )

    def by_phase(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e.phase] = out.get(e.phase, 0) + e.nbytes
        return dict(sorted(out.items()))

    def by_component(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e.component] = out.get(e.component, 0) + e.nbytes
        return dict(sorted(out.items()))

    def phases(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for e in self.entries:
            seen.setdefault(e.phase, None)
        return tuple(seen)

    def as_json(self) -> dict:
        return {
            "name": self.name,
            "total_bytes": self.total(),
            "by_phase": self.by_phase(),
            "entries": [e.to_json() for e in self.entries],
        }

    @staticmethod
    def from_json(payload: dict) -> "MemoryLedger":
        return MemoryLedger(
            name=str(payload["name"]),
            entries=tuple(
                LedgerEntry(
                    phase=str(e["phase"]),
                    component=str(e["component"]),
                    nbytes=int(e["nbytes"]),
                    detail=dict(e.get("detail") or {}),
                )
                for e in payload.get("entries", [])
            ),
        )

    def report(self) -> str:
        """Human-readable rollup (largest phase first)."""
        lines = [
            f"memory ledger '{self.name}': "
            f"{_fmt_bytes(self.total())} total"
        ]
        for phase, b in sorted(
            self.by_phase().items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"  {phase:<16} {_fmt_bytes(b):>10}")
            for e in self.entries:
                if e.phase == phase:
                    lines.append(
                        f"    {e.component:<20} {_fmt_bytes(e.nbytes):>10}"
                    )
        return "\n".join(lines)


def _fmt_bytes(b: int) -> str:
    b = int(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.5g} {unit}" if unit != "B" else f"{b} B"
        b /= 1024  # type: ignore[assignment]
    return f"{b} B"  # pragma: no cover


def _nbytes(*dims: int, itemsize: int) -> int:
    return int(math.prod(int(d) for d in dims)) * int(itemsize)


def _pool_itemsize(cache) -> int:
    """Bytes of one K/V element of a pool, sharded or not."""
    from ..serving.kv_cache import shards_of

    return shards_of(cache)[0].k_pages.element_size()


def plan_memory_ledger(
    plan,
    *,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int,
    bytes_per_elt: int = 2,
    acc_bytes: int = 4,
    shard_k_len: int | None = None,
    name: str = "dist_attn",
) -> MemoryLedger:
    """Price one rank's buffers for a :class:`DistAttnPlan` forward.

    Single-sourced with the solver's own accounting: each stage's cast
    buffer is ``comm.scheduled_rows_per_rank`` rows — the rows the
    selected impl actually schedules on the wire (NOT the true-row
    lower bound, NOT the legacy global pad), the figure the auto-degree
    search prices stages with — times the K+V row bytes. ``kernel_tables``
    prices the port's own table layout (not the JAX package's). Kernel scratch is the per-stage partial
    ``(out, lse)`` pair the LSE-merge tree folds, in the accumulation
    dtype (``acc_bytes``).

    Phases: ``operands`` (q/k/v shard + kernel tables), ``stageN_cast``
    (the stage's recv buffer), ``stageN_kernel`` (the stage's partial +
    LSE scratch; the merged degree-0 path and the host stage price as
    ``stage0_*`` resp. ``host_kernel``), ``outputs`` (out + lse).

    ``shard_k_len`` defaults to ``plan.shard_q_pad`` — correct for
    self-attention plans (the KV shard is the same dispatched token
    shard). Cross-attention plans, or callers whose KV shard length
    differs from the padded Q shard, MUST pass the real per-rank KV
    length or ``operand_kv`` is mispriced.
    """
    sq = int(plan.shard_q_pad)
    sk = int(shard_k_len if shard_k_len is not None else plan.shard_q_pad)
    hq, hkv, d = int(num_heads_q), int(num_heads_kv), int(head_dim)
    row_bytes = 2 * hkv * d * int(bytes_per_elt)  # one K row + one V row
    entries: list[LedgerEntry] = [
        LedgerEntry(
            "operands", "operand_q",
            _nbytes(sq, hq, d, itemsize=bytes_per_elt),
            {"shape": [sq, hq, d], "itemsize": bytes_per_elt},
        ),
        LedgerEntry(
            "operands", "operand_kv",
            2 * _nbytes(sk, hkv, d, itemsize=bytes_per_elt),
            {"shape": [2, sk, hkv, d], "itemsize": bytes_per_elt},
        ),
    ]
    tables = getattr(plan, "table_sets", None)
    if tables is not None:
        # the port's own kernel tables (stacked over the cp axis)
        tab_bytes = sum(int(a.nbytes) for t in tables() for a in t.arrays())
        entries.append(
            LedgerEntry(
                "operands", "kernel_tables",
                tab_bytes // max(plan.cp_size, 1),
                {"stacked_bytes": tab_bytes, "cp": plan.cp_size},
            )
        )

    def _partials(phase: str, label: str) -> None:
        entries.append(
            LedgerEntry(
                phase, "partials",
                _nbytes(sq, hq, d, itemsize=acc_bytes),
                {"shape": [sq, hq, d], "itemsize": acc_bytes,
                 "stage": label},
            )
        )
        entries.append(
            LedgerEntry(
                phase, "lse",
                _nbytes(sq, hq, itemsize=4),
                {"shape": [sq, hq], "itemsize": 4, "stage": label},
            )
        )

    def _cast(phase: str, comm) -> None:
        rows = int(comm.scheduled_rows_per_rank)
        entries.append(
            LedgerEntry(
                phase, "comm_buffer",
                rows * row_bytes,
                {"scheduled_rows_per_rank": rows, "row_bytes": row_bytes,
                 "impl": getattr(comm, "impl", "a2a")},
            )
        )

    if plan.overlap_degree == 0:
        _cast("stage0_cast", plan.merged_comm)
        _partials("stage0_kernel", "merged")
    else:
        _partials("host_kernel", "host")
        for i, sp in enumerate(plan.stages):
            _cast(f"stage{i}_cast", sp.comm)
            _partials(f"stage{i}_kernel", f"stage{i}")
    entries.append(
        LedgerEntry(
            "outputs", "out",
            _nbytes(sq, hq, d, itemsize=bytes_per_elt),
            {"shape": [sq, hq, d], "itemsize": bytes_per_elt},
        )
    )
    entries.append(
        LedgerEntry(
            "outputs", "lse",
            _nbytes(sq, hq, itemsize=4),
            {"shape": [sq, hq], "itemsize": 4},
        )
    )
    return MemoryLedger(name=name, entries=tuple(entries))


def serving_memory_ledger(
    engine=None,
    *,
    cache=None,
    allocator=None,
    name: str = "serving",
    num_q_heads: int | None = None,
    decode_batch: int | None = None,
    num_splits: int | None = None,
    prefill_chunk: int | None = None,
    q_bytes: int | None = None,
) -> MemoryLedger:
    """Price a serving configuration from the allocator + cache that
    already exist (pass a :class:`ServingEngine`, or an explicit
    ``cache=``/``allocator=`` pair).

    - phase ``pool``: the page pool's device bytes split
      ``pages_live`` (slot-owned; a CoW-shared page counts ONCE — the
      allocator's residency accounting) / ``pages_trie`` (resident only
      because the prefix cache pins them) / ``pages_free``; their sum is
      the pool tensors' ``nbytes`` (every shard's, for a sharded pool).
    - phase ``tables``: block tables + ``seq_lens`` control state.
    - phase ``decode`` (when ``num_q_heads``/``decode_batch`` are
      given): the step's q operand plus the split-KV partials/LSE
      scratch for ``num_splits`` (resolving the split count is the
      CALLER's job — this prices what it is told, like the plan ledger
      prices the plan it is handed).
    - phase ``prefill`` (when ``prefill_chunk`` is given): one chunk's
      q/k/v rows plus the gathered-history K/V the continuation path
      attends against (the whole committed prefix, worst case
      ``max_seq_len``).
    """
    if engine is not None:
        cache = engine.cache if cache is None else cache
        allocator = engine.allocator if allocator is None else allocator
    if cache is None or allocator is None:
        raise ValueError(
            "serving_memory_ledger needs an engine= or an explicit "
            f"cache= + allocator= pair (got cache={type(cache).__name__}, "
            f"allocator={type(allocator).__name__})"
        )
    itemsize = _pool_itemsize(cache)
    page_bytes = 2 * _nbytes(
        cache.page_size, cache.num_kv_heads, cache.head_dim,
        itemsize=itemsize,
    )  # K page + V page
    states = allocator.page_states()
    n_live = len(states["live"]) + len(states["shared"])
    n_trie = len(states["trie"])
    n_free = len(states["free"])
    entries: list[LedgerEntry] = [
        LedgerEntry(
            "pool", "pages_live", n_live * page_bytes,
            {"pages": n_live, "page_bytes": page_bytes,
             "shared": len(states["shared"])},
        ),
        LedgerEntry(
            "pool", "pages_trie", n_trie * page_bytes,
            {"pages": n_trie, "page_bytes": page_bytes},
        ),
        LedgerEntry(
            "pool", "pages_free", n_free * page_bytes,
            {"pages": n_free, "page_bytes": page_bytes},
        ),
        LedgerEntry(
            "tables", "block_tables",
            cache.block_tables.numel() * cache.block_tables.element_size(),
            {"shape": list(cache.block_tables.shape)},
        ),
        LedgerEntry(
            "tables", "seq_lens",
            cache.seq_lens.numel() * cache.seq_lens.element_size(),
            {"shape": list(cache.seq_lens.shape)},
        ),
    ]
    qb = int(q_bytes if q_bytes is not None else itemsize)
    d = cache.head_dim
    if num_q_heads is not None and decode_batch is not None:
        hq, b = int(num_q_heads), int(decode_batch)
        splits = max(int(num_splits or 1), 1)
        entries += [
            LedgerEntry(
                "decode", "operand_q", _nbytes(b, hq, d, itemsize=qb),
                {"shape": [b, hq, d], "itemsize": qb},
            ),
            LedgerEntry(
                "decode", "split_partials",
                _nbytes(splits, b, hq, d, itemsize=4),
                {"shape": [splits, b, hq, d], "itemsize": 4},
            ),
            LedgerEntry(
                "decode", "split_lse",
                _nbytes(splits, b, hq, itemsize=4),
                {"shape": [splits, b, hq], "itemsize": 4},
            ),
        ]
    if prefill_chunk is not None and num_q_heads is not None:
        t = int(prefill_chunk)
        hq = int(num_q_heads)
        hist = cache.max_seq_len
        entries += [
            LedgerEntry(
                "prefill", "chunk_qkv",
                _nbytes(t, hq, d, itemsize=qb)
                + 2 * _nbytes(t, cache.num_kv_heads, d, itemsize=itemsize),
                {"chunk": t},
            ),
            LedgerEntry(
                "prefill", "gathered_history",
                2 * _nbytes(hist, cache.num_kv_heads, d, itemsize=itemsize),
                {"max_gather_len": hist},
            ),
        ]
    return MemoryLedger(name=name, entries=tuple(entries))


def tiered_memory_ledger(tiered, **kw) -> dict[str, MemoryLedger]:
    """Per-tier ledgers for a :class:`~..serving.distributed.
    TieredEngine`: one ``tier_prefill`` ledger plus one
    ``tier_decode_r<N>`` per decode replica (each replica owns its own
    sharded pool + allocator)."""
    out = {
        "tier_prefill": serving_memory_ledger(
            tiered._prefill, name="tier_prefill", **kw
        )
    }
    for rep in tiered.replicas:
        nm = f"tier_decode_r{rep.index}"
        out[nm] = serving_memory_ledger(rep.engine, name=nm, **kw)
    return out


# ---------------------------------------------------------------------------
# layer 2: measured confirmation
# ---------------------------------------------------------------------------


# the JAX keys of a device's memory_stats() -> torch.cuda.memory_stats() keys
_STATS_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
}


def sample_memory_stats(
    devices=None, *, key: str = "bytes_in_use"
) -> "dict[Any, int]":
    """One allocator sample across CUDA devices: ``{device: bytes}``, read
    from ``torch.cuda.memory_stats`` (host-side counters: no device sync).
    ``key`` takes the JAX names: ``bytes_in_use`` (the caching allocator's
    ``allocated_bytes.all.current``) or ``peak_bytes_in_use``
    (``allocated_bytes.all.peak``, the allocator's own high-water mark
    since the last ``reset_peak_memory_stats``); a raw ``memory_stats``
    key is read as it is. ``devices`` defaults to every visible card. On a
    machine without CUDA, and for a CPU device, the result is empty."""
    import torch

    if not torch.cuda.is_available():
        return {}
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    stat = _STATS_KEYS.get(key, key)
    out: dict[Any, int] = {}
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        stats = torch.cuda.memory_stats(d)
        if stat in stats:
            out[d] = int(stats[stat])
    return out


def _tensors(obj, seen: set):
    """Every distinct tensor storage in ``obj`` (tensors, sequences, dicts
    and dataclasses such as a ``PagedKVCache``), once each."""
    import torch

    if isinstance(obj, torch.Tensor):
        key = (obj.device, obj.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x, seen)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)


def _storage_bytes(t) -> int:
    return int(t.untyped_storage().nbytes())


def measure_program_memory(fn, *args, **kwargs) -> dict | None:
    """Run ``fn(*args, **kwargs)`` once on the card and return its memory
    under the JAX package's keys: ``argument_bytes`` (the distinct tensor
    storages in the arguments), ``output_bytes`` (in the result),
    ``alias_bytes`` (result storages that are argument storages: in-place
    updates), ``temp_bytes`` (the allocator's peak during the call above
    what was allocated before it, less the new outputs),
    ``generated_code_bytes`` (0: nothing is compiled) and their
    ``total_bytes`` (argument + output + temp).

    The peak is ``torch.cuda.max_memory_allocated`` after a
    ``reset_peak_memory_stats`` (the call is synchronised on both sides);
    it is what the caching allocator handed out during this one call, not
    XLA's static analysis of every call. Returns None when the arguments
    hold no CUDA tensor (the CPU) — never raises for that; an exception of
    ``fn`` itself propagates."""
    import torch

    seen: set = set()
    arg_tensors = list(_tensors((args, kwargs), seen))
    cuda = [t for t in arg_tensors if t.device.type == "cuda"]
    if not cuda or not torch.cuda.is_available():
        return None
    dev = cuda[0].device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    result = fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    arg_keys = set(seen)
    out_seen: set = set()
    out_tensors = list(_tensors(result, out_seen))
    alias = sum(_storage_bytes(t) for t in out_tensors
                if (t.device, t.untyped_storage().data_ptr()) in arg_keys)
    output = sum(_storage_bytes(t) for t in out_tensors)
    out = {
        "argument_bytes": sum(_storage_bytes(t) for t in arg_tensors),
        "output_bytes": output,
        "temp_bytes": max(int(peak - base) - (output - alias), 0),
        "alias_bytes": alias,
        "generated_code_bytes": 0,
    }
    out["total_bytes"] = (
        out["argument_bytes"] + out["output_bytes"] + out["temp_bytes"]
    )
    return out


@dataclasses.dataclass(frozen=True)
class MemoryComparison:
    """Predicted-vs-measured verdict for one measured call.

    The gate compares what BOTH sides can price exactly — the call's
    argument + output buffers (the ledger prices them from the same
    geometry) — as ``delta_ratio`` = predicted/measured. The measured
    ``temp_bytes`` is reported against the ledger's scratch phases, with
    the difference surfaced as ``unattributed_bytes``: an honest residual
    (gathers and casts the ledger does not price, the allocator's
    rounding), NEVER folded into the gated delta.
    """

    program: str
    predicted_io_bytes: int
    measured_io_bytes: int
    predicted_scratch_bytes: int
    measured_temp_bytes: int

    @property
    def delta_ratio(self) -> float:
        return self.predicted_io_bytes / max(self.measured_io_bytes, 1)

    @property
    def unattributed_bytes(self) -> int:
        """Measured temp the ledger did not price (negative: the ledger
        priced scratch the call never allocated)."""
        return self.measured_temp_bytes - self.predicted_scratch_bytes

    def within(self, tolerance: float) -> bool:
        return abs(self.delta_ratio - 1.0) <= tolerance

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "predicted_io_bytes": self.predicted_io_bytes,
            "measured_io_bytes": self.measured_io_bytes,
            "delta_ratio": self.delta_ratio,
            "predicted_scratch_bytes": self.predicted_scratch_bytes,
            "measured_temp_bytes": self.measured_temp_bytes,
            "unattributed_bytes": self.unattributed_bytes,
        }


# ledger phases that are program I/O vs scratch, by convention of the
# ledger functions above: everything except kernel/scratch phases round-trips
# through the program boundary
_SCRATCH_MARKERS = ("_kernel", "_cast")
_SCRATCH_PHASES = ("host_kernel", "decode_scratch")


def _is_scratch_phase(phase: str) -> bool:
    return phase in _SCRATCH_PHASES or any(
        m in phase for m in _SCRATCH_MARKERS
    )


def ledger_vs_measured(
    ledger: MemoryLedger,
    measured: "Mapping[str, int] | None",
    *,
    program: str | None = None,
    io_phases: Sequence[str] | None = None,
    scratch_phases: Sequence[str] | None = None,
    scratch_components: Sequence[str] = ("split_partials", "split_lse"),
    record: bool = True,
) -> "MemoryComparison | None":
    """Fold a ledger and a :func:`measure_program_memory` result into a
    :class:`MemoryComparison` (and record the ``magi_mem_*`` gauges).

    ``measured=None`` — what :func:`measure_program_memory` returns on
    the CPU — returns None (the same CPU-safe no-op convention), so the
    one-liner
    ``ledger_vs_measured(led, measure_program_memory(fn, *args))``
    degrades gracefully instead of raising.

    ``io_phases`` defaults to every non-scratch phase of the ledger
    (operands/outputs/pool/tables...); ``scratch_phases`` to the
    ``*_kernel``/``*_cast`` phases plus any ``scratch_components``
    entries inside io phases (decode split partials live in the
    ``decode`` phase but are temporaries of the call)."""
    if measured is None:
        return None
    if io_phases is None:
        io_phases = [p for p in ledger.phases() if not _is_scratch_phase(p)]
    if scratch_phases is None:
        scratch_phases = [p for p in ledger.phases() if _is_scratch_phase(p)]
    io = sum(
        e.nbytes for e in ledger.entries
        if e.phase in io_phases and e.component not in scratch_components
    )
    scratch = sum(
        e.nbytes for e in ledger.entries
        if e.phase in scratch_phases
        or (e.phase in io_phases and e.component in scratch_components)
    )
    cmp = MemoryComparison(
        program=program or ledger.name,
        predicted_io_bytes=int(io),
        measured_io_bytes=int(measured["argument_bytes"])
        + int(measured["output_bytes"]),
        predicted_scratch_bytes=int(scratch),
        measured_temp_bytes=int(measured["temp_bytes"]),
    )
    if record:
        from .collectors import (
            record_memory_comparison,
            record_memory_ledger,
            record_memory_measurement,
        )

        # record the ledger under the COMPARISON's program label, so
        # the summary's memory-probe line (which pairs
        # magi_mem_predicted_bytes{ledger=<program>} with
        # magi_mem_delta_ratio{program=<program>}) always finds the
        # predicted total, even when program= overrides ledger.name
        record_memory_ledger(
            ledger if ledger.name == cmp.program
            else dataclasses.replace(ledger, name=cmp.program)
        )
        record_memory_measurement(cmp.program, measured)
        record_memory_comparison(cmp)
    return cmp


# ---------------------------------------------------------------------------
# layer 3: pool forensics
# ---------------------------------------------------------------------------

# page-state codes in the map vector (and their heatmap glyphs)
PAGE_FREE, PAGE_LIVE, PAGE_SHARED, PAGE_TRIE = 0, 1, 2, 3
_STATE_NAMES = ("free", "live", "shared", "trie")
_STATE_GLYPHS = ".#%T"


@dataclasses.dataclass(frozen=True)
class PoolFragmentationMap:
    """One page pool's exact state vector + free-run analysis.

    ``states[p]`` codes page ``p``: free / live (slot-owned, one ref) /
    shared (slot-owned, >1 ref — CoW) / trie (resident only because the
    prefix cache pins it). ``granularity`` is the reservation unit the
    fragmentation ratio is judged at (pages a contiguous multi-page
    reservation would want): a maximal run of ``L`` consecutive free
    page ids contributes ``L % granularity`` unusable pages, and

        ``fragmentation_ratio = unusable_free_pages / free_pages``

    (0.0 when nothing is free, or when every free run is a whole
    multiple of the granularity). The paged allocator itself never
    needs contiguity — this is the diagnostic for contiguity-sensitive
    consumers (page-stream gathers, defrag planning, future multi-page
    reservations) and the honest "the pool has room but not in one
    piece" signal.
    """

    pool: str
    page_bytes: int
    granularity: int
    states: tuple[int, ...]
    peak_pages: int = 0

    @property
    def num_pages(self) -> int:
        return len(self.states)

    def count(self, state: int) -> int:
        return sum(1 for s in self.states if s == state)

    @property
    def free_pages(self) -> int:
        return self.count(PAGE_FREE)

    def free_runs(self) -> tuple[int, ...]:
        """Lengths of maximal runs of consecutive free page ids."""
        runs, cur = [], 0
        for s in self.states:
            if s == PAGE_FREE:
                cur += 1
            elif cur:
                runs.append(cur)
                cur = 0
        if cur:
            runs.append(cur)
        return tuple(runs)

    @property
    def free_run_max(self) -> int:
        runs = self.free_runs()
        return max(runs) if runs else 0

    @property
    def unusable_free_pages(self) -> int:
        g = max(self.granularity, 1)
        return sum(r % g for r in self.free_runs())

    @property
    def fragmentation_ratio(self) -> float:
        free = self.free_pages
        return self.unusable_free_pages / free if free else 0.0

    def state_counts(self) -> dict[str, int]:
        return {
            name: self.count(code)
            for code, name in enumerate(_STATE_NAMES)
        }

    def ascii_heatmap(self, width: int = 64) -> str:
        """Page-granular pool picture: ``.`` free, ``#`` live, ``%``
        CoW-shared, ``T`` trie-resident; one row per ``width`` pages."""
        counts = self.state_counts()
        lines = [
            f"pool '{self.pool}': {self.num_pages} pages x "
            f"{_fmt_bytes(self.page_bytes)} "
            f"(live {counts['live']}, shared {counts['shared']}, "
            f"trie {counts['trie']}, free {counts['free']}; "
            f"frag {self.fragmentation_ratio:.3f} @ gran "
            f"{self.granularity}, peak {self.peak_pages})"
        ]
        for lo in range(0, self.num_pages, width):
            row = self.states[lo : lo + width]
            lines.append(
                "  |" + "".join(_STATE_GLYPHS[s] for s in row) + "|"
            )
        return "\n".join(lines)

    def as_json(self) -> dict:
        return {
            "pool": self.pool,
            "page_bytes": self.page_bytes,
            "granularity": self.granularity,
            "num_pages": self.num_pages,
            "states": list(self.states),
            "state_counts": self.state_counts(),
            "free_runs": list(self.free_runs()),
            "free_run_max": self.free_run_max,
            "fragmentation_ratio": self.fragmentation_ratio,
            "unusable_free_pages": self.unusable_free_pages,
            "peak_pages": self.peak_pages,
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @staticmethod
    def from_json(payload: dict) -> "PoolFragmentationMap":
        return PoolFragmentationMap(
            pool=str(payload["pool"]),
            page_bytes=int(payload["page_bytes"]),
            granularity=int(payload["granularity"]),
            states=tuple(int(s) for s in payload["states"]),
            peak_pages=int(payload.get("peak_pages", 0)),
        )

    @staticmethod
    def load(path: str) -> "PoolFragmentationMap":
        with open(path) as f:
            return PoolFragmentationMap.from_json(json.load(f))


def fragmentation_map(
    allocator,
    *,
    pool: str = "kvpool",
    granularity: int | None = None,
    page_bytes: int | None = None,
    record: bool = False,
) -> PoolFragmentationMap:
    """Build the page-state map of a
    :class:`~..serving.kv_cache.PageAllocator`.

    ``granularity`` defaults to the CURRENT reservation granularity:
    the largest live slot reservation (what one admitted sequence
    actually spans), 1 when the pool is empty — so the fragmentation
    ratio answers "could the pool serve another reservation like the
    ones it is serving, contiguously". ``page_bytes`` defaults to the
    allocator's K+V token bytes being unknown here: 0 (pass the cache's
    real page bytes for priced reports; the ledger does)."""
    states = allocator.page_states()
    vec = [PAGE_FREE] * allocator.num_pages
    for p in states["live"]:
        vec[p] = PAGE_LIVE
    for p in states["shared"]:
        vec[p] = PAGE_SHARED
    for p in states["trie"]:
        vec[p] = PAGE_TRIE
    if granularity is None:
        granularity = max(
            (
                allocator.reserved_pages(s)
                for s in range(allocator.max_seqs)
            ),
            default=1,
        ) or 1
    fmap = PoolFragmentationMap(
        pool=pool,
        page_bytes=int(page_bytes or 0),
        granularity=int(granularity),
        states=tuple(vec),
        peak_pages=int(getattr(allocator, "peak_pages_in_use", 0)),
    )
    if record:
        from .collectors import record_memory_pool

        record_memory_pool(fmap)
    return fmap


class MemPressureWatcher:
    """Sustained-low-free-page detector (the ``mem_pressure`` flight
    trigger): :meth:`observe` is fed the pool's free-page fraction once
    per scheduler tick and returns True exactly once per pressure
    episode — after ``ticks`` consecutive observations under
    ``threshold`` — re-arming only once the fraction recovers. A
    threshold of 0 disables the watcher entirely (the env default; see
    ``MAGI_ATTENTION_MEM_PRESSURE_THRESHOLD``)."""

    def __init__(
        self, threshold: float | None = None, *, ticks: int = 8
    ):
        from .. import env

        self.threshold = (
            env.mem_pressure_threshold() if threshold is None
            else float(threshold)
        )
        self.ticks = max(int(ticks), 1)
        self._below = 0
        self._fired = False

    def observe(self, free_fraction: float) -> bool:
        if self.threshold <= 0.0:
            return False
        if float(free_fraction) >= self.threshold:
            self._below = 0
            self._fired = False
            return False
        self._below += 1
        if self._below >= self.ticks and not self._fired:
            self._fired = True
            return True
        return False


# ---------------------------------------------------------------------------
# convenience: one-call engine snapshot (what flight dumps embed)
# ---------------------------------------------------------------------------


def engine_memory_snapshot(engine, *, pool: str = "kvpool") -> dict:
    """Ledger + fragmentation map of one engine, JSON-safe — the payload a
    flight-recorder memory source returns. On the card it also carries the
    caching allocator's counters for the pool's devices (``allocator``:
    ``bytes_in_use`` and ``peak_bytes_in_use`` from
    ``torch.cuda.memory_stats``), which the JAX package's payload lacks; on
    the CPU the payload is the JAX package's."""
    from ..serving.kv_cache import shards_of

    cache = engine.cache
    page_bytes = 2 * (
        cache.page_size * cache.num_kv_heads * cache.head_dim
        * _pool_itemsize(cache)
    )
    snap = {
        "ledger": serving_memory_ledger(engine, name=pool).as_json(),
        "fragmentation": fragmentation_map(
            engine.allocator, pool=pool, page_bytes=page_bytes
        ).as_json(),
    }
    allocator: dict = {}
    for dev in dict.fromkeys(c.device for c in shards_of(cache)):
        for key in _STATS_KEYS:
            for d, b in sample_memory_stats([dev], key=key).items():
                allocator.setdefault(str(d), {})[key] = b
    if allocator:
        snap["allocator"] = allocator
    return snap
