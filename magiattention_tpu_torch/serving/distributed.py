"""Disaggregated serving: prefill on one tier, decode on another.

The counterpart of the JAX package's ``serving/distributed.py``, mapped
from one controller over a JAX device mesh to one process over a list of
``torch.device``s (a device may repeat: on one card every tier is
``cuda:0``, and every path still runs).

- **Sharded page pool.** :func:`~.kv_cache.shard_kv_cache` splits a pool on
  its KV-head axis over a replica's devices; the block tables and lengths
  are copied to every shard, and the page allocator stays one host free
  list.
- **TP decode** (:func:`tp_decode_attn`). Each shard's ``paged_decode`` on
  its q-head slice, the outputs concatenated on the head axis: no
  collective, since softmax is per head. Equal bit for bit to single-device
  decode: the split count is resolved once for the full batch, and each
  slice's launch sizes its clusters for the whole pool's kv heads
  (``cluster_heads``).
- **Tiers** (:class:`TieredEngine`, ``MAGI_ATTENTION_SERVING_MESH``, e.g.
  ``prefill=1,decode=2x2``). Chunked, prefix-shared prefill on the prefill
  tier; a committed prompt's pages stream to the least-loaded live decode
  replica (gathered with ``index_select`` on the prefill device, each head
  slice copied to its shard's device, scattered into the replica's pool),
  where every decode step then runs. ``dp`` replicas of ``tp`` devices.
- **Tier scheduling** (:class:`TieredScheduler`). The port's
  :class:`~.scheduler.Scheduler` with a token budget per tier, one decode
  group per replica, and the requeue of a failed replica's requests.
- **Fleet resilience.** :meth:`TieredEngine.admit` answers
  ``decode_saturated`` while no live replica could take the request or the
  stream queue is full, so a requeued request never lands on a saturated
  tier. A replica-local failure in a decode step (an injected
  ``decode_fault`` chaos, or a page-allocator failure during the replica's
  growth) tears down only that replica (:class:`DecodeTierFault` names its
  sequences, which the scheduler replays through the prefill tier) and
  rebuilds it with a fresh pool.

Telemetry, as the JAX package records it, none of which changes a
schedule: the tiers' occupancy (``record_tier_state``), the page streams
and the stream-queue depth, tier faults and their deferred
``decode_tier_fault`` flight dump, the ``tier_assigned`` /
``pages_streamed`` / ``tier_migrated`` request spans, the ``tier=`` SLO
labels, and one flight-recorder memory source for the whole fleet
(:meth:`TieredEngine.memory_snapshot`, per-tier ledgers and fragmentation
maps).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Sequence

import torch

from .. import telemetry
from ..resilience import chaos
from ..telemetry import trace as reqtrace
from .decode_attn import decode_attn_paged, resolve_num_splits
from .engine import AdmissionResult, ServingEngine
from .kv_cache import (
    PagedKVCache,
    PageAllocatorError,
    ShardedPagedKVCache,
    assign_block_table,
    shard_kv_cache,
    shards_of,
)
from .scheduler import DECODING, Scheduler, StepReport


class DecodeTierFault(RuntimeError):
    """A decode replica failed mid-step. Carries the replica index and every
    sequence id that lost its KV: the :class:`TieredScheduler` requeues
    exactly those for replay."""

    def __init__(self, replica: int, sids: Sequence[int], cause: str = ""):
        super().__init__(
            f"decode replica {replica} failed" + (f": {cause}" if cause else "")
            + f" ({len(tuple(sids))} sequences requeued for replay)")
        self.replica = int(replica)
        self.sids = tuple(int(s) for s in sids)


# -- TP decode over a KV-head-sharded pool ---------------------------------------


def tp_decode_attn(
    q: torch.Tensor,  # [b, hq, head_dim] one query token per sequence
    cache: PagedKVCache | ShardedPagedKVCache,
    slots,  # [b] int cache slots
    *,
    devices: Sequence,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel split-KV decode over a pool sharded on ``devices``.

    Shard ``i`` runs :func:`~.decode_attn.decode_attn_paged` on its device
    over q heads ``[i * hq / tp, (i + 1) * hq / tp)``; ``out`` and ``lse``
    are concatenated on the head axis on the first device. One device
    reduces to the plain call. Returns ``(out [b, hq, d], lse [b, hq])``."""
    devices = [_resolve_device(d) for d in devices]
    tp = len(devices)
    slots = torch.as_tensor(slots, dtype=torch.int32)
    kw = dict(scale=scale, softcap=softcap, out_dtype=out_dtype)
    if tp == 1:
        return decode_attn_paged(q, cache, slots, num_splits=num_splits, **kw)
    b, hq, _d = q.shape
    hk = cache.num_kv_heads
    if hk % tp or hq % tp:
        raise ValueError(
            f"tp_decode_attn: kv_heads {hk} / q heads {hq} not divisible by tp={tp} — the "
            "KV-head-sharded layout needs equal head slices per device")
    if not isinstance(cache, ShardedPagedKVCache) or list(cache.devices) != devices:
        raise ValueError(
            f"tp_decode_attn: the cache must be sharded over {[str(d) for d in devices]} "
            "(kv_cache.shard_kv_cache)")
    # once, for the whole batch and head count: every slice splits its
    # histories where the single-device call would
    num_splits = resolve_num_splits(num_splits, cache.shards[0], b, hq)
    outs, lses = [], []
    for i, shard in enumerate(cache.shards):
        h = slice(i * hq // tp, (i + 1) * hq // tp)
        o, l = decode_attn_paged(q[:, h].to(shard.device), shard, slots, num_splits=num_splits,
                                 cluster_heads=hk, **kw)
        outs.append(o.to(devices[0]))
        lses.append(l.to(devices[0]))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _resolve_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare ``cuda`` as the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


# -- the page stream: the prefill -> decode hop ----------------------------------


def pages_digest(k_payload: torch.Tensor, v_payload: torch.Tensor) -> str:
    """SHA-256 of a page payload's bytes, K then V: the stream's integrity
    oracle. The bytes are the JAX package's for the same pages (bf16 read
    as int16), so both packages give one digest."""
    h = hashlib.sha256()
    for x in (k_payload, v_payload):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def gather_pages(cache: PagedKVCache | ShardedPagedKVCache, pages) -> tuple[torch.Tensor, ...]:
    """The (K, V) of ``pages`` [n, page_size, kv_heads, d], a sharded pool's
    head slices concatenated back on the first shard's device."""
    shards = shards_of(cache)
    out = []
    for name in ("k_pages", "v_pages"):
        parts = [getattr(c, name).index_select(
            0, torch.as_tensor(list(pages), dtype=torch.long, device=c.device)).to(cache.device)
            for c in shards]
        out.append(torch.cat(parts, dim=2))
    return tuple(out)


@dataclasses.dataclass
class PendingStream:
    """One committed prompt waiting for decode-tier capacity."""

    sid: int
    length: int  # committed tokens the stream carries


@dataclasses.dataclass(frozen=True)
class StreamReport:
    """What one completed stream moved."""

    sid: int
    replica: int
    pages: int
    tokens: int
    nbytes: int
    digest_ok: bool | None  # None = verification off
    duration_s: float  # host clock, not synchronised


@dataclasses.dataclass
class DecodeReplica:
    """One decode-tier member: ``tp`` devices running TP decode over its own
    sharded pool (its engine's allocator is that pool's one free list)."""

    index: int
    devices: tuple[torch.device, ...]
    tp: int
    engine: ServingEngine
    restarts: int = 0


def _default_devices(need: int) -> list[torch.device]:
    """The cards in turn, as many as ``need`` (repeats when there are fewer)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("TieredEngine: no CUDA device is available; pass devices=['cpu'] * n "
                           "to run the plain versions")
    return [torch.device("cuda", i % n) for i in range(need)]


# -- the tiered engine -----------------------------------------------------------


class TieredEngine:
    """Prefill/decode-disaggregated serving over a list of devices.

    Speaks the host interface :class:`~.scheduler.Scheduler` drives
    (``admit`` / ``prefill`` / ``decode_step`` / ``free`` / ``allocator`` /
    ``device`` / ``last_decode_info``) behind a **logical sequence id**: a
    request admits onto the prefill tier and prefills there; once its prompt
    is committed its pages stream to a decode replica, where its decode
    steps run. ``mesh_spec`` (``{"prefill": P, "decode_dp": D, "decode_tp":
    T}``, default ``MAGI_ATTENTION_SERVING_MESH``, else one device each)
    takes the first P devices for prefill (its pool on the first) and the
    next D * T for the replicas; ``devices`` defaults to the cards in turn.
    """

    def __init__(
        self,
        *,
        num_pages: int,
        num_kv_heads: int,
        head_dim: int,
        page_size: int | None = None,
        max_seqs: int = 64,
        max_pages_per_seq: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        mesh_spec: dict | None = None,
        devices: Sequence | None = None,
        max_admission_evictions: int = 4,
        verify_streams: bool = False,
        stream_queue_max: int = 16,
    ):
        from .. import env

        env.refuse_unhonoured_flags("TieredEngine")
        if mesh_spec is None:
            mesh_spec = env.serving_mesh() or {"prefill": 1, "decode_dp": 1, "decode_tp": 1}
        self.mesh_spec = dict(mesh_spec)
        n_prefill = int(mesh_spec["prefill"])
        dp, tp = int(mesh_spec["decode_dp"]), int(mesh_spec["decode_tp"])
        need = n_prefill + dp * tp
        devices = [_resolve_device(d) for d in devices] if devices is not None \
            else _default_devices(need)
        if need > len(devices):
            raise ValueError(f"TieredEngine: mesh spec {mesh_spec} needs {need} devices, only "
                             f"{len(devices)} given (a device may be listed more than once)")
        if num_kv_heads % tp:
            raise ValueError(f"TieredEngine: decode_tp={tp} must divide num_kv_heads "
                             f"{num_kv_heads} (KV-head-sharded decode layout)")
        self.verify_streams = bool(verify_streams)
        self.stream_queue_max = int(stream_queue_max)
        # the tiered engine registers one memory source for the fleet below:
        # its member engines register none
        self._geom = dict(num_pages=num_pages, num_kv_heads=num_kv_heads, head_dim=head_dim,
                          page_size=page_size, max_seqs=max_seqs,
                          max_pages_per_seq=max_pages_per_seq, dtype=dtype,
                          max_admission_evictions=max_admission_evictions,
                          register_flight_memory=False)
        # the prefill tier's devices are reserved for its compute; its pool
        # lives on the first, where prefill writes one stream at a time
        self.prefill_devices = tuple(devices[:n_prefill])
        self._prefill = ServingEngine(prefix_sharing=True, device=self.prefill_devices[0],
                                      **self._geom)
        self.replicas: list[DecodeReplica] = [
            self._build_replica(r, tuple(devices[n_prefill + r * tp:n_prefill + (r + 1) * tp]),
                                tp)
            for r in range(dp)]
        self._pending: list[PendingStream] = []
        self._stream_reports: list[StreamReport] = []
        self._evicted_sids: list[int] = []
        self._seq: dict[int, dict] = {}  # sid -> lifecycle record
        self._next_sid = 0
        self.last_decode_info: dict = {}
        self._flight = reqtrace.get_flight_recorder()
        # the snapshot walks self.replicas at dump time, so a replica rebuilt
        # after a fault is picked up live
        self._flight.register_memory_source("tiered", self)
        self._record_tiers()

    def _build_replica(self, index: int, devs: tuple, tp: int) -> DecodeReplica:
        fn = functools.partial(tp_decode_attn, devices=devs) if tp > 1 else None
        eng = ServingEngine(prefix_sharing=False, decode_attn_fn=fn, device=devs[0], **self._geom)
        if tp > 1:
            eng.cache = shard_kv_cache(eng.cache, devs)
        return DecodeReplica(index=index, devices=devs, tp=tp, engine=eng)

    # -- introspection --

    @property
    def allocator(self):
        """The prefill tier's allocator, the one admission faces."""
        return self._prefill.allocator

    @property
    def device(self) -> torch.device:
        """Where requests' tensors lie: the prefill tier's device."""
        return self._prefill.device

    @property
    def pending_streams(self) -> int:
        return len(self._pending)

    def replica_of(self, sid: int) -> int | None:
        rec = self._seq.get(int(sid))
        return rec["replica"] if rec and rec["stage"] == "decode" else None

    def placed(self, sid: int) -> bool:
        """Whether the sequence is resident on the decode tier (streamed and
        decodable); False while its stream is parked for capacity."""
        rec = self._seq.get(int(sid))
        return bool(rec) and rec["stage"] == "decode"

    def occupancy(self) -> dict:
        return {"prefill": self._prefill.allocator.occupancy(),
                "decode": [r.engine.allocator.occupancy() for r in self.replicas],
                "pending_streams": len(self._pending)}

    def memory_snapshot(self) -> dict:
        """Per-tier memory forensics: the prefill tier's and every decode
        replica's ledger and fragmentation map, keyed ``tier_prefill`` /
        ``tier_decode_r<N>`` (which pool ran out), and the parked streams."""
        out = {"tier_prefill": telemetry.engine_memory_snapshot(self._prefill,
                                                                pool="tier_prefill"),
               "pending_streams": len(self._pending)}
        for rep in self.replicas:
            name = f"tier_decode_r{rep.index}"
            out[name] = telemetry.engine_memory_snapshot(rep.engine, pool=name)
        return out

    # -- admission (fleet backpressure) --

    def admit(self, num_tokens: int, *, priority: int = 0,
              tokens: Sequence[int] | None = None) -> AdmissionResult:
        """Fleet admission: the request must fit the prefill tier now and
        some live replica later (the same predicate placement uses), with
        the stream queue below its bound; otherwise ``decode_saturated``
        backpressure. On success ``slot`` is a logical sequence id, valid
        across the migration."""
        if (len(self._pending) >= self.stream_queue_max
                or self._pick_replica(num_tokens, int(priority)) is None):
            res = AdmissionResult(False, None, "decode_saturated")
            telemetry.record_admission(res)
            self._flight.note_admission(False, "decode_saturated")
            return res
        res = self._prefill.admit(num_tokens, priority=priority, tokens=tokens)
        evicted = self._translate_evicted(res.evicted)
        if not res.admitted:
            return dataclasses.replace(res, evicted=evicted)
        sid = self._next_sid
        self._next_sid += 1
        self._seq[sid] = {"stage": "prefill", "pslot": res.slot, "replica": None, "dslot": None,
                          "expected": int(num_tokens), "priority": int(priority)}
        reqtrace.span_for_current(reqtrace.SPAN_TIER_ASSIGNED, tier="prefill", slot=sid)
        self._record_tiers()
        return dataclasses.replace(res, slot=sid, evicted=evicted)

    def _translate_evicted(self, pslots: tuple) -> tuple:
        """The prefill engine evicts in its slot space, the scheduler
        requeues by sid: the victims' mappings (and parked streams) go."""
        if not pslots:
            return ()
        victims = [sid for sid, rec in self._seq.items()
                   if rec["stage"] in ("prefill", "stream_queued") and rec["pslot"] in pslots]
        for sid in victims:
            self._pending = [p for p in self._pending if p.sid != sid]
            del self._seq[sid]
        telemetry.record_stream_queue_depth(len(self._pending))
        return tuple(victims)

    # -- prefill tier --

    def prefill(self, q, k, v, sid: int, **kw):
        """Prefill rows into the sequence's prefill-tier slot (chunked and
        prefix-shared as the one-device engine). The call that completes the
        prompt queues its page stream and pumps the queue at once."""
        rec = self._require(sid, "prefill")
        out, lse = self._prefill.prefill(q, k, v, rec["pslot"], **kw)
        if self._prefill.length(rec["pslot"]) >= rec["expected"]:
            rec["stage"] = "stream_queued"
            self._pending.append(PendingStream(sid=sid, length=rec["expected"]))
            self.pump_streams()
        return out, lse

    def _require(self, sid: int, *stages: str) -> dict:
        rec = self._seq.get(int(sid))
        if rec is None or (stages and rec["stage"] not in stages):
            raise KeyError(
                f"TieredEngine: sequence {sid} is "
                + ("unknown" if rec is None else f"in stage {rec['stage']!r}")
                + (f", expected {stages}" if stages else ""))
        return rec

    # -- the page stream --

    def pump_streams(self) -> list[StreamReport]:
        """Place every parked stream (FIFO) on the least-loaded live replica
        with room; a stream that cannot place stays parked. Returns the
        streams this pump completed (also kept for
        :meth:`take_stream_reports`)."""
        done, still = [], []
        for ps in self._pending:
            rep = self._place_stream(ps)
            if rep is None:
                still.append(ps)
            else:
                done.append(rep)
        self._pending = still
        for rep in done:
            telemetry.record_page_stream(pages=rep.pages, nbytes=rep.nbytes,
                                         queue_depth=len(self._pending))
        telemetry.record_stream_queue_depth(len(self._pending))
        if done:
            self._stream_reports.extend(done)
            self._record_tiers()
        return done

    def take_stream_reports(self) -> list[StreamReport]:
        out, self._stream_reports = self._stream_reports, []
        return out

    def take_evicted_sids(self) -> list[int]:
        """Decode-tier priority-eviction victims, for the scheduler to
        requeue."""
        out, self._evicted_sids = self._evicted_sids, []
        return out

    def _pick_replica(self, num_tokens: int, priority: int = 0) -> DecodeReplica | None:
        """The least-loaded replica that can take ``num_tokens`` now, else
        one holding a resident of strictly lower priority (its engine's
        admission evicts to make room); None when neither exists. Admission
        and placement share it. A failed replica is rebuilt at once, so
        every replica is live."""
        fits = [r for r in self.replicas if r.engine.allocator.can_admit(num_tokens)]
        if not fits:
            fits = [r for r in self.replicas
                    if any(p < priority for p in r.engine._priorities.values())]
        if not fits:
            return None
        return min(fits, key=lambda r: (r.engine.allocator.pages_in_use,
                                        r.engine.allocator.active_seqs, r.index))

    def _on_replica_evictions(self, replica: int, dslots) -> None:
        victims = [sid for sid, rec in self._seq.items()
                   if rec["stage"] == "decode" and rec["replica"] == replica
                   and rec["dslot"] in set(dslots)]
        for sid in victims:
            del self._seq[sid]
        self._evicted_sids.extend(victims)

    def _place_stream(self, ps: PendingStream) -> StreamReport | None:
        rec = self._seq.get(ps.sid)
        if rec is None:  # freed or evicted while parked
            return None
        rep = self._pick_replica(ps.length, rec["priority"])
        if rep is None:
            return None
        t0 = time.perf_counter()
        # reserve the destination first: a refused reservation costs no hop
        try:
            res = rep.engine.admit(ps.length, priority=rec["priority"])
        except PageAllocatorError:
            return None
        if res.evicted:
            self._on_replica_evictions(rep.index, res.evicted)
        if not res.admitted:
            return None
        dslot = res.slot
        n = max(self._prefill.allocator.pages_needed(ps.length), 1)
        src_pages = self._prefill.allocator.slot_pages(rec["pslot"])[:n]
        dst_pages = rep.engine.allocator.slot_pages(dslot)
        pk, pv = self._stream_pages(src_pages, rep, dst_pages[:n])
        assign_block_table(rep.engine.cache, dslot, dst_pages, keep_len=ps.length)
        rep.engine._lengths[dslot] = ps.length
        digest_ok = None
        if self.verify_streams:
            digest_ok = pages_digest(pk, pv) == pages_digest(
                *gather_pages(rep.engine.cache, dst_pages[:n]))
        # the prefill-side slot retires; pages the prefix trie registered
        # stay resident there for later forks
        self._prefill.free(rec["pslot"])
        rec.update(stage="decode", pslot=None, replica=rep.index, dslot=dslot)
        return StreamReport(sid=ps.sid, replica=rep.index, pages=n, tokens=ps.length,
                            nbytes=2 * pk.numel() * pk.element_size(), digest_ok=digest_ok,
                            duration_s=time.perf_counter() - t0)

    def _stream_pages(self, src_pages, rep: DecodeReplica, dst_pages):
        """The hop: the source pages gathered on the prefill device, each
        head slice copied to its shard's device (a real copy, whichever
        device that is), scattered into the replica's pool. Returns the
        gathered (K, V) payload."""
        src = self._prefill.cache
        idx = torch.as_tensor(src_pages, dtype=torch.long, device=src.device)
        pk, pv = src.k_pages.index_select(0, idx), src.v_pages.index_select(0, idx)
        for i, c in enumerate(shards_of(rep.engine.cache)):
            didx = torch.as_tensor(dst_pages, dtype=torch.long, device=c.device)
            h = slice(i * c.num_kv_heads, (i + 1) * c.num_kv_heads)
            c.k_pages[didx] = pk[:, :, h].to(c.device, copy=True)
            c.v_pages[didx] = pv[:, :, h].to(c.device, copy=True)
        return pk, pv

    # -- decode tier --

    def decode_step(self, q, k_new, v_new, sids, **kw):
        """One decode step over placed sequences, one engine step per
        replica. A replica-local failure (an injected ``decode_fault``, or a
        page-allocator failure during the replica's growth) fails only that
        replica: its sequences are torn down for replay and a
        :class:`DecodeTierFault` names them (the other replicas' tokens of
        this call are lost with it; the :class:`TieredScheduler` calls per
        replica). Outputs come back on ``q``'s device."""
        sid_list = [int(s) for s in sids]
        by_rep: dict[int, list[int]] = {}
        for pos, sid in enumerate(sid_list):
            by_rep.setdefault(self._require(sid, "decode")["replica"], []).append(pos)
        outs: list = [None] * len(sid_list)
        lses: list = [None] * len(sid_list)
        splits_seen: set[int] = set()
        for r, poss in sorted(by_rep.items()):
            rep = self.replicas[r]
            dslots = [self._seq[sid_list[p]]["dslot"] for p in poss]
            if len(by_rep) == 1:
                qs, ks, vs = q, k_new, v_new
            else:
                pidx = torch.as_tensor(poss, device=q.device)
                qs, ks, vs = q[pidx], k_new[pidx], v_new[pidx]
            dev = rep.devices[0]
            try:
                chaos.maybe_fail("decode_fault")
                o, l = rep.engine.decode_step(qs.to(dev), ks.to(dev), vs.to(dev), dslots, **kw)
            except (chaos.ChaosInjectedError, PageAllocatorError) as e:
                affected = self.fail_replica(r, reason=repr(e))
                raise DecodeTierFault(r, affected, repr(e)) from e
            if len(by_rep) == 1:  # rows in order: the replica's batch is the answer
                outs, lses = o, l
            else:
                for j, p in enumerate(poss):
                    outs[p], lses[p] = o[j], l[j]
            splits_seen.add(int(rep.engine.last_decode_info.get("num_splits", 0)))
        self.last_decode_info = {
            "batch": len(sid_list),
            "program": telemetry.decode_program_label(len(sid_list)),
            "num_splits": splits_seen.pop() if len(splits_seen) == 1 else 0,
            "cascade_groups": 0,
            "cascade_group_of": {},
            "replicas": sorted(by_rep),
        }
        if len(by_rep) == 1:
            return outs.to(q.device), lses.to(q.device)
        return (torch.stack([o.to(q.device) for o in outs]),
                torch.stack([l.to(q.device) for l in lses]))

    def fail_replica(self, index: int, *, reason: str = "") -> tuple:
        """Tear a decode replica down (its pool is lost) and rebuild it with
        a fresh pool on the same devices. Returns the sids it held, which
        lost their KV, for requeue and replay."""
        rep = self.replicas[index]
        affected = [sid for sid, rec in self._seq.items()
                    if rec["stage"] == "decode" and rec["replica"] == index]
        for sid in affected:
            del self._seq[sid]
        fresh = self._build_replica(index, rep.devices, rep.tp)
        fresh.restarts = rep.restarts + 1
        self.replicas[index] = fresh
        telemetry.record_tier_fault("decode", index)
        # deferred: the post-mortem holds the tick the fault killed
        self._flight.trigger("decode_tier_fault", immediate=False, replica=index,
                             sequences=len(affected), reason=reason)
        telemetry.get_logger("serving").warning(
            "decode replica %d failed (%s): %d sequences requeued for replay, replica rebuilt "
            "with a fresh pool", index, reason or "unspecified", len(affected))
        self._record_tiers()
        return tuple(affected)

    # -- retirement --

    def free(self, sid: int) -> None:
        """Retire a sequence wherever it lives: a decode replica's slot, a
        prefill slot, or a parked stream (queue entry and prefill slot)."""
        rec = self._require(sid)
        if rec["stage"] == "decode":
            self.replicas[rec["replica"]].engine.free(rec["dslot"])
        else:
            self._pending = [p for p in self._pending if p.sid != sid]
            self._prefill.free(rec["pslot"])
        del self._seq[int(sid)]
        telemetry.record_stream_queue_depth(len(self._pending))
        self._record_tiers()

    def _record_tiers(self) -> None:
        if not telemetry.enabled():  # off: no scan of the sequence records either
            return
        telemetry.record_tier_state(
            "prefill", pages_in_use=self._prefill.allocator.pages_in_use,
            active=sum(1 for rec in self._seq.values()
                       if rec["stage"] in ("prefill", "stream_queued")))
        decode_active = sum(1 for rec in self._seq.values() if rec["stage"] == "decode")
        for r in self.replicas:
            telemetry.record_tier_state("decode", replica=r.index,
                                        pages_in_use=r.engine.allocator.pages_in_use,
                                        active=decode_active)


# -- the tiered scheduler --------------------------------------------------------


class TieredScheduler(Scheduler):
    """Per-tier continuous batching over a :class:`TieredEngine`.

    The port's :class:`~.scheduler.Scheduler` with:

    - a token budget per tier (``MAGI_ATTENTION_TIER_BUDGET_PREFILL`` /
      ``_DECODE``; constructor arguments win): decode no longer spends the
      prefill budget, so decode-first holds per tier by construction;
    - one decode group per replica, so a :class:`DecodeTierFault` requeues
      exactly that replica's requests (``requeues`` ``("decode",
      "decode_fault")``) while the other replicas' tokens land;
    - the requeue of requests a decode-tier placement evicted;
    - knobs ``prefill_budget`` and ``decode_budget``;
    - the ``tier=`` label on every span and SLO sample, and each completed
      stream as ``pages_streamed`` + ``tier_migrated`` spans on its
      request's trace.

    ``last_stream_reports``: the :class:`StreamReport`s of the last tick.
    """

    _prefill_tier = "prefill"
    _decode_tier = "decode"

    def __init__(
        self,
        engine: TieredEngine,
        *,
        prefill_budget: int | None = None,
        decode_budget: int | None = None,
        chunk: int | None = None,
        max_decode_batch: int | None = None,
        clock=time.perf_counter,
        plan_probe=None,
    ):
        from .. import env

        self.prefill_budget = (int(prefill_budget) if prefill_budget is not None
                               else env.tier_token_budget("prefill"))
        self.decode_budget = (int(decode_budget) if decode_budget is not None
                              else env.tier_token_budget("decode"))
        super().__init__(engine, token_budget=self.prefill_budget + self.decode_budget,
                         chunk=chunk, max_decode_batch=max_decode_batch, clock=clock,
                         plan_probe=plan_probe)
        self.last_stream_reports: list[StreamReport] = []

    def _admission_headroom(self) -> int:
        # decode growth happens in the replicas' pools, not the prefill pool
        # admission draws from: only the watermark knob applies
        return self.admission_watermark

    # -- knobs --

    _KNOB_NAMES = Scheduler._KNOB_NAMES + ("prefill_budget", "decode_budget")

    def knobs(self) -> dict:
        return {**super().knobs(), "prefill_budget": self.prefill_budget,
                "decode_budget": self.decode_budget}

    def _knob_engines(self) -> list:
        return [self.engine._prefill] + [r.engine for r in self.engine.replicas]

    def _coerce_knob(self, name: str, value):
        if name in ("prefill_budget", "decode_budget"):
            v = int(value)
            if v < 1:
                raise ValueError(f"knob {name}={value!r} must be >= 1")
            return v
        return super()._coerce_knob(name, value)

    def _set_knob(self, name: str, value) -> None:
        super()._set_knob(name, value)
        if name in ("prefill_budget", "decode_budget"):
            self.token_budget = self.prefill_budget + self.decode_budget

    # -- decode, per replica --

    def _decode_states(self):
        # only sequences resident on the decode tier decode; a parked stream
        # waits for the next tick's pump
        return [st for st in self._active.values()
                if st.status == DECODING and self.engine.placed(st.slot)]

    def _run_decode(self, states) -> int:
        if self.max_decode_batch is not None:
            states = states[: self.max_decode_batch]
        by_rep: dict[int, list] = {}
        for st in states:
            by_rep.setdefault(self.engine.replica_of(st.slot), []).append(st)
        produced = 0
        for rep in sorted(by_rep):
            try:
                produced += self._decode_group(by_rep[rep], replica=rep)
            except DecodeTierFault as fault:
                self._requeue_fault(fault)
        return produced

    def _requeue_fault(self, fault: DecodeTierFault) -> None:
        """Requeue every request the failed replica held, for replay through
        the prefill tier (the prefix trie makes the re-prefill a fork)."""
        by_sid = {st.slot: st for st in list(self._active.values())}
        for sid in fault.sids:
            st = by_sid.get(sid)
            if st is not None:
                self._requeue(st, tier="decode", reason="decode_fault")

    # -- the tiered tick --

    def _take_tier_events(self) -> None:
        """The engine's completed streams (kept as this tick's
        ``last_stream_reports``, each a ``pages_streamed`` and a
        ``tier_migrated`` span on its request's trace) and decode-tier
        eviction victims, requeued."""
        reports = self.engine.take_stream_reports()
        self.last_stream_reports.extend(reports)
        by_sid = {st.slot: st for st in self._active.values()}
        for rep in reports:
            st = by_sid.get(rep.sid)
            if st is None:
                continue
            reqtrace.span_pages_streamed(
                st.trace_id, st.rid, pages=rep.pages, tokens=rep.tokens, nbytes=rep.nbytes,
                replica=rep.replica, digest_ok=rep.digest_ok, duration_s=rep.duration_s)
            reqtrace.span_tier_migrated(st.trace_id, st.rid, from_tier="prefill",
                                        to_tier="decode", replica=rep.replica)
        for sid in self.engine.take_evicted_sids():
            st = by_sid.get(sid)
            if st is not None:
                self._requeue(st, tier="decode", reason="priority_eviction")

    def _step_body(self, queue_depth: int) -> StepReport:
        self.last_stream_reports = []
        # parked streams first: decode capacity freed last tick serves this one
        self.engine.pump_streams()
        self._take_tier_events()
        admitted, rejected = self._admit_queued()
        finished_before = set(self._finished)
        decoding = self._decode_states()[: self.decode_budget]
        decode_batch = self._run_decode(decoding) if decoding else 0
        chunks, budget = self._run_prefill_loop(self.prefill_budget)
        # prompts completed this tick streamed inside engine.prefill
        self._take_tier_events()
        return self._report(admitted, rejected, finished_before, queue_depth, bool(decoding),
                            decode_batch, chunks, (self.prefill_budget - budget) + decode_batch)
