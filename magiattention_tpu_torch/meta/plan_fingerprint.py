"""Fingerprint-bucketed plan reuse: mask canonicalisation and the
second-level plan cache.

The port's copy of the JAX package's ``meta/plan_fingerprint.py`` (host
numpy). A stream of masks that differ by a few tokens (a +1 extend, a
packed batch whose documents move, a jittery decode batch) misses the
exact-key runtime cache every call, and every miss pays the dispatch
solve, the overlap solve and the plan build. Planning per *shape class*
instead: near-identical masks canonicalise onto a bucket grid, share ONE
canonical plan, and each request's real rows are mapped onto that plan's
tables, the pad rows riding the trash-slot convention.

- :func:`bucket_len`: pow2-ish length quantisation (4 mantissa steps per
  octave, < 25% relative padding; exact up to 8).
- :func:`canonicalize_mask`: cut the sequence at every slice boundary, pad
  each segment's tail to its bucket, then force a pad to zero wherever a
  real query would attend it (a pad key adds exp(0 - max) to the softmax
  denominator). Pad queries are harmless: their outputs are dropped at
  undispatch.
- :class:`RowMaps`: real <-> canonical position maps, with an O(delta)
  tail extend (the incremental path).
- :class:`PlanFingerprint`: the canonical mask and every non-mask axis of
  the port's ``DistAttnRuntimeKey``; :class:`PlanReuseCache`: the
  fingerprint-keyed LRU in front of the cold solver.

Pad soundness per slice (mask types FULL=0 CAUSAL=1 INVCAUSAL=2
BICAUSAL=3; CAUSAL is bottom-right aligned, INVCAUSAL top-left):

- a segment interior to a slice's q or k range: pad forced 0 (it would
  shift the real rows of one range by different amounts);
- FULL: the k range's tail pad forced 0 (all its keys are attended);
- CAUSAL: the tail pads survive only when the q and k ranges share their
  last segment (then Kpad == Qpad and the bottom-right diagonal holds for
  every real row); distinct tails are forced 0;
- INVCAUSAL: the k tail forced 0; the q tail survives;
- BICAUSAL: both tails forced 0.

Uncovered segments pad freely. Every rule only forces pads to zero, so
one pass is a fixpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np

from .. import env

FULL, CAUSAL, INVCAUSAL, BICAUSAL = 0, 1, 2, 3


def bucket_len(n: int) -> int:
    """The smallest pow2-ish grid length >= ``n``: exact for n <= 8, then
    ``m * 2^e`` with mantissa m in {5, 6, 7, 8} (4 steps per octave, so a
    tail pad never exceeds 25%)."""
    n = int(n)
    if n <= 0:
        return 0
    if n <= 8:
        return n
    e = (n - 1).bit_length()  # 2^e is the smallest power of two >= n
    return min(m << (e - 3) for m in (5, 6, 7, 8) if (m << (e - 3)) >= n)


@dataclasses.dataclass(frozen=True)
class CanonicalMask:
    """A mask in bucketed coordinates.

    ``segments`` are the real-coordinate cuts ``(start, length, pad)`` in
    order; canonical coordinates are the cumulative ``length + pad``
    offsets. Canonical slice ranges cover whole buckets (tail pads
    included): that is what makes every same-bucket mask canonicalise to
    the same ranges, and why the pad-soundness rules above matter.
    """

    q_ranges: tuple[tuple[int, int], ...]
    k_ranges: tuple[tuple[int, int], ...]
    attn_type_map: tuple[int, ...]
    total_seqlen: int
    segments: tuple[tuple[int, int, int], ...]
    real_total: int

    @property
    def identity(self) -> bool:
        """No pad anywhere: canonical == real coordinates, so bucketing
        adds nothing over the exact-key cache."""
        return self.total_seqlen == self.real_total

    def build_row_maps(self) -> "RowMaps":
        return RowMaps.from_segments(self.segments, self.real_total, self.total_seqlen)


class RowMaps:
    """real <-> canonical position maps with an O(delta) tail extend.

    ``real_to_canon`` is allocated at the full canonical capacity, so a
    same-bucket tail extend patches ``delta`` entries in place;
    ``canon_to_real`` holds -1 on pad rows.
    """

    def __init__(self, real_buf: np.ndarray, real_len: int, canon_to_real: np.ndarray,
                 canon_total: int):
        self._real_buf = real_buf
        self.real_len = int(real_len)
        self.canon_to_real = canon_to_real
        self.canon_total = int(canon_total)

    @classmethod
    def from_segments(cls, segments: Sequence[tuple[int, int, int]], real_total: int,
                      canon_total: int) -> "RowMaps":
        real_buf = np.full(canon_total, -1, np.int64)
        canon_to_real = np.full(canon_total, -1, np.int64)
        off = 0
        for start, length, pad in segments:
            real_buf[start : start + length] = off + np.arange(length)
            canon_to_real[off : off + length] = start + np.arange(length)
            off += length + pad
        if off != canon_total:
            raise ValueError(f"segment cover {off} != canonical total {canon_total} "
                             f"(segments={list(segments)})")
        return cls(real_buf, real_total, canon_to_real, canon_total)

    @property
    def real_to_canon(self) -> np.ndarray:
        return self._real_buf[: self.real_len]

    def extend_tail(self, delta: int) -> None:
        """Grow the last segment by ``delta`` real rows into its pad (the
        caller checks that the extension stays inside the bucket:
        :func:`try_incremental_update`)."""
        last_real = self.real_len
        last_canon = int(self._real_buf[last_real - 1]) + 1
        self._real_buf[last_real : last_real + delta] = last_canon + np.arange(delta)
        self.canon_to_real[last_canon : last_canon + delta] = last_real + np.arange(delta)
        self.real_len += delta


MaskSig = tuple[tuple, tuple, tuple, int]  # (q_ranges, k_ranges, types, real total)


def canonicalize_mask(
    q_ranges: Sequence[Sequence[int]],
    k_ranges: Sequence[Sequence[int]],
    attn_type_map: Sequence[int],
    total_seqlen: int,
) -> Optional[CanonicalMask]:
    """A self-attention mask in bucketed coordinates, or ``None`` when
    bucketing cannot help: out-of-bounds input (the exact path raises its
    own errors), no slices, or every pad forced to zero (an identity mask
    resolves through the exact-key cache, where the canonical plan also
    lives, so an on-grid request still hits)."""
    total = int(total_seqlen)
    if total <= 0:
        return None
    slices = []
    for (q0, q1), (k0, k1), t in zip(q_ranges, k_ranges, attn_type_map):
        q0, q1, k0, k1, t = int(q0), int(q1), int(k0), int(k1), int(t)
        if not (0 <= q0 <= q1 <= total and 0 <= k0 <= k1 <= total):
            return None
        if t not in (FULL, CAUSAL, INVCAUSAL, BICAUSAL):
            return None
        if q0 == q1 or k0 == k1:
            continue  # an empty slice imposes nothing
        slices.append((q0, q1, k0, k1, t))
    if not slices:
        return None

    bounds = sorted({0, total} | {s[0] for s in slices} | {s[1] for s in slices}
                    | {s[2] for s in slices} | {s[3] for s in slices})
    starts = bounds[:-1]
    seg_of = {b: i for i, b in enumerate(starts)}
    lens = [bounds[i + 1] - bounds[i] for i in range(len(starts))]
    pads = [bucket_len(ln) - ln for ln in lens]

    for q0, q1, k0, k1, t in slices:
        qa, qb = seg_of[q0], seg_of[q1] if q1 < total else len(starts)
        ka, kb = seg_of[k0], seg_of[k1] if k1 < total else len(starts)
        for i in range(qa, qb - 1):  # interior q segments
            pads[i] = 0
        for i in range(ka, kb - 1):  # interior k segments
            pads[i] = 0
        q_tail, k_tail = qb - 1, kb - 1
        if t == FULL:
            pads[k_tail] = 0
        elif t == CAUSAL:
            if q_tail != k_tail:
                pads[q_tail] = 0
                pads[k_tail] = 0
        elif t == INVCAUSAL:
            pads[k_tail] = 0
        else:  # BICAUSAL
            pads[q_tail] = 0
            pads[k_tail] = 0

    if not any(pads):
        return None

    canon_start = {}
    off = 0
    for i, b in enumerate(starts):
        canon_start[b] = off
        off += lens[i] + pads[i]
    canon_start[total] = off

    return CanonicalMask(
        q_ranges=tuple((canon_start[s[0]], canon_start[s[1]]) for s in slices),
        k_ranges=tuple((canon_start[s[2]], canon_start[s[3]]) for s in slices),
        attn_type_map=tuple(s[4] for s in slices),
        total_seqlen=off,
        segments=tuple((starts[i], lens[i], pads[i]) for i in range(len(starts))),
        real_total=total,
    )


def try_incremental_update(prev_sig: MaskSig, new_sig: MaskSig, maps: RowMaps) -> bool:
    """O(delta) patch of ``maps`` for a tail extend (decode or chunked
    prefill growth): the new mask must be the old one with every range end
    at the old total moved to the new total, the growth staying inside the
    last segment's bucket. Patches ``maps`` in place and returns True, or
    returns False on any other change, a cross-bucket extension included
    (the caller then rebuilds the maps: still no solver)."""
    pq, pk, pt, ptot = prev_sig
    nq, nk, nt, ntot = new_sig
    delta = ntot - ptot
    if delta <= 0 or nt != pt or len(nq) != len(pq):
        return False
    if maps.real_len != ptot:
        return False
    headroom = maps.canon_total - int(maps.real_to_canon[ptot - 1]) - 1
    if delta > headroom:
        return False  # crosses the bucket boundary

    def grows(old: tuple, new: tuple) -> bool:
        (o0, o1), (n0, n1) = old, new
        if o0 != n0:
            return False
        if o1 == n1:
            return True
        return o1 == ptot and n1 == ntot

    if not all(grows(o, n) for o, n in zip(pq, nq)):
        return False
    if not all(grows(o, n) for o, n in zip(pk, nk)):
        return False
    if not any(o != n for o, n in zip(pq + pk, nq + nk)):
        return False  # the total grew but no range followed: not an extend
    maps.extend_tail(delta)
    return True


@dataclasses.dataclass(frozen=True)
class PlanFingerprint:
    """Identity of one bucketed plan: the canonical mask and every
    non-mask field of a ``DistAttnRuntimeKey`` (two requests share a
    canonical plan only if they would share everything but the exact
    mask). The port's key fields stand in for the JAX package's:
    ``group_id`` for its mesh id, ``device``, ``block_config`` and ``hier``
    for its ``interpret`` and ``cp_axis``."""

    version: int
    canon_q_ranges: tuple[tuple[int, int], ...]
    canon_k_ranges: tuple[tuple[int, int], ...]
    attn_type_map: tuple[int, ...]
    canon_total: int
    chunk_size: int
    cp_size: int
    hier: Optional[tuple[int, int]]
    num_heads_q: int
    num_heads_kv: int
    head_dim: int
    softcap: float
    has_sink: bool
    sink_fingerprint: int
    out_dtype: str
    dispatch_config_repr: str
    device: str
    block_config: tuple[int, int, int]
    group_id: int
    flags: tuple

    FINGERPRINT_VERSION = 1

    def stable_hash(self) -> str:
        """A content hash for logs (the cache keys on the dataclass)."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True, separators=(",", ":"),
                             default=repr)
        return hashlib.sha256(payload.encode()).hexdigest()[:24]


def make_plan_fingerprint(
    canon: CanonicalMask,
    *,
    chunk_size: int,
    cp_size: int,
    hier,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int,
    softcap: float,
    has_sink: bool,
    sink_fingerprint: int,
    out_dtype: str,
    dispatch_config_repr: str,
    device: str,
    block_config: tuple[int, int, int],
    group_id: int,
    flags: tuple,
) -> PlanFingerprint:
    return PlanFingerprint(
        version=PlanFingerprint.FINGERPRINT_VERSION,
        canon_q_ranges=canon.q_ranges,
        canon_k_ranges=canon.k_ranges,
        attn_type_map=canon.attn_type_map,
        canon_total=canon.total_seqlen,
        chunk_size=int(chunk_size),
        cp_size=int(cp_size),
        hier=None if hier is None else tuple(int(n) for n in hier),
        num_heads_q=int(num_heads_q),
        num_heads_kv=int(num_heads_kv),
        head_dim=int(head_dim),
        softcap=float(softcap),
        has_sink=bool(has_sink),
        sink_fingerprint=int(sink_fingerprint),
        out_dtype=str(out_dtype),
        dispatch_config_repr=str(dispatch_config_repr),
        device=str(device),
        block_config=tuple(int(b) for b in block_config),
        group_id=int(group_id),
        flags=tuple(flags),
    )


@dataclasses.dataclass
class ReuseEntry:
    """One fingerprint's resolution: the canonical plan's runtime key, and
    the last request's mask and maps (the incremental path's baseline)."""

    canonical_key: Any
    last_sig: Optional[MaskSig] = None
    last_maps: Optional[RowMaps] = None


class PlanReuseCache:
    """Fingerprint-keyed LRU in front of the cold solver. The capacity
    defaults to ``env.plan_cache_size()``, read at each use so that a
    test may set the variable after import."""

    def __init__(self, capacity: Optional[int] = None):
        self._capacity = capacity
        self._d: "OrderedDict[PlanFingerprint, ReuseEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def capacity(self) -> int:
        return self._capacity if self._capacity is not None else env.plan_cache_size()

    def get(self, fp: PlanFingerprint) -> Optional[ReuseEntry]:
        entry = self._d.get(fp)
        if entry is None:
            self.misses += 1
            return None
        self._d.move_to_end(fp)
        self.hits += 1
        return entry

    def put(self, fp: PlanFingerprint, entry: ReuseEntry) -> None:
        from .. import telemetry

        self._d[fp] = entry
        self._d.move_to_end(fp)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            telemetry.record_plan_cache_eviction(cache="fingerprint")

    def __contains__(self, fp: PlanFingerprint) -> bool:
        return fp in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self, group_id: Optional[int] = None) -> None:
        """Drop every entry, or those fingerprinted over one group (as
        ``DistAttnRuntimeDict.clear`` does, so that ``clear_cache(group)``
        drops both levels alike)."""
        if group_id is not None:
            for fp in [f for f in self._d if f.group_id == group_id]:
                del self._d[fp]
            return
        self._d.clear()
        self.hits = 0
        self.misses = 0
