"""Workload fingerprints: the tuning cache's key space.

The port of the JAX package's ``tuning/fingerprint.py``. A fingerprint
holds everything the cost model's answer depends on (problem extents, head
configuration, dtype, and mask-shape statistics of the slice ranges) as
integers only (log2 / milli buckets), so its stable hash is the same in
every process and nearly identical workloads (a few tokens of drift in a
varlen batch) share a cache entry instead of tuning again.

Two fields are the port's own: ``generation`` is the card's name
(``utils/cost.current_card``; ``"cpu"`` on the CPU), where the reference
keys its TPU generation, and ``backend`` is the kernel backend at the
device type, so a winner measured on the CPU is never served to the card.
The per-tile entry estimates count over the port's tiles
(``ops/flex_attn.HOPPER_TILES``), not the reference's TPU rungs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from functools import cached_property


def _log2_bucket(x: float, per_octave: int = 8) -> int:
    """log2 of ``x`` quantized to ``per_octave`` steps per octave (0 for
    x <= 0): a ~9% relative bucket, coarse enough to absorb token-count
    jitter, fine enough to separate different shapes."""
    if x <= 0:
        return 0
    return int(round(math.log2(x) * per_octave))


def _stable_hash(payload: dict) -> str:
    text = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()[:24]


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None is the card when there is
    one, else the CPU."""
    import torch

    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_identity(device=None) -> tuple[str, str]:
    """(generation, backend) of the fingerprints for ``device``: the card's
    name (``"cpu"`` on the CPU) and ``"<kernel backend>@<device type>"``."""
    from .. import env

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..utils.cost import current_card

        generation = current_card(dev)
    else:
        generation = dev.type
    return generation, f"{env.kernel_backend()}@{dev.type}"


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` and ``"bfloat16"`` both name ``"bfloat16"``."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class WorkloadFingerprint:
    """Hashable workload identity for the tuning cache."""

    version: int
    generation: str  # the card's name ("cpu" on the CPU): winners are card-specific
    backend: str  # kernel backend @ device type: a CPU winner never serves the card
    total_q: int
    total_k: int
    num_heads_q: int
    num_heads_kv: int
    head_dim: int
    dtype: str
    num_slices: int
    covered_frac_milli: int  # unmasked area / (tq * tk), in 1/1000
    mean_k_width_bucket: int  # log2 bucket of the mean slice k-width
    max_k_width_bucket: int
    mean_q_width_bucket: int
    causal_frac_milli: int  # slices with a causal / inv-causal bound
    max_block_q: int  # the caller's shard constraint (0 = unconstrained)
    max_block_k: int
    entry_est: tuple[tuple[int, int, int], ...]  # (bq, bk, bucketed entries)
    # the row skew (most entries of a q block, bucketed) that decides the
    # sparse grid against the row-major one, and the sparse grid's entries
    step_est: tuple[tuple[int, int, int], ...] = ()
    sparse_entry_est: tuple[tuple[int, int, int], ...] = ()
    # whether the sparse grid was in the ranking this key describes: a
    # row-major-only decision and a full one for the same mask differ
    sparse_rungs: int = 1

    FINGERPRINT_VERSION = 3

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for name in ("entry_est", "step_est", "sparse_entry_est"):
            d[name] = [list(e) for e in getattr(self, name)]
        return d

    @cached_property
    def _hash(self) -> str:
        return _stable_hash(self.as_dict())

    def stable_hash(self) -> str:
        """Process-independent content hash (the disk cache's file key)."""
        return self._hash


def make_fingerprint(
    q_ranges,
    k_ranges,
    attn_type_map,
    hq: int,
    hk: int,
    *,
    head_dim: int = 128,
    dtype: str = "bfloat16",
    max_block_q: int | None = None,
    max_block_k: int | None = None,
    include_sparse: bool = True,
    device=None,
) -> WorkloadFingerprint:
    """The fingerprint of host-side slice ranges on ``device`` (default:
    the card, else the CPU).

    Degenerate slices are dropped before any statistic is taken, as the
    cost model drops them, so sentinel-padded range lists fingerprint like
    their clean equivalents. Memoised on the canonical slice digest: a
    repeat plan pays a dict hit."""
    from .cost_model import _normalize_slices, slices_digest

    q, k, t = _normalize_slices(q_ranges, k_ranges, attn_type_map)
    generation, backend = device_identity(device)
    key = (
        slices_digest(q, k, t),
        generation,
        backend,
        int(hq),
        int(hk),
        int(head_dim),
        _dtype_name(dtype),
        int(max_block_q or 0),
        int(max_block_k or 0),
        int(bool(include_sparse)),
    )
    fp = _FP_MEMO.get(key)
    if fp is None:
        if len(_FP_MEMO) >= _FP_MEMO_CAP:  # a crude bound: never grows past it
            _FP_MEMO.clear()
        fp = _FP_MEMO[key] = _make_fingerprint_impl(q, k, t, *key[1:])
    return fp


# digest-keyed, so per-batch-unique varlen masks pin no range arrays
_FP_MEMO: dict = {}
_FP_MEMO_CAP = 512


@dataclasses.dataclass(frozen=True)
class DecodeFingerprint:
    """Workload identity of the ``decode`` tuning kind: split-KV decode is
    described by (batch, page geometry, heads, dtype), bucketed like the
    flex fingerprint so jittery batch sizes share an entry; ``kind`` keeps
    its records apart from flex records in the shared cache."""

    kind: str
    version: int
    generation: str
    backend: str
    batch_bucket: int  # log2 bucket of the decode batch size
    num_heads_q: int
    num_heads_kv: int
    head_dim: int
    dtype: str
    page_size: int
    max_pages_bucket: int  # log2 bucket of max_pages_per_seq
    # 0 = flat decode; else 1 + the log2 bucket of the cascade's shared-prefix
    # group count (the prefix phase reads one hot page set for the batch)
    prefix_groups_bucket: int = 0

    DECODE_FINGERPRINT_VERSION = 2

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def stable_hash(self) -> str:
        return _stable_hash(self.as_dict())


def make_decode_fingerprint(
    batch: int,
    max_pages_per_seq: int,
    page_size: int,
    hq: int,
    hk: int,
    *,
    head_dim: int = 128,
    dtype: str = "bfloat16",
    prefix_groups: int = 0,
    device=None,
) -> DecodeFingerprint:
    """The decode-kind fingerprint (host integers only)."""
    generation, backend = device_identity(device)
    return DecodeFingerprint(
        kind="decode",
        version=DecodeFingerprint.DECODE_FINGERPRINT_VERSION,
        generation=generation,
        backend=backend,
        batch_bucket=_log2_bucket(batch),
        num_heads_q=int(hq),
        num_heads_kv=int(hk),
        head_dim=int(head_dim),
        dtype=_dtype_name(dtype),
        page_size=int(page_size),
        max_pages_bucket=_log2_bucket(max_pages_per_seq),
        prefix_groups_bucket=0 if prefix_groups <= 0 else 1 + _log2_bucket(prefix_groups),
    )


@dataclasses.dataclass(frozen=True)
class TickFingerprint:
    """Workload identity of the ``tick`` tuning kind: the unified serving
    tick's padded geometry (row and entry capacity buckets) with its heads,
    dtype and page size; ``prefill_rows_bucket`` keeps decode-dominated and
    prefill-dominated ticks apart."""

    kind: str
    version: int
    generation: str
    backend: str
    row_bucket: int  # log2 bucket of the padded row capacity
    entry_bucket: int  # log2 bucket of the padded entry capacity
    num_heads_q: int
    num_heads_kv: int
    head_dim: int
    dtype: str
    page_size: int
    prefill_rows_bucket: int  # 0 = decode-only; else 1 + log2 bucket

    TICK_FINGERPRINT_VERSION = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def stable_hash(self) -> str:
        return _stable_hash(self.as_dict())


def make_tick_fingerprint(
    row_capacity: int,
    entry_capacity: int,
    page_size: int,
    hq: int,
    hk: int,
    *,
    head_dim: int = 128,
    dtype: str = "bfloat16",
    prefill_rows: int = 0,
    device=None,
) -> TickFingerprint:
    """The tick-kind fingerprint (host integers only)."""
    generation, backend = device_identity(device)
    return TickFingerprint(
        kind="tick",
        version=TickFingerprint.TICK_FINGERPRINT_VERSION,
        generation=generation,
        backend=backend,
        row_bucket=_log2_bucket(row_capacity),
        entry_bucket=_log2_bucket(entry_capacity),
        num_heads_q=int(hq),
        num_heads_kv=int(hk),
        head_dim=int(head_dim),
        dtype=_dtype_name(dtype),
        page_size=int(page_size),
        prefill_rows_bucket=0 if prefill_rows <= 0 else 1 + _log2_bucket(prefill_rows),
    )


def _make_fingerprint_impl(q, k, t, generation: str, backend: str, hq: int, hk: int,
                           head_dim: int, dtype: str, max_block_q: int, max_block_k: int,
                           sparse_rungs: int) -> WorkloadFingerprint:
    import numpy as np

    from .cost_model import candidate_tiles, estimate_entries, exact_mask_area

    total_q = int(q[:, 1].max()) if q.size else 0
    total_k = int(k[:, 1].max()) if k.size else 0
    area = exact_mask_area(q, k, t)
    denom = max(total_q * total_k, 1)
    k_widths = (k[:, 1] - k[:, 0]) if k.size else np.zeros(1, np.int64)
    q_widths = (q[:, 1] - q[:, 0]) if q.size else np.zeros(1, np.int64)
    n = max(int(t.shape[0]), 1)
    causal = int(((t & 1) | ((t & 2) >> 1)).sum())
    tiles = candidate_tiles(head_dim)
    counts = {(bq, bk): estimate_entries(q, k, t, bq, bk) for bq, bk in tiles}
    entry_est = tuple((bq, bk, _log2_bucket(counts[bq, bk][0])) for bq, bk in tiles)
    step_est = tuple((bq, bk, _log2_bucket(counts[bq, bk][1])) for bq, bk in tiles)
    return WorkloadFingerprint(
        version=WorkloadFingerprint.FINGERPRINT_VERSION,
        generation=generation,
        backend=backend,
        total_q=_log2_bucket(total_q),
        total_k=_log2_bucket(total_k),
        num_heads_q=int(hq),
        num_heads_kv=int(hk),
        head_dim=int(head_dim),
        dtype=str(dtype),
        num_slices=_log2_bucket(n),
        covered_frac_milli=int(round(1000.0 * area / denom)),
        mean_k_width_bucket=_log2_bucket(float(k_widths.mean())),
        max_k_width_bucket=_log2_bucket(float(k_widths.max())),
        mean_q_width_bucket=_log2_bucket(float(q_widths.mean())),
        causal_frac_milli=int(round(1000.0 * causal / n)),
        max_block_q=max_block_q,
        max_block_k=max_block_k,
        entry_est=entry_est,
        step_est=step_est,
        sparse_entry_est=entry_est if sparse_rungs else (),
        sparse_rungs=sparse_rungs,
    )
