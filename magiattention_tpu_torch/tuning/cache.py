"""Tuning cache: the process's memory, backed by a directory on disk.

The port of the JAX package's ``tuning/cache.py``. Disk layout
(``MAGI_ATTENTION_AUTOTUNE_CACHE_DIR``): one JSON file a fingerprint,
``magi-autotune-<hash>.json``, holding the whole fingerprint (checked on
load: a truncated-hash collision or a version skew is a miss, not a wrong
winner), the winner and the diagnostics of the candidates it beat. Files
are written atomically (a temp file, then a rename), so processes sharing
a directory at worst tune again; they never read torn JSON. A disk fault
is a miss (or a skipped store) and one ``magi_tuning_cache_io_errors{op=}``;
the ``cache_io_error`` chaos injector fires at both sites.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

CACHE_FILE_PREFIX = "magi-autotune-"


def _record_io_error(op: str, key: str, exc: Exception) -> None:
    """A disk fault: ``magi_tuning_cache_io_errors{op=}`` and a debug line."""
    from ..telemetry import record_tuning_cache_io_error
    from ..telemetry.logger import get_logger

    record_tuning_cache_io_error(op)
    get_logger("tuning.cache").debug("tuning cache %s failed for %s: %s: %s", op, key,
                                     type(exc).__name__, exc)


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One cached winner for a fingerprint."""

    block_q: int
    block_k: int
    head_block: int
    source: str  # "model" | "measured" | "measure_failed"
    predicted_ms: float  # the cost model's estimate for the winner
    measured_ms: float | None  # its time on the card (measure mode only)
    candidates: tuple[dict, ...]  # the ranked candidates' diagnostics
    grid: str = "row_major"  # the winner's grid ("row_major" | "sparse")

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidates"] = [dict(c) for c in self.candidates]
        return d

    @staticmethod
    def from_dict(d: dict) -> "TuningRecord":
        return TuningRecord(
            block_q=int(d["block_q"]),
            block_k=int(d["block_k"]),
            head_block=int(d["head_block"]),
            source=str(d["source"]),
            predicted_ms=float(d["predicted_ms"]),
            measured_ms=float(d["measured_ms"]) if d.get("measured_ms") is not None else None,
            candidates=tuple(dict(c) for c in d.get("candidates", ())),
            grid=str(d.get("grid", "row_major")),
        )


class TuningCache:
    """fingerprint hash -> :class:`TuningRecord`, memory first."""

    def __init__(self, cache_dir: str | None = None):
        self.cache_dir = cache_dir or None
        self._mem: dict[str, TuningRecord] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{CACHE_FILE_PREFIX}{key}.json")

    def get(self, fp) -> tuple[TuningRecord | None, str]:
        """(record, layer), layer in {"memory", "disk", "miss"}; a disk hit
        is promoted to the memory layer."""
        key = fp.stable_hash()
        rec = self._mem.get(key)
        if rec is not None:
            return rec, "memory"
        if self.cache_dir:
            rec = self._load_disk(key, fp)
            if rec is not None:
                self._mem[key] = rec
                return rec, "disk"
        return None, "miss"

    def put(self, fp, rec: TuningRecord) -> None:
        key = fp.stable_hash()
        self._mem[key] = rec
        # measure_failed stays in this process: it stops it from relaunching
        # crashing candidates on every call; a fresh process should retry
        if self.cache_dir and rec.source != "measure_failed":
            self._store_disk(key, fp, rec)

    def _load_disk(self, key: str, fp) -> TuningRecord | None:
        from ..resilience import chaos

        try:
            chaos.maybe_fail("cache_io_error", op="load")
            with open(self._path(key)) as f:
                payload = json.load(f)
            if payload.get("fingerprint") != fp.as_dict():
                return None  # a hash collision or a fingerprint version skew
            return TuningRecord.from_dict(payload["record"])
        except FileNotFoundError:
            return None  # a cold cache is a miss, not a fault
        except (OSError, ValueError, KeyError, TypeError) as exc:
            _record_io_error("load", key, exc)
            return None

    def _store_disk(self, key: str, fp, rec: TuningRecord) -> None:
        from ..resilience import chaos

        try:
            chaos.maybe_fail("cache_io_error", op="store")
            os.makedirs(self.cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, prefix=CACHE_FILE_PREFIX,
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"fingerprint": fp.as_dict(), "record": rec.as_dict()}, f,
                          sort_keys=True)
            os.replace(tmp, self._path(key))
        except OSError as exc:
            # a read-only directory must never take planning down
            _record_io_error("store", key, exc)

    def __len__(self) -> int:
        return len(self._mem)


_cache: TuningCache | None = None


def get_tuning_cache() -> TuningCache:
    """The process's cache, rebuilt when ``MAGI_ATTENTION_AUTOTUNE_CACHE_DIR``
    changes."""
    global _cache
    from .. import env

    want = env.autotune_cache_dir() or None
    if _cache is None or _cache.cache_dir != want:
        _cache = TuningCache(want)
    return _cache


def reset_tuning_cache() -> None:
    """Drop the process's cache and the memos of the decisions taken from
    it: the split tuners', the flex choice's and the keyed API's per-group
    blocking (disk files are left alone). Every rank of a group resets, as
    every rank makes the group's keyed calls."""
    global _cache
    from . import autotuner

    _cache = None
    autotuner._MEMO.clear()
    autotuner._AGREED.clear()
