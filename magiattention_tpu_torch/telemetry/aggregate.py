"""Cross-rank telemetry aggregation: N snapshots -> one mesh-wide view.

The JAX package's ``telemetry/aggregate.py``. The registry is process-local
by design (each rank records what *it* did); with one process per cp rank
every rank holds its own snapshot and nobody sees the whole picture —
per-rank comm skew, straggler plan builds, rank-divergent choices. This
module is the pure-Python merge layer:

- :func:`merge_snapshots` — fold N registry snapshots into one aggregate:
  counters sum, gauges keep per-rank values plus min/max/mean/argmax skew
  stats, histograms merge bucket-wise (identical bounds) with percentiles
  re-estimated on the merged buckets.
- :func:`aggregate_across_mesh` — the distributed entry point: a
  ``torch.distributed.all_gather_object`` of each rank's snapshot over a
  group, a loopback single-snapshot merge in a single process. Host-side;
  call it between steps.
- :func:`merge_chrome_traces` — lay N ranks' span-event traces into one
  Chrome trace, one rank per track (pid = rank) with ``process_name`` /
  ``thread_name`` metadata events so Perfetto labels the tracks.

Everything here is plain-dict in, plain-dict out, deterministically
ordered (sorted keys, ranks in ascending order), so aggregates diff
cleanly and tests can assert on exact JSON.
"""

from __future__ import annotations

from typing import Sequence

from .registry import estimate_percentiles

# a snapshot from a rank with telemetry disabled (or that recorded
# nothing) is `{}` or has empty sections; it still counts toward
# num_ranks but contributes no series and is excluded from skew stats


def _sections(snap: dict) -> tuple[dict, dict, dict]:
    snap = snap or {}
    return (
        snap.get("counters", {}) or {},
        snap.get("gauges", {}) or {},
        snap.get("histograms", {}) or {},
    )


def _merge_histogram_series(per_rank: dict) -> dict:
    """Fold one histogram series' per-rank dicts (registry ``as_dict``
    layout) into a single mesh-wide histogram dict.

    Bucket-wise merge requires identical bounds on every contributing
    rank; ranks normally share the collector code so this is the common
    case. Mismatched bounds (e.g. ranks running different builds) degrade
    to the scalar stats only, with ``bounds``/``bucket_counts`` set to
    None and a ``note`` explaining why — never an exception.
    """
    ranks = sorted(per_rank)
    hs = [per_rank[r] for r in ranks]
    count = sum(int(h.get("count", 0)) for h in hs)
    total = sum(float(h.get("sum", 0.0)) for h in hs)
    mins = [h["min"] for h in hs if h.get("min") is not None]
    maxs = [h["max"] for h in hs if h.get("max") is not None]
    out = {
        "count": count,
        "sum": total,
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "mean": (total / count) if count else None,
        "ranks": [str(r) for r in ranks],
    }
    bounds_set = {tuple(h.get("bounds") or ()) for h in hs}
    if len(bounds_set) != 1:
        out["bounds"] = None
        out["bucket_counts"] = None
        out["p50"] = out["p95"] = out["p99"] = None
        out["note"] = (
            "bucket bounds differ across ranks; bucket-wise merge and "
            "percentile estimation skipped"
        )
        return out
    bounds = list(bounds_set.pop())
    n_buckets = len(bounds) + 1
    merged = [0] * n_buckets
    for h in hs:
        bc = h.get("bucket_counts") or []
        for i in range(min(len(bc), n_buckets)):
            merged[i] += int(bc[i])
    out["bounds"] = bounds
    out["bucket_counts"] = merged
    if count:
        p50, p95, p99 = estimate_percentiles(
            bounds, merged, count, out["min"], out["max"]
        )
    else:
        p50 = p95 = p99 = None
    out["p50"], out["p95"], out["p99"] = p50, p95, p99
    return out


def merge_snapshots(
    snapshots: Sequence[dict],
    ranks: Sequence[int | str] | None = None,
) -> dict:
    """Merge N per-rank registry snapshots into one aggregate dict.

    ``ranks`` labels each snapshot (defaults to its position). Semantics
    per section:

    - **counters**: summed across ranks (monotonic totals stay totals).
    - **gauges**: point-in-time values cannot be meaningfully summed, so
      every series keeps its ``per_rank`` values plus skew statistics:
      min / max / mean over the ranks that reported it, and ``argmax`` —
      the rank holding the max (the straggler/outlier finder). A series
      only some ranks report (e.g. a labeled ``{rank=...}`` family from a
      plan built on rank 0 only) aggregates over the reporting subset.
    - **histograms**: merged bucket-wise (see
      :func:`_merge_histogram_series`).

    Per-rank *labels inside* a series key (e.g. each rank's own view of
    ``magi_comm_recv_rows{rank=0}``) never collide with the outer rank id:
    the merge nests values under ``per_rank[<outer rank>]`` and leaves the
    series key untouched, so rank 1's opinion of ``{rank=0}`` stays
    distinct from rank 0's.

    Output is deterministically ordered (series keys sorted, ranks
    ascending) and JSON-serializable.
    """
    snaps = list(snapshots)
    if ranks is None:
        rank_ids: list = list(range(len(snaps)))
    else:
        rank_ids = list(ranks)
        if len(rank_ids) != len(snaps):
            raise ValueError(
                f"ranks ({len(rank_ids)}) must label snapshots "
                f"({len(snaps)}) one-to-one"
            )

    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    histograms: dict[str, dict] = {}
    for rank, snap in zip(rank_ids, snaps):
        c, g, h = _sections(snap)
        for k, v in c.items():
            counters[k] = counters.get(k, 0.0) + v
        for k, v in g.items():
            gauges.setdefault(k, {})[rank] = v
        for k, v in h.items():
            histograms.setdefault(k, {})[rank] = v

    gauges_out: dict[str, dict] = {}
    for k in sorted(gauges):
        per_rank = gauges[k]
        # ints sort numerically before any string rank ids (mixed callers)
        rs = sorted(
            per_rank,
            key=lambda r: (0, r, "") if isinstance(r, int) else (1, 0, str(r)),
        )
        vals = [per_rank[r] for r in rs]
        argmax = max(zip(vals, rs), key=lambda t: t[0])[1]
        gauges_out[k] = {
            "per_rank": {str(r): per_rank[r] for r in rs},
            "min": min(vals),
            "max": max(vals),
            "mean": sum(vals) / len(vals),
            "argmax": str(argmax),
        }

    return {
        "num_ranks": len(snaps),
        "ranks": [str(r) for r in rank_ids],
        "counters": {k: counters[k] for k in sorted(counters)},
        "gauges": gauges_out,
        "histograms": {
            k: _merge_histogram_series(histograms[k])
            for k in sorted(histograms)
        },
    }


def aggregate_across_mesh(snapshot: dict | None = None, group=None) -> dict:
    """Gather every rank's registry snapshot and merge them.

    One process (no initialised ``torch.distributed``, or a one-rank
    group): loopback, the local snapshot merged alone, so callers get one
    code path and the aggregate schema everywhere. Several ranks: each
    rank's snapshot rides one ``torch.distributed.all_gather_object`` over
    ``group`` (default: the default group), and every rank returns the same
    aggregate, keyed by its rank in that group. Each rank keeps its own
    registry: this is the only merged view. Host-side; a collective, so
    every rank of the group must call it.
    """
    from .registry import get_registry

    if snapshot is None:
        snapshot = get_registry().snapshot()
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return merge_snapshots([snapshot], ranks=[0])
    world = dist.get_world_size(group)
    if world <= 1:
        return merge_snapshots([snapshot], ranks=[0])
    snaps: list = [None] * world
    dist.all_gather_object(snaps, snapshot, group=group)
    return merge_snapshots(snaps, ranks=list(range(world)))


def merge_chrome_traces(
    traces: Sequence[dict | list],
    labels: Sequence[str] | None = None,
) -> dict:
    """Merge N ranks' Chrome trace-event payloads into one multi-track
    trace: rank i's events land on pid ``i`` with a ``process_name``
    metadata event labeling the track (default ``rank <i>``) and a
    ``process_sort_index`` pinning top-to-bottom rank order, plus
    ``thread_name`` metadata per thread. Accepts either the
    ``{"traceEvents": [...]}`` payload ``dump_events`` writes or a bare
    event list. Rank-local metadata events are dropped and re-emitted
    against the remapped pids — with the rank's own ``thread_name``
    labels preserved, so named synthetic tracks (the per-hop comm spans)
    stay one distinctly-named track per rank x hop after the merge.
    """
    from .events import trace_metadata_events

    merged: list[dict] = []
    for i, tr in enumerate(traces):
        events = tr.get("traceEvents", []) if isinstance(tr, dict) else tr
        label = labels[i] if labels is not None else f"rank {i}"
        body = []
        tnames: dict[int, str] = {}
        for ev in events:
            if ev.get("ph") == "M":
                # harvest the rank-local track names; everything else is
                # re-derived below against the remapped pid
                if ev.get("name") == "thread_name":
                    name = (ev.get("args") or {}).get("name")
                    if name:
                        tnames[ev.get("tid", 0)] = name
                continue
            e = dict(ev)
            e["pid"] = i
            body.append(e)
        merged.append(
            {
                "name": "process_sort_index",
                "ph": "M",
                "pid": i,
                "tid": 0,
                "args": {"sort_index": i},
            }
        )
        merged.extend(
            trace_metadata_events(
                body, process_name=label, thread_names=tnames
            )
        )
        merged.extend(body)
    return {"traceEvents": merged, "displayTimeUnit": "ms"}
