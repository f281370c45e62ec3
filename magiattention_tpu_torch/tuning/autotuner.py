"""Autotuner front door: mode dispatch, the cache, telemetry.

The port of the JAX package's ``tuning/autotuner.py``, aimed at the H100.
``MAGI_ATTENTION_AUTOTUNE`` modes:

- ``off``: the static rule (``ops.flex_attn._static_block_config``: the
  Hopper tile, head_block G, the row-major grid).
- ``model`` (default): the cost model's ranking (:mod:`.cost_model`),
  cached by workload fingerprint.
- ``measure``: the model's ranking, then its top :data:`MEASURE_TOP_K`
  candidates timed on the caller's operands by the caller's ``measure_fn``;
  the measured winner is cached in memory and on disk. A caller that cannot
  time (the keyed cp API, a pinned head_block) takes ``model`` for that
  call, and the decision says why.

The split tuners (:func:`select_decode_splits`, :func:`select_tick_splits`)
price ``paged_decode`` on the card: its thread blocks against the SMs, the
KV read at the card's memory rate, and a fitted fee for each merge round a
split adds. Their decisions are memoised on the integer geometry, so a
decode step's repeat call is one dict lookup.

Every decision is recorded through the telemetry registry (the choice, its
source, predicted and measured cost, the cache layer).
"""

from __future__ import annotations

import dataclasses

from ..env import AUTOTUNE_MODES, raw_flags
from .cache import TuningRecord, get_tuning_cache
from .cost_model import FITTED_CARD, any_feasible_rung, rank_candidates, smem_feasible
from .fingerprint import make_fingerprint

# candidates timed in measure mode (the model's top picks)
MEASURE_TOP_K = 3

# ``paged_decode``'s launch (``csrc/decode_sm90.cuh``): each (kv head,
# split, query) walk spreads over a cluster of up to DECODE_MAX_CLUSTER
# blocks, the fewest that give every SM a block, as long as each of its 6
# warps keeps two 16-token chunks of the split. A bf16 flat group past 32 q
# heads takes the wide walk (``csrc/decode_wide_sm90.cuh``) instead, priced
# with the blocks of its own cut (``serving.decode_attn.wide_schedule``).
DECODE_MAX_CLUSTER = 8
DECODE_CLUSTER_TOKENS = 2 * 16 * 6
# One ``merge_partials`` round: ``s`` splits merge in ``s - 1`` pairwise
# ``correct_attn_out_lse`` rounds of small kernels (the reference prices
# log2(s) fused tree levels). Fitted from ``chip_smoke.py``'s
# ``decode_timing`` split sweeps (the kernel with the merge less the kernel
# alone, less the same at one split, over s - 1; the median of s = 2, 4, 8,
# 16 on the serving batch and on one 32K-token sequence: 0.087-0.097 ms a
# round) on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name,
# power.limit), the phase's first chip run.
MERGE_ROUND_S = 9.21e-5
DECODE_MAX_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class TuningDecision:
    """The resolved kernel choice and where it came from."""

    block_q: int
    block_k: int
    head_block: int  # the split count for the decode and tick kinds
    source: str  # "static" | "model" | "measured" | "measure_failed"
    cache_layer: str  # "memory" | "disk" | "none"
    fingerprint_hash: str  # "" for static decisions
    predicted_ms: float
    measured_ms: float | None
    reason: str  # one line: why
    grid: str = "row_major"

    @property
    def config(self) -> tuple[int, int, int]:
        return (self.block_q, self.block_k, self.head_block)

    @property
    def kernel_config(self) -> tuple[int, int, int, str]:
        return (self.block_q, self.block_k, self.head_block, self.grid)


def _static_decision(q_ranges, k_ranges, hq: int, hk: int, head_dim: int) -> TuningDecision:
    from ..ops.flex_attn import _static_block_config

    bq, bk, hb = _static_block_config(q_ranges, k_ranges, hq, hk, head_dim=head_dim)
    return TuningDecision(
        block_q=bq, block_k=bk, head_block=hb, source="static", cache_layer="none",
        fingerprint_hash="", predicted_ms=0.0, measured_ms=None,
        reason="MAGI_ATTENTION_AUTOTUNE=off: the static rule (tile, head_block G, row-major)",
    )


def _from_record(rec: TuningRecord, layer: str, fp_hash: str, reason: str) -> TuningDecision:
    return TuningDecision(
        block_q=rec.block_q, block_k=rec.block_k, head_block=rec.head_block, source=rec.source,
        cache_layer=layer, fingerprint_hash=fp_hash, predicted_ms=rec.predicted_ms,
        measured_ms=rec.measured_ms, reason=reason, grid=rec.grid,
    )


def select_block_config(
    q_ranges,
    k_ranges,
    attn_type_map,
    hq: int,
    hk: int,
    *,
    head_dim: int = 128,
    dtype: str = "bfloat16",
    mode: str | None = None,
    max_block_q: int | None = None,
    max_block_k: int | None = None,
    measure_fn=None,
    include_sparse: bool = True,
    device=None,
) -> TuningDecision | None:
    """Resolve (block_q, block_k, head_block, grid) for one workload on
    ``device`` (the fingerprint's card; default: the card, else the CPU).

    ``measure_fn(block_q, block_k, head_block, grid) -> seconds`` times one
    candidate (consulted in ``measure`` mode only; a candidate that raises
    is disqualified and counted, never replaced by a plain version).
    ``include_sparse=False`` ranks the row-major grid only (the cp
    kernels' grid). Returns None when ``max_block_q`` / ``max_block_k``
    leave no candidate: the caller keeps its own blocking."""
    from .. import env, telemetry

    if mode is None:
        mode = env.autotune_mode()
    if mode not in AUTOTUNE_MODES:
        raise ValueError(f"MAGI_ATTENTION_AUTOTUNE={mode!r} is not one of {AUTOTUNE_MODES}")
    if mode == "off":
        decision = _static_decision(q_ranges, k_ranges, hq, hk, head_dim)
        _record(decision)
        return decision

    fp = make_fingerprint(q_ranges, k_ranges, attn_type_map, hq, hk, head_dim=head_dim,
                          dtype=dtype, max_block_q=max_block_q, max_block_k=max_block_k,
                          include_sparse=include_sparse, device=device)
    shape = dict(head_dim=head_dim, num_heads_q=hq, num_heads_kv=hk)
    cache = get_tuning_cache()
    rec, layer = cache.get(fp)
    aliased = False
    if (rec is not None
            and not smem_feasible(q_ranges, k_ranges, attn_type_map, rec.block_q, rec.block_k,
                                  head_block=rec.head_block, grid=rec.grid, **shape)
            and any_feasible_rung(q_ranges, k_ranges, attn_type_map, max_block_q=max_block_q,
                                  max_block_k=max_block_k, **shape)):
        # the fingerprint's ~9% buckets served a winner this exact workload
        # cannot launch: re-rank (unless nothing fits, when the cached
        # winner is as good as a re-rank and keeps the hit path cheap)
        rec = None
        aliased = True
    if (rec is not None and mode == "measure" and measure_fn is not None
            and rec.source == "model" and any(c.get("feasible") for c in rec.candidates)):
        # a model winner (cached where nothing could be timed) must not
        # pre-empt the measurement this call can run: upgrade it.
        # measure_failed records stay: their candidates crashed once already
        rec = None
    if rec is not None:
        telemetry.record_autotune_cache(hit=True, layer=layer)
        decision = _from_record(rec, layer, fp.stable_hash(),
                                f"tuning-cache {layer} hit ({rec.source} winner)")
        _record(decision)
        return decision
    telemetry.record_autotune_cache(hit=False, layer="miss")

    scores = rank_candidates(q_ranges, k_ranges, attn_type_map, hq, hk, head_dim=head_dim,
                             max_block_q=max_block_q, max_block_k=max_block_k,
                             include_sparse=include_sparse)
    if not scores:
        return None
    best = scores[0]
    source, measured_ms = "model", None
    reason = (f"cost model: {best.block_q}x{best.block_k}x{best.head_block} ({best.grid}) "
              f"~{best.cost_seconds * 1e3:.4f} ms (mma {best.mma_seconds * 1e3:.4f} + slots "
              f"{best.step_seconds * 1e3:.4f}; {best.entries} entries, steps {best.steps})")
    if mode == "measure" and measure_fn is not None:
        _check_measure_fn_arity(measure_fn)
        timed, attempted = [], 0
        for cand in [s for s in scores if s.feasible][:MEASURE_TOP_K]:
            attempted += 1
            try:
                t = float(measure_fn(cand.block_q, cand.block_k, cand.head_block, cand.grid))
            except Exception as e:  # noqa: BLE001 - a crashing candidate is disqualified
                telemetry.record_autotune_measure_failure(
                    f"{cand.block_q}x{cand.block_k}x{cand.head_block}:{cand.grid}", str(e))
                continue
            timed.append((t, cand))
            telemetry.record_autotune_measurement()
        if timed:
            t_best, best = min(timed, key=lambda x: x[0])
            source, measured_ms = "measured", t_best * 1e3
            reason = (f"measured winner {best.block_q}x{best.block_k}x{best.head_block} "
                      f"({best.grid}): {measured_ms:.4f} ms over {len(timed)} candidates "
                      "(forward only)")
        elif attempted:
            source = "measure_failed"
            reason += f" (all {attempted} timed candidates failed; the model's winner)"
        else:
            reason += " (no feasible candidate to time)"
    elif mode == "measure":
        reason += " (measure requested, no measurement possible here)"

    rec = TuningRecord(
        block_q=best.block_q, block_k=best.block_k, head_block=best.head_block, source=source,
        predicted_ms=best.cost_seconds * 1e3, measured_ms=measured_ms,
        candidates=tuple(s.as_dict() for s in scores), grid=best.grid,
    )
    if not aliased:
        # an aliased workload keeps the resident winner in its slot (it may
        # be a measurement): it re-ranks on every call instead
        cache.put(fp, rec)
    decision = _from_record(rec, "none", fp.stable_hash(), reason)
    _record(decision)
    return decision


def _check_measure_fn_arity(measure_fn) -> None:
    """Refuse a 3-argument ``measure_fn``: the contract takes (block_q,
    block_k, head_block, grid), and a TypeError per candidate would be
    swallowed as a crashed candidate, measure mode quietly becoming the
    model."""
    import inspect

    try:
        sig = inspect.signature(measure_fn)
    except (TypeError, ValueError):  # builtins and C callables: trust them
        return
    positional = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL)]
    if any(p.kind == p.VAR_POSITIONAL for p in positional):
        return
    if len(positional) < 4:
        raise TypeError(
            "measure_fn must accept (block_q, block_k, head_block, grid); got a "
            f"{len(positional)}-argument callable")


def _record(decision: TuningDecision) -> None:
    from .. import telemetry

    telemetry.record_autotune_decision(decision)


# -- split counts ---------------------------------------------------------------

# (kind, the caller's arguments, the flags of :data:`_MEMO_FLAGS`) ->
# the decision: a decode step or a repeat flex call must not pay for a
# fingerprint; cleared with the cache
_MEMO: dict = {}
_MEMO_CAP = 4096
# the flags a tuner decision reads, keyed raw: a memo hit validates nothing
_MEMO_FLAGS = tuple(f"MAGI_ATTENTION_{n}" for n in (
    "AUTOTUNE", "AUTOTUNE_CACHE_DIR", "KERNEL_BACKEND", "HEAD_BLOCK", "BLOCK_Q", "BLOCK_K",
    "GRID"))


def _card_sms(device) -> int:
    from ..serving.decode_attn import card_sms

    return card_sms(device)


def _decode_blocks(walks: int, split_tokens: int, sms: int) -> int:
    """Thread blocks of a ``paged_decode`` launch of ``walks`` walks of
    ``split_tokens`` tokens each (``csrc/decode_sm90.cuh::cluster_blocks``)."""
    c = 1
    while c < DECODE_MAX_CLUSTER and c * walks < sms:
        c *= 2
    while c > 1 and split_tokens < DECODE_CLUSTER_TOKENS * c:
        c //= 2
    return walks * c


def _wide_decode_blocks(rows: int, width: int, page_size: int, hk: int, splits: int,
                        group: int, head_dim: int, sms: int) -> int:
    """Thread blocks of a wide-walk launch of ``rows`` queries (their
    segments over the card's SMs), from the cut the wrapper passes the
    kernel (``serving.decode_attn.wide_schedule``)."""
    from ..serving import decode_attn as da

    import torch

    sched = da.wide_schedule(rows, hk, width, page_size, splits, group, head_dim, sms)
    return sched.blocks(rows * hk * splits * da.kernel_row_slices(group, torch.bfloat16))


def _price_splits(rows: int, width: int, page_size: int, hk: int, head_dim: int, dtype: str,
                  sms: int, group: int = 1) -> list[tuple[float, int]]:
    """(seconds, splits) of each split count dividing the table ``width``
    (up to :data:`DECODE_MAX_SPLITS`), cheapest first: the table's KV read
    at the card's memory rate over the share of the SMs the launch's
    blocks fill, plus a merge round for each split past the first. A bf16
    group of more than 32 q heads (``group``) counts the wide walk's
    blocks, which fill the card at any split count."""
    from ..utils.cost import card_spec

    rate = card_spec(FITTED_CARD).hbm_gbps * 1e9
    elt = 2 if "16" in str(dtype) else 4
    wide = "bfloat16" in str(dtype) and group > 32
    kv_bytes = 2.0 * rows * width * page_size * hk * head_dim * elt
    scored = []
    for s in range(1, min(width, DECODE_MAX_SPLITS) + 1):
        if width % s:
            continue
        if wide:
            blocks = _wide_decode_blocks(rows, width, page_size, hk, s, group, head_dim, sms)
        else:
            blocks = _decode_blocks(hk * s * rows, width // s * page_size, sms)
        read_s = kv_bytes / (rate * min(blocks, sms) / sms)
        scored.append((read_s + (s - 1) * MERGE_ROUND_S, s))
    return sorted(scored)


def _select_splits(kind: str, fp, rows: int, width: int, page_size: int, hk: int,
                   head_dim: int, dtype: str, dev, what: str, group: int = 1) -> TuningDecision:
    from .. import telemetry

    cache = get_tuning_cache()
    rec, layer = cache.get(fp)
    if rec is not None:
        telemetry.record_autotune_cache(hit=True, layer=layer)
        decision = _from_record(rec, layer, fp.stable_hash(),
                                f"{kind} tuning-cache {layer} hit ({rec.source} winner)")
        _record(decision)
        return decision
    telemetry.record_autotune_cache(hit=False, layer="miss")
    sms = _card_sms(dev)
    scored = _price_splits(rows, width, page_size, hk, head_dim, dtype, sms, group)
    best_cost, best_s = scored[0]
    rec = TuningRecord(
        block_q=1, block_k=width // best_s, head_block=best_s,  # the split count
        source="model", predicted_ms=best_cost * 1e3, measured_ms=None,
        candidates=tuple({"num_splits": s, "pages_per_split": width // s, "cost_seconds": c,
                          "feasible": True} for c, s in scored),
    )
    cache.put(fp, rec)
    decision = _from_record(
        rec, "none", fp.stable_hash(),
        f"{kind} model: {best_s} split(s) x {width // best_s} pages (~{best_cost * 1e3:.4f} ms, "
        f"{sms} SMs, {what})")
    _record(decision)
    return decision


def memoised(key: tuple, resolve):
    """``resolve()``'s result for ``key`` (the caller's arguments as given),
    computed once; the raw values of :data:`_MEMO_FLAGS` join the key.
    Cleared by ``reset_tuning_cache``."""
    key = (*key, raw_flags(_MEMO_FLAGS))
    hit = _MEMO.get(key)
    if hit is None:
        if len(_MEMO) >= _MEMO_CAP:  # a crude bound: never grows past it
            _MEMO.clear()
        hit = _MEMO[key] = resolve()
    return hit


def select_decode_splits(
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
) -> TuningDecision:
    """The split-KV decode split count (the ``decode`` fingerprint kind).

    Decode reads every cached K/V byte once a step, so a split pays only
    while the launch's thread blocks (batch x kv heads x splits walks, each
    over a cluster of up to 8: :func:`_decode_blocks`; a bf16 group past 32
    q heads: the wide walk's segments, :func:`_wide_decode_blocks`) leave
    SMs idle, and
    each split past the first costs a ``merge_partials`` round
    (:data:`MERGE_ROUND_S`). The record keeps the reference's convention:
    ``head_block`` holds the split count, and the caller clamps it to a
    divisor of its table. ``prefix_groups`` (the cascade's shared-prefix
    groups, 0 for flat decode) is a fingerprint axis only. Memoised on the
    geometry: a repeat call is one dict lookup."""
    def resolve():
        from .fingerprint import _dtype_name, make_decode_fingerprint, resolve_device

        dev, name = resolve_device(device), _dtype_name(dtype)
        mpp = max(int(max_pages_per_seq), 1)
        fp = make_decode_fingerprint(batch, mpp, page_size, hq, hk, head_dim=head_dim,
                                     dtype=name, prefix_groups=prefix_groups, device=dev)
        return _select_splits("decode", fp, max(int(batch), 1), mpp, page_size, hk, head_dim,
                              name, dev, f"batch {batch}", group=max(int(hq) // int(hk), 1))

    return memoised(("decode", batch, max_pages_per_seq, page_size, hq, hk, head_dim, dtype,
                      prefix_groups, device), resolve)


def select_tick_splits(
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
) -> TuningDecision:
    """The split count of one unified serving tick (the ``tick``
    fingerprint kind): the decode model with the tick's padded rows for the
    batch and its entry capacity for the table width. ``prefill_rows`` is a
    fingerprint axis only. Memoised like :func:`select_decode_splits`."""
    def resolve():
        from .fingerprint import _dtype_name, make_tick_fingerprint, resolve_device

        dev, name = resolve_device(device), _dtype_name(dtype)
        rows, width = max(int(row_capacity), 1), max(int(entry_capacity), 1)
        fp = make_tick_fingerprint(rows, width, page_size, hq, hk, head_dim=head_dim,
                                   dtype=name, prefill_rows=prefill_rows, device=dev)
        return _select_splits("tick", fp, rows, width, page_size, hk, head_dim, name, dev,
                              f"{rows} tick rows", group=max(int(hq) // int(hk), 1))

    return memoised(("tick", row_capacity, entry_capacity, page_size, hq, hk, head_dim, dtype,
                      prefill_rows, device), resolve)


# -- the keyed cp runtime's blocking --------------------------------------------


class GroupMemo:
    """Memo tables that every member of a process group fills and evicts at
    the same calls: one table a group, keyed on the group's global ranks
    (the ``id()`` of a destroyed group can come back), each capped at
    ``cap`` entries, the oldest evicted first. The members of a group make
    the same calls on it in the same order (the calls that miss are
    collectives), so after every call each member's table holds the same
    keys: a hit on one rank is a hit on all of them, whatever other groups
    a rank belongs to. ``None`` (no group) has a table of its own."""

    def __init__(self, cap: int):
        self.cap = cap
        self._tables: dict = {}

    @staticmethod
    def _table_key(group) -> tuple:
        if group is None:
            return ()
        import torch.distributed as dist

        return tuple(dist.get_process_group_ranks(group))

    def get(self, group, key, default=None):
        return self._tables.get(self._table_key(group), {}).get(key, default)

    def put(self, group, key, value) -> None:
        table = self._tables.setdefault(self._table_key(group), {})
        if key not in table and len(table) >= self.cap:
            del table[next(iter(table))]  # dicts keep insertion order
        table[key] = value

    def clear(self) -> None:
        self._tables.clear()


# the agreed blocking of each workload, one table a group
_AGREED = GroupMemo(1024)
_MISS = object()


def _agreed_config(group, decide):
    """``decide()`` (a blocking triple or None) on the group's rank 0, sent
    to every rank of ``group`` in one broadcast of four int64s (on the card
    for an NCCL group); ``decide()`` alone in a one-rank group."""
    import torch
    import torch.distributed as dist

    if dist.get_world_size(group) == 1:
        return decide()
    config = decide() if dist.get_rank(group) == 0 else None
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    box = torch.tensor([0, 0, 0, 0] if config is None else [*config, 1], dtype=torch.int64,
                       device=dev)
    dist.broadcast(box, src=dist.get_global_rank(group, 0), group=group)
    bq, bk, hb, found = box.tolist()
    return (bq, bk, hb) if found else None


def resolve_block_config(
    q_ranges,
    k_ranges,
    types,
    total_q_padded: int,
    total_k_padded: int,
    cp_size: int,
    hq: int,
    hkv: int,
    head_dim: int,
    out_dtype: str,
    *,
    group=None,
    device=None,
    plan_mask=None,
) -> tuple[int, int, int] | None:
    """The tuned (block_q, block_k, head_block) of a distributed plan (the
    keyed runtime or a model harness), or None for the caller's own rule.

    The tuner steps aside (None) under ``MAGI_ATTENTION_AUTOTUNE=off``, for
    a ``MAGI_ATTENTION_BLOCK_Q`` / ``_BLOCK_K`` pin, and when the rank's
    shard is narrower than every tile. The ranking is the row-major grid's
    (the cp kernels' grid) with tiles no wider than a rank's shard;
    ``measure`` takes the model here (nothing can time a whole distributed
    plan at key creation). ``MAGI_ATTENTION_HEAD_BLOCK`` pins head_block,
    snapped to the GQA geometry.

    With a ``torch.distributed`` ``group`` the decision is the group's:
    rank 0 decides and broadcasts it (:func:`_agreed_config`), since
    each rank is a process with a tuning cache (and a disk directory) of
    its own, where the reference has one controller, and every rank must
    plan the same blocking. It is memoised per group (:class:`GroupMemo`)
    on the mask as given, so a repeat key pays one dict lookup and no
    collective. ``plan_mask``, a callable, gives the (q_ranges, k_ranges,
    types, total_q_padded, total_k_padded) of the mask whose plan will
    serve this one (the plan-reuse tier's canonical mask), or None: the
    blocking is then that mask's, so a bucketed request and its canonical
    plan agree, and a new mask of a known bucket pays no ranking and no
    collective."""
    from .. import env
    from ..ops.flex_attn import pin_head_block

    def decide():
        decision = select_block_config(
            q_ranges, k_ranges, types, hq, hkv, head_dim=head_dim, dtype=str(out_dtype),
            max_block_q=max(total_q_padded // max(cp_size, 1), 1),
            max_block_k=max(total_k_padded // max(cp_size, 1), 1),
            include_sparse=False, device=device)
        return None if decision is None else decision.config

    def resolve():
        if env.autotune_mode() == "off" or env.block_q() is not None or env.block_k() is not None:
            return None
        if group is None:
            config = decide()
        else:
            config = _agreed_config(group, decide)
        return None if config is None else (config[0], config[1],
                                            pin_head_block(config[2], hq, hkv))

    if group is None and plan_mask is None:
        return resolve()
    key = (tuple(map(tuple, q_ranges)), tuple(map(tuple, k_ranges)), tuple(map(int, types)),
           int(total_q_padded), int(total_k_padded), int(cp_size), int(hq), int(hkv),
           int(head_dim), str(out_dtype), str(device), raw_flags(_MEMO_FLAGS))
    config = _AGREED.get(group, key, _MISS)
    if config is _MISS:
        other = plan_mask() if plan_mask is not None else None
        if other is None:
            config = resolve()
        else:
            config = resolve_block_config(*other, cp_size, hq, hkv, head_dim, out_dtype,
                                          group=group, device=device)
        _AGREED.put(group, key, config)
    return config
