"""Split-KV decode attention over the paged cache.

One query token per sequence attends over its whole paged history. Each of
``num_splits`` KV splits computes a partial ``(out, lse)`` masked to the
sequence's true length, and the partials merge with the associative
LSE-corrected reduction of ``ops/correction.py`` — the JAX package's
``serving/decode_attn.py`` design.

Where it runs follows its tensors: on CUDA the ``paged_decode`` kernel
(``csrc/decode.cu``) computes every split's partial in one launch; on the
CPU the plain version :func:`_decode_torch` gathers each split's pages and
computes the same partials densely (so does a CUDA tensor under
``MAGI_ATTENTION_KERNEL_BACKEND=torch|torch_online``). A split with no
coverage (the sequence ends before it starts) reports ``(out=0,
lse=-inf)`` and merges as a no-op.
:func:`_decode_shared_prefix` is the cascade's level 1: every query of a
group attends over the same shared pages, which the kernel's shared mode
reads once for up to 32 q rows (8 on the float32 walk; the plain version:
the broadcast table).

Split-count resolution: explicit argument > ``MAGI_ATTENTION_DECODE_SPLITS``
> the split tuner (:func:`resolve_num_splits`), always clamped to a divisor
of the block-table width.

Resilience: between the split partials and their merge, on the kernel path
and the plain one alike, each partial ``split{i}`` takes the chaos
injectors, then the guard (:func:`_apply_split_resilience`); the error code
is read at :func:`decode_attn_paged`, :func:`decode_partials_for_tables`
and :func:`_decode_shared_prefix` (``check`` raises
``NumericalGuardError`` naming the splits). :func:`decode_reference` stays
outside every hook. Off, no hook runs a tensor op.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .. import csrc
from ..ops.correction import merge_partials
from ..ops.flex_attn import on_card
from ..utils.instrument import named_scope
from .kv_cache import PagedKVCache

NEG_INF = float("-inf")

# the kernel's build (csrc/decode.cu): head_dim 32, 64 or 128 (the flex
# kernels' widths) and any number of q heads per kv head
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# q rows one block serves in the shared mode (decode_sm90.cuh MAX_ROWS,
# decode_simt.cuh MAXG); the row groups go on gridDim.z, at most 65535 a
# launch, so a larger batch launches in row blocks (kernel_row_blocks)
KERNEL_SHARED_ROWS = {torch.bfloat16: 32, torch.float32: 8}
# flat mode: a sequence's group of q heads past what one walk holds
# (decode_wide_sm90.cuh's walk past 32 rows, decode_simt.cuh's WIDE mode
# past 8) runs in row slices of at most these rows, each a row group
KERNEL_WIDE_ROWS = {torch.bfloat16: (32, 128), torch.float32: (8, 64)}
KERNEL_MAX_ROW_GROUPS = 65535
# the bf16 wide walk (decode_wide_sm90.cuh): tokens a chunk (one TMA box of
# K and of V), the segments a card's SMs should take at the table's full
# width, a segment's least chunks, and the walks one launch numbers
WIDE_CHUNK = 64
WIDE_SEGMENTS_PER_SM = 2
WIDE_MIN_SEGMENT = 2
WIDE_MAX_WALKS = 2048
HOPPER_SMS = 132  # an H100 SXM's SMs, where no card is at hand (and the split tuner's)


def kernel_row_slices(group: int, dtype: torch.dtype) -> int:
    """The row groups of one sequence's ``group`` q heads in the flat mode:
    1, or for a group past one walk's rows, its slices of at most
    ``KERNEL_WIDE_ROWS[dtype][1]`` rows (``slices_of`` / ``wide_slices`` of
    the kernels)."""
    walk_rows, slice_rows = KERNEL_WIDE_ROWS[dtype]
    return 1 if group <= walk_rows else -(-int(group) // slice_rows)


def takes_wide_walk(group: int, dtype: torch.dtype, shared: bool) -> bool:
    """Whether ``paged_decode`` runs decode_wide_sm90.cuh's walk: a bf16
    flat-mode group past one walk's rows."""
    return dtype == torch.bfloat16 and not shared and group > KERNEL_WIDE_ROWS[dtype][0]


def kernel_row_blocks(b: int, group: int, dtype: torch.dtype, shared: bool, *, hk: int = 1,
                      splits: int = 1) -> list[tuple[int, int]]:
    """The query ranges ``[lo, hi)`` that ``paged_decode`` launches one at a
    time, each of at most :data:`KERNEL_MAX_ROW_GROUPS` row groups:
    :func:`kernel_row_slices` row groups per query in the flat mode,
    ``KERNEL_SHARED_ROWS`` q rows (a query's ``group`` heads each) per row
    group in the shared mode; on the bf16 wide walk (:func:`takes_wide_walk`)
    at most :data:`WIDE_MAX_WALKS` walks, a query's ``hk * splits *
    slices``. Every row's walk is the same in any block (the wide walk's
    segments come from :func:`wide_schedule` of the whole batch), so the
    blocks give the bits of one launch."""
    per = KERNEL_MAX_ROW_GROUPS // kernel_row_slices(group, dtype)
    if shared:
        per = KERNEL_MAX_ROW_GROUPS * KERNEL_SHARED_ROWS[dtype] // max(int(group), 1)
    elif takes_wide_walk(group, dtype, shared):
        per = WIDE_MAX_WALKS // (int(hk) * int(splits) * kernel_row_slices(group, dtype))
        if per < 1:
            raise ValueError(f"paged_decode's wide walk numbers at most {WIDE_MAX_WALKS} walks a "
                             f"launch; one query of {hk} kv heads x {splits} splits x "
                             f"{kernel_row_slices(group, dtype)} row slices has more")
    if b <= per:
        return [(0, b)]
    return [(lo, min(lo + per, b)) for lo in range(0, b, per)]


@dataclasses.dataclass(frozen=True)
class WideSchedule:
    """How the bf16 wide walk cuts a launch (``csrc/decode_wide_sm90.cuh``):
    ``seg_chunks`` 64-token chunks a segment, ``max_segments`` a walk's
    segments at the split's full length, ``slice_rows`` q rows a row slice,
    ``slot_floats`` the f32 of a segment's scratch slot, and the card's
    ``sms``."""

    seg_chunks: int
    max_segments: int
    slice_rows: int
    slot_floats: int
    sms: int

    def blocks(self, walks: int) -> int:
        """Persistent blocks of a launch of ``walks`` walks: one per SM, or
        one per segment if fewer."""
        return max(1, min(self.sms, walks * self.max_segments))

    def scratch_floats(self, walks: int) -> int:
        """The f32 scratch of a launch of ``walks`` walks (none where every
        walk is one segment, which merges nothing)."""
        return walks * self.max_segments * self.slot_floats if self.max_segments > 1 else 0


def wide_schedule(batch: int, cluster_heads: int, width: int, page_size: int, num_splits: int,
                  group: int, head_dim: int, sms: int) -> WideSchedule:
    """The wide walk's cut of a ``batch``-query decode over tables of
    ``width`` pages: segments of ``seg_chunks`` chunks, as long as give the
    card's ``sms`` SMs :data:`WIDE_SEGMENTS_PER_SM` segments each when every
    walk runs the split's full length (at least :data:`WIDE_MIN_SEGMENT`
    chunks). It reads only what a tensor-parallel head slice shares with
    the full launch (the kv heads the launch stands for, ``cluster_heads``,
    the batch, table width, page size, splits and group): the slice cuts its
    walks as the full launch does, and gives its bits. The wrapper and the
    split tuner both take it."""
    slices = kernel_row_slices(group, torch.bfloat16)
    slice_rows = -(-int(group) // slices)
    chunks = -(-(int(width) // int(num_splits) * int(page_size)) // WIDE_CHUNK)
    walks = int(cluster_heads) * int(batch) * int(num_splits) * slices
    want = -(-walks * chunks // (WIDE_SEGMENTS_PER_SM * int(sms)))
    seg = max(1, min(max(WIDE_MIN_SEGMENT, want), chunks))
    max_segments = -(-chunks // seg) if chunks else 1
    slot_rows = -(-slice_rows // 4) * 4  # the slot's max and sum rows, padded for 16-byte rows
    return WideSchedule(seg, max_segments, slice_rows, 2 * slot_rows + slice_rows * int(head_dim),
                        int(sms))


def wide_segments(seq_lens, schedule: WideSchedule, width: int, page_size: int, num_splits: int,
                  hk: int, slices: int) -> list[tuple[int, int, int, int]]:
    """The segments of a wide launch in the kernel's order (walk by walk;
    a walk is (query, kv head, split, row slice)): ``(walk, segment, first
    chunk, end chunk)``; a walk with no live token is one empty segment.
    The host's model of ``decode_wide_sm90.cuh``'s numbering."""
    span = int(width) // int(num_splits) * int(page_size)
    out = []
    for m, n_seq in enumerate(int(x) for x in seq_lens):
        for h in range(int(hk)):
            for s in range(int(num_splits)):
                n = max(0, min(span, n_seq - s * span))
                chunks = -(-n // WIDE_CHUNK)
                for z in range(int(slices)):
                    walk = ((m * int(hk) + h) * int(num_splits) + s) * int(slices) + z
                    nseg = max(1, -(-chunks // schedule.seg_chunks))
                    for k in range(nseg):
                        lo = k * schedule.seg_chunks
                        out.append((walk, k, lo, min(lo + schedule.seg_chunks, chunks)))
    return out


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_sms(device) -> int:
    """The SMs of ``device``'s card (:data:`HOPPER_SMS` off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return HOPPER_SMS
    return _sms_of(torch.cuda.current_device() if device.index is None else device.index)


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """Static decode parameters. ``cluster_heads``: the kv-head count the
    kernel sizes its thread-block clusters for (0: the cache's own); a
    tensor-parallel head slice passes the whole pool's, so its walks merge
    over the blocks the full launch's would and give the same bits. It
    changes the launch geometry only."""

    scale: float
    softcap: float
    num_splits: int
    out_dtype: torch.dtype
    cluster_heads: int = 0


def _split_partial_torch(q, k, v, pos0: int, valid_len, scale: float, softcap: float):
    """One KV split's partial (out, lse), plain torch.

    q [b, hq, d]; k/v [b, L, hk, d] (this split's gathered tokens, at global
    positions pos0 + arange(L)); valid_len [b] true lengths. Returns (out
    [b, hq, d] f32, lse [b, hq] f32) with the uncovered convention (0, -inf).
    """
    b, hq, d = q.shape
    hk = k.shape[2]
    group = hq // hk
    L = k.shape[1]
    qr = q.float().reshape(b, hk, group, d)
    z = torch.einsum("bhgd,blhd->bhgl", qr, k.float()) * scale
    if softcap > 0.0:
        z = softcap * torch.tanh(z / softcap)
    pos = pos0 + torch.arange(L, device=q.device)
    mask = pos[None, :] < valid_len[:, None].long()  # [b, L]
    s = z.masked_fill(~mask[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)  # [b, hk, g]
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgl,blhd->bhgd", p, v.float())
    covered = l > 0.0
    inv = torch.where(covered, 1.0 / torch.where(covered, l, 1.0), 0.0)
    out = (acc * inv[..., None]).reshape(b, hq, d)
    lse = torch.where(
        covered, m_safe + torch.log(torch.where(covered, l, 1.0)), NEG_INF
    ).reshape(b, hq)
    return out, lse


def _decode_torch(q, cache: PagedKVCache, bt, seq_lens, params: DecodeParams):
    """Plain version: gather each split's pages densely, compute its partial,
    take the resilience hooks, tree-merge. ``bt`` [b, W] / ``seq_lens`` [b]
    are the batch's block-table rows and true lengths. Returns f32 (out
    [b, hq, d], lse [b, hq]), the guard code (None with guards off) and the
    value census (None with the census off)."""
    b = q.shape[0]
    ps = cache.page_size
    s = params.num_splits
    pps = bt.shape[1] // s
    outs, lses = [], []
    for i in range(s):
        pages = bt[:, i * pps : (i + 1) * pps].long()  # [b, pps]
        shape = (b, pps * ps, cache.num_kv_heads, cache.head_dim)
        k = cache.k_pages[pages].reshape(shape)
        v = cache.v_pages[pages].reshape(shape)
        o, l = _split_partial_torch(
            q, k, v, i * pps * ps, seq_lens, params.scale, params.softcap
        )
        outs.append(o)
        lses.append(l)
    outs, lses, code = _apply_split_resilience(outs, lses)
    out, lse = merge_partials(outs, lses)
    return out, lse, code, _split_census(outs, lses, lse)


def _decode_partials_kernel(q, cache: PagedKVCache, bt, seq_lens, params: DecodeParams,
                            *, shared: bool = False):
    """The ``paged_decode`` Hopper kernel: every split's partial in one
    launch. ``shared``: ``bt`` [1, W] and ``seq_lens`` [1] hold one table
    row and length that every query reads (the kernel's shared mode).
    Returns (out_parts [b, s, hq, d] f32, lse_parts [b, s, hq] f32). Raises
    on what the kernel does not take. A batch past the grid's row groups
    launches in row blocks (:func:`kernel_row_blocks`)."""
    b, hq, d = q.shape
    hk = cache.num_kv_heads
    if q.requires_grad:
        raise NotImplementedError(
            "paged_decode has no backward, as the TPU decode kernel has none: "
            "decode serves, it does not train; pass a tensor that does not "
            "require grad"
        )
    if cache.k_pages.dtype not in KERNEL_DTYPES or q.dtype != cache.k_pages.dtype:
        raise TypeError(
            f"paged_decode takes q and pages of one dtype in {KERNEL_DTYPES}; "
            f"got q {q.dtype}, pages {cache.k_pages.dtype}"
        )
    if d not in KERNEL_HEAD_DIMS or hq % hk:
        raise ValueError(
            f"paged_decode is built for head_dim in {KERNEL_HEAD_DIMS} and a whole number of "
            f"q heads per kv head; got head_dim {d}, {hq} q / {hk} kv heads"
        )
    rows = 1 if shared else b
    if bt.shape[0] != rows or seq_lens.shape[0] != rows:
        raise ValueError(
            f"paged_decode: {rows} table row(s) and length(s) expected "
            f"({'shared' if shared else 'flat'} mode, {b} queries); got "
            f"{tuple(bt.shape)} and {tuple(seq_lens.shape)}"
        )
    s = params.num_splits
    mpp = bt.shape[1]
    group = hq // hk
    heads = int(params.cluster_heads or hk)
    q = q.contiguous()
    bt = bt.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    out_parts = torch.empty((b, s, hq, d), dtype=torch.float32, device=q.device)
    lse_parts = torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
    row_blocks = kernel_row_blocks(b, group, q.dtype, shared, hk=hk, splits=s)
    walks_per_query = hk * s * kernel_row_slices(group, q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sched = scratch = counters = None
    if takes_wide_walk(group, q.dtype, shared):  # one cut for the batch, one scratch for its blocks
        sched = wide_schedule(b, heads, mpp, cache.page_size, s, group, d, card_sms(q.device))
        walks = max(hi - lo for lo, hi in row_blocks) * walks_per_query
        if sched.max_segments > 1:
            scratch = torch.empty(sched.scratch_floats(walks), dtype=torch.float32,
                                  device=q.device)
            counters = _wide_counters(q.device, stream, walks * sched.max_segments)
    # past the grid's row groups (gridDim.z; the wide walk's walks), one launch per block of rows
    for lo, hi in row_blocks:
        rows_bt, rows_sl = (bt, seq_lens) if shared else (bt[lo:hi], seq_lens[lo:hi])
        seg, n_blocks = (0, 0) if sched is None else (
            sched.seg_chunks, sched.blocks((hi - lo) * walks_per_query))
        csrc.launch(
            "paged_decode",
            q[lo:hi].data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
            rows_bt.data_ptr(), rows_sl.data_ptr(),
            out_parts[lo:hi].data_ptr(), lse_parts[lo:hi].data_ptr(),
            hi - lo, hq, hk, d, cache.page_size, mpp, s, int(shared),
            int(q.dtype == torch.float32), heads, cache.num_pages, seg, n_blocks,
            float(params.scale), float(params.softcap),
            0 if scratch is None else scratch.data_ptr(),
            0 if counters is None else counters.data_ptr(),
            stream,
        )
    return out_parts, lse_parts


# the wide walk's merge counts, by (device, stream): the kernel leaves every
# count it takes back at 0, so a buffer is zeroed once, when it is made
_WIDE_COUNTERS: dict = {}


def _wide_counters(device, stream: int, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` counts for the wide walk's
    merge nodes, kept for launches on this device and stream (the kernel
    hands it back zeroed; launches on one stream run in turn)."""
    key = (str(device), int(stream))
    buf = _WIDE_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(int(n), 1024), dtype=torch.int32, device=device)
        _WIDE_COUNTERS[key] = buf
    return buf


def _apply_split_resilience(outs, lses):
    """The chaos injectors, then the guard, on each split partial (site
    ``split{i}``), upstream of the merge: ``(outs, lses, code)``, the code
    an int32 tensor on the partials' device (None with guards off). With
    chaos and guards off it returns the inputs and runs no tensor op."""
    from ..resilience import chaos, guards

    active = guards.guards_active()
    if not (chaos.enabled() or active):
        return outs, lses, None
    code = guards.new_error_code(outs[0].device) if active else None
    new_outs, new_lses = [], []
    for i, (o, l) in enumerate(zip(outs, lses)):
        site = f"split{i}"
        o, l = chaos.corrupt_partial(o, l, site)
        if active:
            o, l, code = guards.guard_partial(o, l, code, i, site)
        new_outs.append(o)
        new_lses.append(l)
    return new_outs, new_lses, code


def _split_census(outs, lses, merged_lse):
    """The value census of the split partials (after the resilience hooks,
    so that a planted corruption shows) and of the merge's softmax mass:
    one packed f32 vector on the partials' device, or None unless
    ``MAGI_ATTENTION_NUMERICS=census`` (then nothing runs)."""
    from ..telemetry import numerics

    if not numerics.census_active():
        return None
    vals: list = []
    for o, l in zip(outs, lses):
        vals.extend(numerics.site_summary(o, l))
    vals.append(numerics.mass_deviation(lses, merged_lse))
    return numerics.pack_census(vals)


def _merge_splits(out_parts, lse_parts):
    """The kernel's per-split partials merged: f32 (out [b, hq, d], lse [b, hq])."""
    return _merge_parts(out_parts, lse_parts)[:2]


def _merge_parts(out_parts, lse_parts):
    """The kernel's per-split partials through the resilience hooks, then
    merged: f32 (out [b, hq, d], lse [b, hq]), the guard code and the value
    census (None while off)."""
    s = out_parts.shape[1]
    outs, lses, code = _apply_split_resilience(
        [out_parts[:, i] for i in range(s)], [lse_parts[:, i] for i in range(s)])
    out, lse = merge_partials(outs, lses)
    return out, lse, code, _split_census(outs, lses, lse)


def _consume(code, census, num_splits: int) -> None:
    """The call boundary: read the split guard code (``check`` raises),
    then land the value census (layer ``decode``; one device-to-host copy)."""
    if code is not None:
        from ..resilience import guards

        guards.consume_error_code(code, guards.split_guard_sites(num_splits))
    if census is not None:
        from ..telemetry import numerics

        numerics.consume_census(census, numerics.census_keys(
            tuple(f"split{i}" for i in range(num_splits))), layer="decode")


def _plain(q, cache: PagedKVCache, bt) -> bool:
    """Whether decode takes its plain version: on CPU tensors, and on CUDA
    ones under ``MAGI_ATTENTION_KERNEL_BACKEND=torch|torch_online`` (the
    JAX package's jnp backends: both run the dense decode)."""
    from .. import env

    return not on_card(q, cache.k_pages, bt) or env.kernel_backend() != "cuda"


def _decode(q, cache: PagedKVCache, bt, seq_lens, params: DecodeParams):
    """Split-KV decode where the tensors are: f32 (out [b, hq, d], lse
    [b, hq]), the split guard code and the value census."""
    if _plain(q, cache, bt):
        return _decode_torch(q, cache, bt, seq_lens, params)
    return _merge_parts(*_decode_partials_kernel(q, cache, bt, seq_lens, params))


def _decode_shared_prefix(
    q: torch.Tensor,  # [m, hq, head_dim] the group's queries
    cache: PagedKVCache,
    shared_pages: torch.Tensor,  # [W] the page ids every member starts with
    prefix_len: int,  # tokens those pages hold
    *,
    num_splits: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's attention over ONE shared page row (the cascade's level
    1): the function :func:`decode_partials_for_tables` computes over the
    table that repeats ``shared_pages`` for every query. On CUDA the
    kernel's shared mode reads each shared page once for up to 32 q rows
    across members (8 on the float32 walk); on the CPU the plain version
    runs over the broadcast table. The split partials take the resilience
    hooks, and the guard code is read here, as the JAX package reads it in
    ``decode_partials_for_tables``. Returns f32 ``(out [m, hq, d], lse
    [m, hq])``."""
    _check_q(q, cache, "_decode_shared_prefix")
    m, _, d = q.shape
    params = DecodeParams(
        scale=float(scale if scale is not None else 1.0 / math.sqrt(d)),
        softcap=float(softcap),
        num_splits=_clamp_splits(num_splits, shared_pages.shape[0]),
        out_dtype=torch.float32,
    )
    bt = shared_pages.to(torch.int32)[None]  # [1, W]
    sl = torch.full((1,), int(prefix_len), dtype=torch.int32, device=bt.device)
    if _plain(q, cache, bt):
        out, lse, code, census = _decode_torch(q, cache, bt.expand(m, -1), sl.expand(m), params)
    else:
        out, lse, code, census = _merge_parts(*_decode_partials_kernel(q, cache, bt, sl, params,
                                                                       shared=True))
    _consume(code, census, params.num_splits)
    return out, lse


def _clamp_splits(num_splits: int, width: int) -> int:
    """Largest divisor of the table width not above the ask (at least 1)."""
    width = max(int(width), 1)
    n = max(1, min(int(num_splits), width))
    while width % n:
        n -= 1
    return n


def resolve_num_splits(
    num_splits: int | None,
    cache: PagedKVCache,
    batch: int,
    hq: int | None = None,
    *,
    mpp: int | None = None,
    prefix_groups: int = 0,
) -> int:
    """Explicit arg > ``MAGI_ATTENTION_DECODE_SPLITS`` > the split tuner
    (``tuning.select_decode_splits``, the ``decode`` fingerprint kind),
    clamped to a divisor of the table width: ``max_pages_per_seq``, or an
    explicit ``mpp`` (the cascade resolves each phase on its own table: the
    shared prefix's pages, then each member's suffix pages).
    ``prefix_groups`` (the cascade's group count, 0 for flat decode) and
    ``hq`` (default: the cache's kv heads) are fingerprint axes.

    The tuner prices the launch on the card: the kernel spreads each
    (sequence, kv head) walk over a cluster of up to 8 thread blocks itself,
    so a split pays only while the blocks leave SMs idle, and each split
    past the first costs a ``merge_partials`` round. On the geometries the
    serving paths run that is one split, the rule measured in the
    ``decode_timing`` split sweep. Its decision is memoised on the
    geometry: a repeat call is one dict lookup."""
    from .. import env

    mpp = max(int(cache.max_pages_per_seq if mpp is None else mpp), 1)
    if num_splits is None:
        num_splits = env.decode_splits()
    if num_splits is None:
        from ..tuning import select_decode_splits

        num_splits = select_decode_splits(
            batch, mpp, cache.page_size, cache.num_kv_heads if hq is None else hq,
            cache.num_kv_heads, head_dim=cache.head_dim, dtype=cache.k_pages.dtype,
            prefix_groups=prefix_groups, device=cache.k_pages.device,
        ).head_block  # the record's head_block is the split count
    return _clamp_splits(num_splits, mpp)


def _check_q(q, cache: PagedKVCache, where: str) -> None:
    b, hq, d = q.shape
    if d != cache.head_dim or hq % cache.num_kv_heads:
        raise ValueError(
            f"{where}: q {tuple(q.shape)} is incompatible with the cache's "
            f"[pages={cache.num_pages}, page_size={cache.page_size}, "
            f"kv_heads={cache.num_kv_heads}, head_dim={cache.head_dim}] "
            f"layout: need head_dim {d} == {cache.head_dim} and hq {hq} "
            f"divisible by kv_heads {cache.num_kv_heads}"
        )


def decode_partials_for_tables(
    q: torch.Tensor,  # [b, hq, head_dim]
    cache: PagedKVCache,
    bt: torch.Tensor,  # [b, W] page-id rows (any width W >= 1)
    seq_lens: torch.Tensor,  # [b] covered tokens WITHIN these tables
    *,
    num_splits: int = 1,
    scale: float | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-KV attention over EXPLICIT page tables (positions are
    table-relative). Returns f32 ``(out [b, hq, d], lse [b, hq])`` in the
    uncovered convention (rows with ``seq_lens == 0`` are ``(0, -inf)``)."""
    _check_q(q, cache, "decode_partials_for_tables")
    d = q.shape[2]
    params = DecodeParams(
        scale=float(scale if scale is not None else 1.0 / math.sqrt(d)),
        softcap=float(softcap),
        num_splits=_clamp_splits(num_splits, bt.shape[1]),
        out_dtype=torch.float32,
    )
    out, lse, code, census = _decode(q, cache, bt, seq_lens.to(torch.int32), params)
    _consume(code, census, params.num_splits)
    return out, lse


def decode_reference(
    q: torch.Tensor,  # [b, hq, head_dim]
    cache: PagedKVCache,
    bt: torch.Tensor,  # [b, W] page-id rows
    seq_lens: torch.Tensor,  # [b] true lengths within these tables
    *,
    scale: float | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-split f32 plain decode over explicit tables, on any device —
    the oracle the kernel is held against, outside every resilience hook (a
    planted fault hits the production output only). Returns f32 ``(out
    [b, hq, d], lse [b, hq])``."""
    b, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    W = bt.shape[1]
    shape = (b, W * cache.page_size, cache.num_kv_heads, cache.head_dim)
    k = cache.k_pages[bt.long()].reshape(shape)
    v = cache.v_pages[bt.long()].reshape(shape)
    return _split_partial_torch(q, k, v, 0, seq_lens, float(scale), float(softcap))


def decode_attn_paged(
    q: torch.Tensor,  # [b, hq, head_dim] one query token per sequence
    cache: PagedKVCache,
    slots: torch.Tensor,  # [b] int cache slots
    *,
    num_splits: int | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
    out_dtype: torch.dtype | None = None,
    cluster_heads: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-KV decode attention over the paged cache.

    Each query attends to its sequence's first ``seq_lens[slot]`` cached
    tokens (append the step's own KV first for standard causal decode).
    ``cluster_heads``: see :class:`DecodeParams` (0 for a call of its own).
    Under ``MAGI_ATTENTION_GUARD=check`` a non-finite split partial raises
    ``NumericalGuardError`` naming its splits; under ``repair`` its bad
    rows merge as no-ops. Returns ``(out [b, hq, head_dim] in out_dtype,
    lse [b, hq] f32)``.
    """
    from .. import env

    env.refuse_unhonoured_flags("decode_attn_paged")
    _check_q(q, cache, "decode_attn_paged")
    b, hq, d = q.shape
    params = DecodeParams(
        scale=float(scale if scale is not None else 1.0 / math.sqrt(d)),
        softcap=float(softcap),
        num_splits=resolve_num_splits(num_splits, cache, b, hq),
        out_dtype=out_dtype if out_dtype is not None else q.dtype,
        cluster_heads=int(cluster_heads),
    )
    slots = slots.to(device=cache.device, dtype=torch.long)
    bt = cache.block_tables[slots]  # [b, MPP]
    seq_lens = cache.seq_lens[slots]  # [b]
    with named_scope("magi_decode_attn"):
        out, lse, code, census = _decode(q, cache, bt, seq_lens, params)
    _consume(code, census, params.num_splits)
    return out.to(params.out_dtype), lse
