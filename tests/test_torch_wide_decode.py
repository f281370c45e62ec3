"""The bf16 wide decode walk (``csrc/decode_wide_sm90.cuh``, a flat group of
more than 32 q heads) on the host: the cut the wrapper passes the kernel
(``serving.decode_attn.wide_schedule``) and its segment numbering
(``wide_segments``), the launch's row blocks, the split tuner's price of
it; and a plain model of the walk's arithmetic order (segments of 64-token
chunks, the two warpgroups' turns, the radix-8 merge tree) against the JAX
package's ``_decode_pallas`` in interpret mode on the same bf16 cache.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``'s ``wide_decode_cases``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.serving import (
    assign_block_table as jax_assign,
    decode_partials_for_tables as jax_partials,
    make_paged_kv_cache as jax_make_cache,
    write_prefill_kv as jax_write,
)
from magiattention_tpu_torch.serving import decode_attn as da
from magiattention_tpu_torch.tuning import autotuner

CHUNK = da.WIDE_CHUNK
RADIX = 8  # csrc/decode_wide_sm90.cuh MERGE_RADIX
# the card's bounds on the kernel against its plain version (PERF.md section 2)
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 2e-4


def _lengths(rng, b, width, ps):
    full = width * ps
    return [0, 1, full, *rng.integers(0, full + 1, size=max(b - 3, 0)).tolist()][:b]


# (batch, kv heads, table width, page size, splits, group)
CUTS = [(8, 1, 64, 128, 1, 48), (32, 1, 64, 128, 1, 48), (8, 1, 64, 128, 4, 71),
        (5, 2, 48, 16, 3, 96), (3, 1, 200, 16, 2, 200), (3, 1, 512, 64, 1, 33),
        (64, 8, 32, 128, 2, 40)]


@pytest.mark.parametrize("cut", CUTS, ids=[f"b{c[0]}_hk{c[1]}_w{c[2]}_ps{c[3]}_s{c[4]}_g{c[5]}"
                                           for c in CUTS])
def test_every_chunk_falls_in_exactly_one_segment(cut):
    """Each walk's 64-token chunks are cut into consecutive segments of
    ``seg_chunks`` (the last one shorter), each chunk in exactly one; a
    walk with no live token is one empty segment; no walk has more than
    ``max_segments``, so the scratch the wrapper sizes holds every slot."""
    b, hk, width, ps, splits, group = cut
    rng = np.random.default_rng(sum(cut))
    lens = _lengths(rng, b, width, ps)
    sched = da.wide_schedule(b, hk, width, ps, splits, group, 64, da.HOPPER_SMS)
    slices = da.kernel_row_slices(group, torch.bfloat16)
    segs = da.wide_segments(lens, sched, width, ps, splits, hk, slices)
    walks = b * hk * splits * slices
    assert sorted({s[0] for s in segs}) == list(range(walks))
    span = width // splits * ps
    by_walk = {}
    for walk, k, lo, hi in segs:
        by_walk.setdefault(walk, []).append((k, lo, hi))
    for walk, parts in by_walk.items():
        m, s = walk // (slices * splits * hk), walk // slices % splits
        chunks = -(-max(0, min(span, lens[m] - s * span)) // CHUNK)
        assert [k for k, _, _ in parts] == list(range(len(parts)))
        assert len(parts) <= sched.max_segments
        if chunks == 0:
            assert parts == [(0, 0, 0)]
            continue
        covered = [c for _, lo, hi in parts for c in range(lo, hi)]
        assert covered == list(range(chunks))  # every chunk once, in order
        assert all(hi - lo == sched.seg_chunks for _, lo, hi in parts[:-1])
    assert len(segs) <= walks * sched.max_segments
    assert sched.scratch_floats(walks) in (0, walks * sched.max_segments * sched.slot_floats)
    assert sched.slot_floats % 4 == 0  # 16-byte rows of the slot's accumulator


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("group", [48, 96, 200])
def test_a_tp_slice_cuts_its_walks_as_the_full_launch(tp, group):
    """A tensor-parallel head slice passes the pool's kv-head count
    (``cluster_heads``): its segment length and block-free layout (each
    walk's segments and their chunks) equal the full launch's walks of the
    same kv heads, so both merge the same partials in the same tree and
    give the same bits."""
    b, hk, width, ps, splits = 6, 4, 40, 16, 2
    lens = _lengths(np.random.default_rng(group + tp), b, width, ps)
    slices = da.kernel_row_slices(group, torch.bfloat16)
    full = da.wide_schedule(b, hk, width, ps, splits, group, 128, da.HOPPER_SMS)
    full_segs = da.wide_segments(lens, full, width, ps, splits, hk, slices)
    per = hk // tp
    for t in range(tp):
        part = da.wide_schedule(b, hk, width, ps, splits, group, 128, da.HOPPER_SMS)
        assert part == full
        own = da.wide_segments(lens, part, width, ps, splits, per, slices)
        for walk, k, lo, hi in own:
            z, rest = walk % slices, walk // slices
            s, rest = rest % splits, rest // splits
            h, m = rest % per, rest // per
            full_walk = ((m * hk + t * per + h) * splits + s) * slices + z
            assert (full_walk, k, lo, hi) in full_segs
    # a slice sized for its own heads would cut differently here
    own_cut = da.wide_schedule(b, per, width, ps, splits, group, 128, da.HOPPER_SMS)
    assert own_cut.seg_chunks <= full.seg_chunks


@pytest.mark.parametrize("hk,splits", [(1, 1), (2, 3), (8, 1)])
def test_row_blocks_of_the_wide_walk_count_walks(hk, splits):
    """A wide launch numbers at most WIDE_MAX_WALKS walks (a query is hk x
    splits x row slices of them); a batch past it launches in row blocks,
    which the whole batch's ``wide_schedule`` cuts alike."""
    for group in (48, 200):
        per_query = hk * splits * da.kernel_row_slices(group, torch.bfloat16)
        b = 3 * da.WIDE_MAX_WALKS // per_query + 5
        blocks = da.kernel_row_blocks(b, group, torch.bfloat16, False, hk=hk, splits=splits)
        assert blocks[0][0] == 0 and blocks[-1][1] == b
        assert all((hi - lo) * per_query <= da.WIDE_MAX_WALKS for lo, hi in blocks)
        assert all((hi - lo + 1) * per_query > da.WIDE_MAX_WALKS for lo, hi in blocks[:-1])
    with pytest.raises(ValueError, match="walks a launch"):
        da.kernel_row_blocks(1, 48, torch.bfloat16, False, hk=2049)


def test_the_split_tuner_prices_the_wide_walk(monkeypatch):
    """Past 32 q heads a kv head (bf16) the tuner counts the wide walk's
    blocks (the wrapper's cut) for each split count, not the cluster walk's;
    at the serving batch (StarCoder-15B's 48 / 1) they fill the card at one
    split already, so one split is chosen; at G 4 the cluster walk's blocks
    are counted as before."""
    calls = []
    real = autotuner._wide_decode_blocks

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(autotuner, "_wide_decode_blocks", spy)
    scored = autotuner._price_splits(8, 64, 128, 1, 128, "bfloat16", 132, group=48)
    assert [s for _, s in scored][0] == 1
    assert sorted(c[4] for c in calls) == sorted(s for _, s in scored)  # every split priced
    for rows, width, ps, hk, s, group, d, sms in calls:
        sched = da.wide_schedule(rows, hk, width, ps, s, group, d, sms)
        assert real(rows, width, ps, hk, s, group, d, sms) == sched.blocks(rows * hk * s)
    calls.clear()
    autotuner._price_splits(8, 64, 128, 8, 128, "bfloat16", 132, group=4)
    autotuner._price_splits(8, 64, 128, 1, 128, "float32", 132, group=48)  # the f32 WIDE mode
    assert calls == []
    from magiattention_tpu_torch import tuning

    tuning.reset_tuning_cache()
    dec = tuning.select_decode_splits(8, 64, 128, 48, 1, head_dim=128, dtype="bfloat16",
                                      device="cpu")
    assert dec.head_block == 1


# -- the walk's arithmetic order against JAX ----------------------------------------


def _chunk_update(st, q, k, v, scale, softcap):
    """One 64-token chunk of a warpgroup's online softmax (the kernel's
    consumer): natural exp against the running max, p rounded to bf16
    before P V, l over the unrounded p."""
    z = (q @ k.T) * scale
    if softcap > 0.0:
        z = softcap * torch.tanh(z / softcap)
    mnew = torch.maximum(st["m"], z.amax(-1))
    msafe = torch.where(torch.isneginf(mnew), 0.0, mnew)
    alpha = torch.where(torch.isneginf(st["m"]), 0.0, torch.exp(st["m"] - msafe))
    p = torch.exp(z - msafe[:, None])
    st["l"] = st["l"] * alpha + p.sum(-1)
    st["o"] = st["o"] * alpha[:, None] + p.to(torch.bfloat16).float() @ v
    st["m"] = mnew


def _merge(parts):
    """Partials merged as the kernel merges two warpgroups or a tree node's
    children: weights against the largest max, in order."""
    m = torch.stack([p["m"] for p in parts]).amax(0)
    ms = torch.where(torch.isneginf(m), 0.0, m)
    w = [torch.where(torch.isneginf(p["m"]), 0.0, torch.exp(p["m"] - ms)) for p in parts]
    return {"m": m, "l": sum(p["l"] * wi for p, wi in zip(parts, w)),
            "o": sum(p["o"] * wi[:, None] for p, wi in zip(parts, w))}


def _walk_model(q, k, v, n, seg, scale, softcap):
    """One walk (q [rows, d], its live tokens' k/v [n, d], f32 of bf16
    values): its segments, each walked by two warpgroups taking chunks in
    turn where the slice has at most 64 rows (else one walks every chunk),
    merged at the segment's end; then the radix-8 tree. Returns (out, lse)."""
    rows = q.shape[0]
    chunks = -(-n // CHUNK)
    nseg = max(1, -(-chunks // seg))
    turns = 2 if rows <= CHUNK else 1
    parts = []
    for s in range(nseg):
        sts = [{"m": torch.full((rows,), -math.inf), "l": torch.zeros(rows),
                "o": torch.zeros(rows, q.shape[1])} for _ in range(turns)]
        for i, c in enumerate(range(s * seg, min((s + 1) * seg, chunks))):
            lo, hi = c * CHUNK, min((c + 1) * CHUNK, n)
            _chunk_update(sts[i % turns], q, k[lo:hi], v[lo:hi], scale, softcap)
        parts.append(_merge(sts) if turns == 2 else sts[0])
    span = 1
    while span < nseg:
        for left in range(0, nseg, span * RADIX):
            kids = [parts[left + i * span] for i in range(RADIX) if left + i * span < nseg]
            if len(kids) > 1:
                parts[left] = _merge(kids)
        span *= RADIX
    st = parts[0]
    covered = st["l"] > 0
    out = torch.where(covered[:, None], st["o"] / torch.where(covered, st["l"], 1.0)[:, None], 0.0)
    ms = torch.where(torch.isneginf(st["m"]), 0.0, st["m"])
    lse = torch.where(covered, ms + torch.log(torch.where(covered, st["l"], 1.0)), -math.inf)
    return out, lse


@pytest.mark.parametrize("hq,hk,d,splits,softcap", [
    (48, 1, 32, 1, 0.0), (48, 1, 64, 2, 0.0), (71, 1, 32, 1, 30.0), (200, 1, 32, 1, 0.0),
    (96, 2, 32, 2, 0.0)], ids=["g48_d32", "g48_d64_s2", "g71_cap", "g200_slices", "g48_hk2"])
def test_the_walk_order_matches_jax_pallas_interpret(hq, hk, d, splits, softcap):
    """The model of the kernel's order, cut by ``wide_schedule`` at the
    wrapper's widths (the longest walk: nine segments, two tree levels),
    against JAX ``decode_partials_for_tables`` (``_decode_pallas`` in
    interpret mode) on the same bf16 cache, held to the card's bounds on
    the kernel against its plain version (bf16 P rounds against each
    chunk's running max here, each page's max there)."""
    ps, width = 16, 72
    lens = [0, 1, 65, 300, 777, width * ps]
    rng = np.random.default_rng(hq + d)
    jcache = jax_make_cache(len(lens) * width + 1, ps, hk, d, max_seqs=len(lens),
                            max_pages_per_seq=width, dtype=jnp.bfloat16)
    for slot, t in enumerate(lens):
        jcache = jax_assign(jcache, slot, list(range(1 + slot * width, 1 + (slot + 1) * width)))
        jcache = jax_write(jcache, slot,
                           jnp.asarray(rng.standard_normal((t, hk, d)), dtype=jnp.bfloat16),
                           jnp.asarray(rng.uniform(0.5, 1.5, (t, hk, d)), dtype=jnp.bfloat16))
    q = jnp.asarray(rng.standard_normal((len(lens), hq, d)), dtype=jnp.bfloat16)
    scale = 1.0 / math.sqrt(d)
    jo, jl = jax_partials(q, jcache, jcache.block_tables, jcache.seq_lens, num_splits=splits,
                          softcap=softcap, interpret=True)
    jo, jl = np.array(jo, dtype=np.float32), np.array(jl, dtype=np.float32)

    f32 = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
    kp, vp, qt = f32(jcache.k_pages), f32(jcache.v_pages), f32(q)
    bt = np.asarray(jcache.block_tables)
    group, slices = hq // hk, da.kernel_row_slices(hq // hk, torch.bfloat16)
    sched = da.wide_schedule(len(lens), hk, width, ps, splits, group, d, da.HOPPER_SMS)
    # the full-length walk: two tree levels at one split, a node of 5 at two
    assert sched.max_segments >= (9 if splits == 1 else 5)
    span = width // splits * ps
    outs = torch.zeros(len(lens), splits, hq, d)
    lses = torch.full((len(lens), splits, hq), -math.inf)
    for m, n_seq in enumerate(lens):
        pages = torch.from_numpy(bt[m].astype(np.int64))
        k_all = kp[pages].reshape(width * ps, hk, d)
        v_all = vp[pages].reshape(width * ps, hk, d)
        for h in range(hk):
            for s in range(splits):
                n = max(0, min(span, n_seq - s * span))
                k, v = k_all[s * span:s * span + n, h], v_all[s * span:s * span + n, h]
                for z in range(slices):
                    r0 = h * group + z * sched.slice_rows
                    r1 = h * group + min(group, (z + 1) * sched.slice_rows)
                    o, l = _walk_model(qt[m, r0:r1], k, v, n, sched.seg_chunks, scale, softcap)
                    outs[m, s, r0:r1], lses[m, s, r0:r1] = o, l
    out, lse = da._merge_splits(outs, lses)
    ref_o, ref_l = torch.from_numpy(jo), torch.from_numpy(jl)
    assert bool(((out - ref_o).abs() <= OUT_ATOL + OUT_RTOL * ref_o.abs()).all())
    assert bool((torch.isneginf(lse) == torch.isneginf(ref_l)).all())
    fin = torch.isfinite(ref_l)
    assert float((lse[fin] - ref_l[fin]).abs().max()) <= LSE_ATOL
