"""Disaggregated serving in the port (``serving/distributed.py``) against the
JAX package's on the CPU.

The JAX side runs on the suite's 8 emulated devices on the jnp backend
(``tests/torch_jax_backend.py``), the port on a list of ``"cpu"`` devices
(repeats allowed, as on one card). The cases mirror the JAX package's
``tests/test_serving/test_distributed.py`` at its sizes (4 q heads, 2 kv
heads, head_dim 32, page 8): the serving-mesh and tier-budget grammar, the
sharded pool, TP decode bit for bit equal to single-device decode (tp 2 and
4), stream digests equal to JAX's ``pages_digest``, a tiered trace whose
``StepReport``s equal JAX ``TieredScheduler``'s at ``decode=2x2`` with
decode outputs within 1e-6, per-tier anti-starvation, no requeue onto a
saturated tier, priority evictions as sids, and the organic replica fault
(a replica's pool exhausted mid-growth)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import env as jax_env
from magiattention_tpu import serving as jsv
from magiattention_tpu_torch import env
from magiattention_tpu_torch.serving import (
    DecodeTierFault,
    Request,
    Scheduler,
    ServingEngine,
    ShardedPagedKVCache,
    TieredEngine,
    TieredScheduler,
    append_kv,
    assign_block_table,
    copy_page,
    decode_attn_paged,
    gather_kv,
    gather_pages,
    make_paged_kv_cache,
    pages_digest,
    reset_slot,
    shard_kv_cache,
    swap_block_table_page,
    tp_decode_attn,
    write_prefill_kv,
)
from magiattention_tpu_torch.serving import distributed as dist_mod
from tests.torch_jax_backend import jax_backend

HQ, HK, D = 4, 2, 32
VOCAB = 89
_tok = np.random.default_rng(7)
EMB_K = _tok.standard_normal((VOCAB, HK, D)).astype(np.float32)
EMB_V = _tok.standard_normal((VOCAB, HK, D)).astype(np.float32)
GEOM = dict(num_pages=64, num_kv_heads=HK, head_dim=D, page_size=8, max_seqs=8,
            max_pages_per_seq=8)
CPU5 = ["cpu"] * 5


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "2")
    for name in ("MAGI_ATTENTION_SERVING_MESH", "MAGI_ATTENTION_PREFILL_CHUNK",
                 "MAGI_ATTENTION_UNIFIED_TICK", "MAGI_ATTENTION_TIER_BUDGET_PREFILL",
                 "MAGI_ATTENTION_TIER_BUDGET_DECODE"):
        monkeypatch.delenv(name, raising=False)


def _spec(rng, rid, tokens, gen, priority=0):
    tokens = [int(t) for t in tokens]
    n = len(tokens)
    return dict(rid=rid, prompt_q=rng.standard_normal((n, HQ, D)).astype(np.float32),
                prompt_k=EMB_K[tokens], prompt_v=EMB_V[tokens],
                decode_q=rng.standard_normal((gen, HQ, D)).astype(np.float32),
                decode_k=rng.standard_normal((gen, HK, D)).astype(np.float32),
                decode_v=rng.standard_normal((gen, HK, D)).astype(np.float32),
                tokens=tokens, priority=priority)


def _request(pkg, spec):
    conv, cls = (jnp.asarray, jsv.Request) if pkg == "jax" else (torch.from_numpy, Request)
    return cls(**{k: conv(v) if isinstance(v, np.ndarray) else v for k, v in spec.items()})


def _tiered(spec, **kw):
    return TieredEngine(mesh_spec=spec, devices=CPU5, dtype=torch.float32, **{**GEOM, **kw})


def _filled_cache(rng, lengths, hk=HK, ps=8, mpp=6):
    cache = make_paged_kv_cache(len(lengths) * mpp + 2, ps, hk, D, max_seqs=len(lengths),
                                max_pages_per_seq=mpp, dtype=torch.float32, device="cpu")
    for slot, t in enumerate(lengths):
        assign_block_table(cache, slot, list(range(1 + slot * mpp, 1 + (slot + 1) * mpp)))
        kv = torch.from_numpy(rng.standard_normal((2, t, hk, D)).astype(np.float32))
        write_prefill_kv(cache, slot, kv[0], kv[1])
    return cache


def _fields(report) -> dict:
    return {f.name: getattr(report, f.name) for f in dataclasses.fields(report)}


# -- env grammar --------------------------------------------------------------


@pytest.mark.parametrize("value", ["", "prefill=2,decode=2x2", "decode=4", "prefill=1",
                                   " Prefill = 3 , decode = 1x4 ", "serve=2", "decode",
                                   "decode=0", "decode=2x", "prefill=x", "decode=2,decode=3"])
def test_serving_mesh_grammar(value, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_SERVING_MESH", value)
    try:
        want = jax_env.serving_mesh()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            env.serving_mesh()
        assert str(got.value) == str(e)
        return
    assert env.serving_mesh() == want


def test_tier_budget_env(monkeypatch):
    assert env.tier_token_budget("prefill") == jax_env.tier_token_budget("prefill") == 256
    monkeypatch.setenv("MAGI_ATTENTION_TIER_BUDGET_DECODE", "32")
    assert env.tier_token_budget("decode") == jax_env.tier_token_budget("decode") == 32
    for value, tier in (("0", "decode"), ("32", "router")):
        monkeypatch.setenv("MAGI_ATTENTION_TIER_BUDGET_DECODE", value)
        with pytest.raises(ValueError) as want:
            jax_env.tier_token_budget(tier)
        with pytest.raises(ValueError) as got:
            env.tier_token_budget(tier)
        assert str(got.value) == str(want.value)


# -- the sharded pool and TP decode ---------------------------------------------


def test_shard_kv_cache_spans_devices():
    """Each shard its own tensors holding its head slice (a repeated device
    included), the tables copied whole; JAX's shards hold the same bytes. An
    indivisible head count raises."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(2)
    cache = _filled_cache(rng, [13, 21], mpp=4)
    sc = shard_kv_cache(cache, ["cpu", "cpu"])
    assert isinstance(sc, ShardedPagedKVCache) and sc.tp == 2 and sc.num_kv_heads == HK
    assert sc.shards[0].k_pages.data_ptr() != sc.shards[1].k_pages.data_ptr()
    for i, shard in enumerate(sc.shards):
        assert torch.equal(shard.k_pages, cache.k_pages[:, :, i:i + 1])
        assert torch.equal(shard.v_pages, cache.v_pages[:, :, i:i + 1])
        assert torch.equal(shard.block_tables, cache.block_tables)
        assert torch.equal(shard.seq_lens, cache.seq_lens)
    jcache = jsv.PagedKVCache(*(jnp.asarray(t.numpy()) for t in (
        cache.k_pages, cache.v_pages, cache.block_tables, cache.seq_lens)))
    jsc = jsv.shard_kv_cache(jcache, Mesh(np.asarray(jax.devices()[:2]), ("tp",)))
    for i, piece in enumerate(sorted(jsc.k_pages.addressable_shards,
                                     key=lambda s: s.index[2].start)):
        assert np.array_equal(np.asarray(piece.data), sc.shards[i].k_pages.numpy())
    plain = shard_kv_cache(cache, ["cpu"])  # one device: a plain copy
    assert not isinstance(plain, ShardedPagedKVCache)
    assert torch.equal(plain.k_pages, cache.k_pages)
    assert plain.k_pages.data_ptr() != cache.k_pages.data_ptr()
    with pytest.raises(ValueError, match="divisible"):
        shard_kv_cache(cache, ["cpu"] * 3)


def test_cache_ops_apply_shard_by_shard():
    """append / table install / CoW copy and swap / reset on a sharded pool
    leave it equal to the same ops on the whole pool, sharded after."""
    rng = np.random.default_rng(3)
    whole = _filled_cache(rng, [5, 9], mpp=4)
    sc = shard_kv_cache(whole, ["cpu", "cpu"])
    kn = torch.from_numpy(rng.standard_normal((2, HK, D)).astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((2, HK, D)).astype(np.float32))
    for c in (whole, sc):
        append_kv(c, torch.tensor([0, 1]), kn, vn)
        assign_block_table(c, 1, [5, 6, 7, 2], keep_len=True)
        copy_page(c, 5, 2)
        swap_block_table_page(c, 0, 1, 2)
        reset_slot(c, 0)
    ref = shard_kv_cache(whole, ["cpu", "cpu"])
    for a, b in zip(sc.shards, ref.shards):
        for name in ("k_pages", "v_pages", "block_tables", "seq_lens"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_matches_single_card_bitwise(tp):
    """TP decode over the KV-head-sharded pool equals single-device decode
    bit for bit (out and lse), at two splits (the merge runs)."""
    rng = np.random.default_rng(3)
    hk = 4  # tp 4 needs four kv heads
    cache = _filled_cache(rng, [37, 11, 24], hk=hk)
    q = torch.from_numpy(rng.standard_normal((3, 2 * hk, D)).astype(np.float32))
    slots = torch.arange(3, dtype=torch.int32)
    ref_out, ref_lse = decode_attn_paged(q, cache, slots, num_splits=2)
    devs = ["cpu"] * tp
    out, lse = tp_decode_attn(q, shard_kv_cache(cache, devs), slots, devices=devs, num_splits=2)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_tp_decode_sizes_each_slice_for_the_whole_pool(monkeypatch):
    """Each slice's launch carries the pool's kv-head count (``cluster_heads``)
    and the split count resolved once for the batch."""
    rng = np.random.default_rng(4)
    cache = _filled_cache(rng, [16, 30], hk=4)
    calls = []
    real = dist_mod.decode_attn_paged

    def record(q, c, slots, **kw):
        calls.append((q.shape[1], c.num_kv_heads, kw["cluster_heads"], kw["num_splits"]))
        return real(q, c, slots, **kw)

    monkeypatch.setattr(dist_mod, "decode_attn_paged", record)
    devs = ["cpu"] * 4
    tp_decode_attn(torch.ones((2, 8, D)), shard_kv_cache(cache, devs), torch.arange(2),
                   devices=devs, num_splits=3)
    assert calls == [(2, 1, 4, 3)] * 4


def test_tp_decode_head_divisibility_error():
    rng = np.random.default_rng(4)
    cache = _filled_cache(rng, [16])
    with pytest.raises(ValueError, match="not divisible"):
        tp_decode_attn(torch.ones((1, HQ, D)), cache, torch.tensor([0]), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must be sharded"):
        tp_decode_attn(torch.ones((1, HQ, D)), cache, torch.tensor([0]), devices=["cpu"] * 2)


# -- the page stream ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pages_digest_matches_jax(dtype):
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((3, 8, HK, D)).astype(np.float32) for _ in range(2))
    tk, tv = torch.from_numpy(k).to(getattr(torch, dtype)), torch.from_numpy(v).to(
        getattr(torch, dtype))
    jk, jv = (jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)) for x in (tk, tv))
    assert pages_digest(tk, tv) == jsv.pages_digest(jk, jv)


def test_page_stream_round_trips_exactly():
    """The streamed pages' digest equals the prefill tier's source pages'
    (and JAX's digest of them), and the decode replica's gathered KV equals
    the prefill tier's bit for bit; the prefill slot retires."""
    rng = np.random.default_rng(5)
    eng = _tiered({"prefill": 1, "decode_dp": 1, "decode_tp": 2}, verify_streams=True)
    toks = [int(t) for t in rng.integers(0, VOCAB, 21)]  # 2 full pages and a partial one
    res = eng.admit(len(toks), tokens=toks)
    assert res.admitted
    sid, pslot = res.slot, eng._seq[res.slot]["pslot"]
    seen = {}
    real = eng._stream_pages

    def snoop(src_pages, rep, dst_pages):
        seen["kv"] = gather_kv(eng._prefill.cache, pslot, max_len=len(toks))
        seen["pages"] = gather_pages(eng._prefill.cache, src_pages)
        return real(src_pages, rep, dst_pages)

    eng._stream_pages = snoop
    eng.prefill(torch.from_numpy(rng.standard_normal((21, HQ, D)).astype(np.float32)),
                torch.from_numpy(EMB_K[toks]), torch.from_numpy(EMB_V[toks]), sid)
    rec = eng._seq[sid]
    assert rec["stage"] == "decode" and eng.placed(sid)
    (report,) = eng.take_stream_reports()
    assert report.digest_ok is True and report.pages == 3 and report.tokens == 21
    assert report.nbytes == 2 * 3 * 8 * HK * D * 4
    rep = eng.replicas[rec["replica"]]
    dpages = rep.engine.allocator.slot_pages(rec["dslot"])[:3]
    src_digest = pages_digest(*seen["pages"])
    assert src_digest == pages_digest(*gather_pages(rep.engine.cache, dpages))
    assert src_digest == jsv.pages_digest(*(jnp.asarray(x.numpy()) for x in seen["pages"]))
    for i, shard in enumerate(rep.engine.cache.shards):
        dk, dv = gather_kv(shard, rec["dslot"], max_len=len(toks))
        assert torch.equal(dk, seen["kv"][0][:, i:i + 1]) and torch.equal(dv,
                                                                          seen["kv"][1][:, i:i + 1])
    assert eng._prefill.allocator.active_seqs == 0 and rep.engine.allocator.active_seqs == 1


def test_stream_parks_until_capacity_frees():
    rng = np.random.default_rng(6)
    eng = _tiered({"prefill": 1, "decode_dp": 1, "decode_tp": 1}, num_pages=8, max_seqs=2,
                  stream_queue_max=4)
    rep = eng.replicas[0]
    toks = [int(t) for t in rng.integers(0, VOCAB, 16)]
    res = eng.admit(len(toks), tokens=toks)
    assert res.admitted
    blocker = rep.engine.admit(8 * 8)  # the decode pool fills after the admission
    assert blocker.admitted
    eng.prefill(torch.from_numpy(rng.standard_normal((16, HQ, D)).astype(np.float32)),
                torch.from_numpy(EMB_K[toks]), torch.from_numpy(EMB_V[toks]), res.slot)
    assert eng.pending_streams == 1 and not eng.placed(res.slot)
    assert eng.pump_streams() == []
    rep.engine.free(blocker.slot)
    assert len(eng.pump_streams()) == 1 and eng.placed(res.slot)


# -- the tiered scheduler against JAX's ------------------------------------------------

TRACE_SPEC = {"prefill": 1, "decode_dp": 2, "decode_tp": 2}


def _trace():
    rng = np.random.default_rng(8)
    return [_spec(rng, i, rng.integers(0, VOCAB, 16), gen=1) for i in range(2)]


def _snoop_digests(eng, digests, pkg):
    """Record each stream's source-page digest, by sid, as JAX's own test
    snoops ``_place_stream``."""
    real = eng._place_stream

    def place(ps):
        pslot = eng._seq[ps.sid]["pslot"]
        pages = eng._prefill.allocator.slot_pages(pslot)[
            : eng._prefill.allocator.pages_needed(ps.length)]
        if pkg == "jax":
            idx = jnp.asarray(pages, jnp.int32)
            digests[ps.sid] = jsv.pages_digest(eng._prefill.cache.k_pages[idx],
                                               eng._prefill.cache.v_pages[idx])
        else:
            digests[ps.sid] = pages_digest(*gather_pages(eng._prefill.cache, pages))
        return real(ps)

    eng._place_stream = place


@pytest.fixture(scope="module")
def jax_trace_run():
    """JAX ``TieredScheduler`` at ``decode=2x2`` on the emulated devices: its
    reports, outputs and stream digests. Run once and kept short (two
    16-token prompts, one decode step each, one split): every call of its
    TP decode compiles its shard_map body op by op, about 6 s a replica."""
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        mp.setenv("MAGI_ATTENTION_DECODE_SPLITS", "1")
        eng = jsv.TieredEngine(mesh_spec=TRACE_SPEC, dtype=jnp.float32, verify_streams=True,
                               **GEOM)
        digests = {}
        _snoop_digests(eng, digests, "jax")
        sched = jsv.TieredScheduler(eng, prefill_budget=64, decode_budget=16, chunk=16)
        for spec in _trace():
            sched.submit(_request("jax", spec))
        reports = sched.run(max_steps=100)
        outs = {i: np.stack([np.asarray(x) for x in sched.result(i).decode_outs])
                for i in range(2)}
        return reports, outs, digests


def test_tiered_scheduler_matches_jax_2x2(jax_trace_run, monkeypatch):
    """The same trace through the port at ``decode=2x2`` (five devices, all
    the CPU): the same ``StepReport``s field for field, decode outputs
    within 1e-6, every stream's digest equal to JAX's and verified at the
    destination, and both replicas used."""
    want_reports, want_outs, want_digests = jax_trace_run
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "1")
    eng = _tiered(TRACE_SPEC, verify_streams=True)
    digests = {}
    _snoop_digests(eng, digests, "torch")
    sched = TieredScheduler(eng, prefill_budget=64, decode_budget=16, chunk=16)
    streams = []
    for spec in _trace():
        sched.submit(_request("torch", spec))
    reports = []
    while not sched.done:
        reports.append(sched.step())
        streams += sched.last_stream_reports
    assert [_fields(r) for r in reports] == [_fields(r) for r in want_reports]
    for i in range(2):
        got = torch.stack(sched.result(i).decode_outs).numpy()
        np.testing.assert_allclose(got, want_outs[i], atol=1e-6, rtol=1e-6)
    assert digests == want_digests and len(digests) == 2
    assert all(s.digest_ok for s in streams) and {s.replica for s in streams} == {0, 1}
    assert all(isinstance(r.engine.cache, ShardedPagedKVCache) for r in eng.replicas)


def test_tiered_scheduler_matches_single_engine():
    """``decode=2x1`` against the port's one-engine ``Scheduler`` on the same
    requests: decode outputs within 1e-6."""
    specs = [_spec(np.random.default_rng(9), i, np.random.default_rng(i).integers(0, VOCAB,
                                                                                 18 + 5 * i), 3)
             for i in range(4)]
    sched = TieredScheduler(_tiered({"prefill": 1, "decode_dp": 2, "decode_tp": 1}),
                            prefill_budget=64, decode_budget=16, chunk=16)
    ref = Scheduler(ServingEngine(dtype=torch.float32, device="cpu", **GEOM), token_budget=80,
                    chunk=16)
    for s in (sched, ref):
        for spec in specs:
            s.submit(_request("torch", spec))
        s.run(max_steps=100)
    for i in range(4):
        np.testing.assert_allclose(torch.stack(sched.result(i).decode_outs).numpy(),
                                   torch.stack(ref.result(i).decode_outs).numpy(),
                                   atol=1e-6, rtol=1e-6)


# -- tier placement and scheduling rules -----------------------------------------------


def test_decode_first_anti_starvation_per_tier():
    """While a long prompt drains chunk by chunk on the prefill tier, every
    tick with a placed decode batch runs decode."""
    rng = np.random.default_rng(10)
    eng = _tiered({"prefill": 1, "decode_dp": 2, "decode_tp": 1}, num_pages=96,
                  max_pages_per_seq=16)
    sched = TieredScheduler(eng, prefill_budget=16, decode_budget=8, chunk=16)
    for i in range(2):
        sched.submit(_request("torch", _spec(rng, i, rng.integers(0, VOCAB, 12), gen=12)))
    for _ in range(3):
        sched.step()
    sched.submit(_request("torch", _spec(rng, 99, rng.integers(0, VOCAB, 96), gen=1)))
    reports = sched.run(max_steps=100)
    chunk_steps = [r for r in reports if any(rid == 99 and n > 0 for rid, n in r.prefill_chunks)]
    assert len(chunk_steps) >= 4, "chunking did not engage"
    assert all(r.decode_ran for r in chunk_steps)


def test_requeue_never_lands_on_saturated_tier():
    """A request the saturated decode tier cannot take stays queued
    (``decode_saturated``) and admits once capacity frees."""
    rng = np.random.default_rng(11)
    eng = _tiered({"prefill": 1, "decode_dp": 1, "decode_tp": 1}, num_pages=16, max_seqs=4,
                  max_pages_per_seq=4)
    sched = TieredScheduler(eng, prefill_budget=32, decode_budget=8)
    rep = eng.replicas[0]
    blockers = [rep.engine.admit(4 * 8) for _ in range(4)]
    assert all(b.admitted for b in blockers)
    assert eng.admit(8).reason == "decode_saturated"
    sched.submit(_request("torch", _spec(rng, 0, rng.integers(0, VOCAB, 8), gen=2)))
    assert sched.step().admitted == () and sched.waiting == 1
    rep.engine.free(blockers[0].slot)
    sched.run(max_steps=50)
    assert sched.result(0).status == "finished"


def test_priority_eviction_translates_to_sids():
    """A higher-priority admission that evicts a prefill-tier resident
    reports the victim's sid, as JAX's engine does on the same calls."""
    kw = dict(num_pages=6, max_seqs=2, max_pages_per_seq=4)
    got = _tiered({"prefill": 1, "decode_dp": 1, "decode_tp": 1}, **kw)
    want = jsv.TieredEngine(mesh_spec={"prefill": 1, "decode_dp": 1, "decode_tp": 1},
                            dtype=jnp.float32, **{**GEOM, **kw})
    results = []
    for eng in (got, want):
        lo = eng.admit(30, priority=0, tokens=list(range(30)))
        hi = eng.admit(30, priority=5, tokens=list(range(30, 60)))
        results.append((lo.slot, hi.admitted, hi.slot, hi.evicted, sorted(eng._seq)))
    assert results[0] == results[1]
    assert results[0][0] in results[0][3] and results[0][0] not in got._seq


def test_decode_tier_eviction_requeues_the_victim():
    """A placement that evicts a lower-priority decode resident surfaces its
    sid; the scheduler requeues it (``priority_eviction``) and it finishes."""
    rng = np.random.default_rng(12)
    # 6 pages a tier: the 24-token resident (3 pages, growing to 4) and the
    # 40-token newcomer (5) cannot share the replica
    eng = _tiered({"prefill": 1, "decode_dp": 1, "decode_tp": 1}, num_pages=6, max_seqs=4,
                  max_pages_per_seq=6)
    sched = TieredScheduler(eng, prefill_budget=64, decode_budget=8)
    sched.submit(_request("torch", _spec(rng, 0, rng.integers(0, VOCAB, 24), gen=6)))
    sched.step()
    assert eng.placed(sched._active[0].slot)
    sched.submit(_request("torch", _spec(rng, 1, rng.integers(0, VOCAB, 40), gen=2, priority=3)))
    sched.run(max_steps=60)
    low = sched.result(0)
    assert low.status == "finished" and (("decode", "priority_eviction") in low.requeues)


def test_organic_replica_fault_tears_down_one_replica():
    """A replica whose pool runs out mid-growth fails alone: a
    DecodeTierFault names its sids, the replica is rebuilt with a fresh pool
    and the sequences are gone; through the scheduler its requests requeue,
    replay and finish with the outputs of a run that never failed."""
    rng = np.random.default_rng(13)
    # 3 pages a replica: two 8-token prompts fill 2, the third page goes to
    # the first growth, the second growth fails
    kw = dict(num_pages=3, max_seqs=2, max_pages_per_seq=3)
    eng = _tiered({"prefill": 1, "decode_dp": 1, "decode_tp": 2}, **kw)
    sids = []
    for _ in range(2):
        toks = [int(t) for t in rng.integers(0, VOCAB, 8)]
        res = eng.admit(8, tokens=toks)
        eng.prefill(torch.ones((8, HQ, D)), torch.from_numpy(EMB_K[toks]),
                    torch.from_numpy(EMB_V[toks]), res.slot)
        sids.append(res.slot)
    assert all(eng.placed(s) for s in sids)
    one = torch.ones((2, HQ, D)), torch.ones((2, HK, D)), torch.ones((2, HK, D))
    with pytest.raises(DecodeTierFault) as fault:
        eng.decode_step(*one, sids)
    assert fault.value.replica == 0 and fault.value.sids == tuple(sids)
    assert eng.replicas[0].restarts == 1 and eng.replicas[0].engine.allocator.pages_in_use == 0
    assert not any(eng.placed(s) for s in sids)

    # two replicas of 3 pages: the first and third request land on replica
    # 0 and the third's growth fails there; the replay places them apart
    specs = [_spec(rng, i, rng.integers(0, VOCAB, 8), gen=3) for i in range(3)]
    spec2 = {"prefill": 1, "decode_dp": 2, "decode_tp": 2}
    sched = TieredScheduler(_tiered(spec2, **kw), prefill_budget=64, decode_budget=8)
    ref = TieredScheduler(_tiered(spec2), prefill_budget=64, decode_budget=8)
    for s in (sched, ref):
        for spec in specs:
            s.submit(_request("torch", spec))
        s.run(max_steps=60)
    faulted = [i for i in range(3) if ("decode", "decode_fault") in sched.result(i).requeues]
    assert faulted and sched.engine.replicas[0].restarts >= 1
    assert not any(ref.result(i).requeues for i in range(3))
    for i in range(3):
        assert sched.result(i).status == "finished"
        np.testing.assert_allclose(torch.stack(sched.result(i).decode_outs).numpy(),
                                   torch.stack(ref.result(i).decode_outs).numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_aggregate_decode_scales_with_replicas():
    """The same requests drain in fewer decode ticks with two replicas than
    with one: each replica's slots bound its decode batch, so the tokens a
    tick grow with the replicas."""
    rng = np.random.default_rng(15)
    specs = [_spec(rng, i, rng.integers(0, VOCAB, 8), gen=6) for i in range(4)]
    tokens_per_tick = {}
    for dp in (1, 2):
        eng = _tiered({"prefill": 1, "decode_dp": dp, "decode_tp": 1}, num_pages=32, max_seqs=2,
                      max_pages_per_seq=4)
        sched = TieredScheduler(eng, prefill_budget=64, decode_budget=16)
        for spec in specs:
            sched.submit(_request("torch", spec))
        reports = sched.run(max_steps=200)
        total = sum(r.decode_batch for r in reports)
        assert total == 4 * 6
        tokens_per_tick[dp] = total / sum(1 for r in reports if r.decode_ran)
    assert tokens_per_tick[2] > tokens_per_tick[1], tokens_per_tick


def test_knobs_reach_every_tier():
    sched = TieredScheduler(_tiered({"prefill": 1, "decode_dp": 2, "decode_tp": 1}),
                            prefill_budget=64, decode_budget=16)
    applied = sched.apply_knobs(prefill_budget="32", cascade="off", decode_splits=2)
    assert applied == {"prefill_budget": 32, "cascade": "off", "decode_splits": 2}
    assert sched.token_budget == 48 and sched.knobs()["prefill_budget"] == 32
    engines = [sched.engine._prefill] + [r.engine for r in sched.engine.replicas]
    assert all(e.cascade_override == "off" and e.decode_splits_override == 2 for e in engines)
    with pytest.raises(ValueError, match="decode_budget"):
        sched.apply_knobs(decode_budget=0, chunk=8)
    assert sched.chunk is None  # a rejected update applies nothing


def test_substituted_decode_keeps_the_per_request_path(monkeypatch):
    """An engine with a substituted decode refuses ``unified_tick``; the
    scheduler then keeps the per-request path even under ``on``."""
    eng = ServingEngine(dtype=torch.float32, device="cpu",
                        decode_attn_fn=lambda q, c, s, **kw: decode_attn_paged(q, c, s, **kw),
                        **GEOM)
    with pytest.raises(ValueError, match="unified_tick does not compose"):
        eng.unified_tick([], [])
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", "on")
    sched = Scheduler(eng, token_budget=64)
    sched.submit(_request("torch", _spec(np.random.default_rng(1), 0, range(10), gen=2)))
    sched.run(max_steps=10)
    assert eng.last_tick_info == {} and eng.last_decode_info["num_splits"] == 0


def test_tiered_engine_needs_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredEngine(**GEOM)
    with pytest.raises(ValueError, match="needs 5 devices"):
        TieredEngine(mesh_spec=TRACE_SPEC, devices=["cpu"] * 4, **GEOM)
    monkeypatch.setenv("MAGI_ATTENTION_SERVING_MESH", "prefill=1,decode=1x2")
    eng = TieredEngine(devices=["cpu"] * 3, dtype=torch.float32, **GEOM)
    assert eng.mesh_spec == {"prefill": 1, "decode_dp": 1, "decode_tp": 2}
