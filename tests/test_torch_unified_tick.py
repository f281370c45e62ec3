"""The one-launch serving tick against the JAX package's on the CPU:
``unified_tick_attn`` over the same cache and tick, and
``ServingEngine.unified_tick`` through a sequence of mixed ticks (decode
rows, prefill chunks, shared-prefix forks with copy-on-write, cascade pairs,
a fully-cached prompt's zero-token item), at page sizes 8 and 16. Results
within the float32 row of ``DEFAULT_BUDGETS``, block tables, lengths and
pages byte-identical, ``last_tick_info`` equal. Plus the zero-row tick, the
dual-phase refusal, the decode kernel's row-group bound and the fault paths
(the original error surfaces and the pages return)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops.block_sparse import TickEnumeration as JaxTick
from magiattention_tpu.serving import ServingEngine as JaxEngine
from magiattention_tpu.serving import unified_tick_attn as jax_unified_tick_attn
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch import csrc
from magiattention_tpu_torch.convert import cache_from_numpy, cache_to_numpy
from magiattention_tpu_torch.ops import TickEnumeration
from magiattention_tpu_torch.serving import (
    ServingEngine,
    decode_attn,
    demux_tick,
    unified_tick_attn,
)
from magiattention_tpu_torch.serving import engine as engine_mod
from tests.torch_jax_backend import jax_backend

HQ, HK, D = 4, 2, 32
BUDGET = DEFAULT_BUDGETS["float32"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    jax_backend(monkeypatch)
    monkeypatch.delenv("MAGI_ATTENTION_DECODE_SPLITS", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_CASCADE", raising=False)


def _rand(rng, *shape, positive=False):
    if positive:  # values away from zero: the ulp bound is meaningless near 0
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _close(ref_o, ref_l, out, lse, where=""):
    assert_within_budget(divergence_report(np.asarray(ref_o), out.numpy(),
                                           ref_lse=np.asarray(ref_l), test_lse=lse.numpy()),
                         BUDGET, where=where)


def _engines(ps, **kw):
    kw = dict(num_pages=64, num_kv_heads=HK, head_dim=D, page_size=ps, max_seqs=6,
              max_pages_per_seq=12, **kw)
    return JaxEngine(dtype=jnp.float32, **kw), ServingEngine(dtype=torch.float32, device="cpu",
                                                             **kw)


def _same_state(jeng, eng):
    got = cache_to_numpy(eng.cache)
    for name in ("block_tables", "seq_lens", "k_pages", "v_pages"):
        ref = np.asarray(getattr(jeng.cache, name))
        assert ref.dtype == got[name].dtype and ref.tobytes() == got[name].tobytes(), name
    assert jeng.allocator.occupancy() == eng.allocator.occupancy()


@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("ps", [8, 16])
def test_unified_tick_attn_matches_jax(ps, num_splits):
    """A mixed tick (two decode rows, a 3-token chunk re-attending
    mid-history, a cascade pair) on one cache through both packages."""
    rng = np.random.default_rng(3)
    jeng = JaxEngine(num_pages=32, num_kv_heads=HK, head_dim=D, page_size=ps, max_seqs=4,
                     max_pages_per_seq=8, dtype=jnp.float32, prefix_sharing=False)
    lens = (3 * ps + 5, ps + 1)
    slots = []
    for n in lens:
        res = jeng.admit(n)
        jeng.prefill(jnp.asarray(_rand(rng, n, HQ, D)), jnp.asarray(_rand(rng, n, HK, D)),
                     jnp.asarray(_rand(rng, n, HK, D, positive=True)), res.slot)
        slots.append(res.slot)
    cache = cache_from_numpy(*(np.asarray(getattr(jeng.cache, f)) for f in
                               ("k_pages", "v_pages", "block_tables", "seq_lens")))
    pages_a = jeng.allocator.slot_pages(slots[0])
    pages_b = jeng.allocator.slot_pages(slots[1])
    ticks = []
    for cls in (JaxTick, TickEnumeration):
        tick = cls(ps, min_rows=4)
        tick.add_decode("a", pages_a[: -(-lens[0] // ps)], lens[0])
        tick.add_decode("b", pages_b[: -(-lens[1] // ps)], lens[1])
        tick.add_prefill("p", pages_a[:2], start=ps + 1, tokens=3)
        tick.add_decode("c", pages_a[2:4], lens[0] - 2 * ps, prefix_pages=pages_a[:2],
                        prefix_len=2 * ps)
        ticks.append(tick)
    rows, _ = ticks[1].finalize()
    q = _rand(rng, rows, HQ, D)
    q[ticks[1].num_rows:] = 0.0
    seg_c = ticks[1].segments[-1]
    q[seg_c.prefix_row] = q[seg_c.row_lo]  # a member's two rows share its query
    jo, jl = jax_unified_tick_attn(jnp.asarray(q), jeng.cache, ticks[0], num_splits=num_splits)
    out, lse = unified_tick_attn(torch.from_numpy(q), cache, ticks[1], num_splits=num_splits)
    parts, jparts = demux_tick(ticks[1], out, lse), {}
    for seg in ticks[0].segments:
        jparts[seg.key] = (jo[seg.row_lo:seg.row_hi], jl[seg.row_lo:seg.row_hi])
    assert set(parts) == set(jparts) == {"a", "b", "p", "c"}
    for key, (o, l) in parts.items():
        _close(*jparts[key], o, l, where=f"segment {key}")
    # padding rows: the exact empty partial, the prefix row not demuxed
    n = ticks[1].num_rows
    assert torch.equal(out[n:], torch.zeros_like(out[n:]))
    assert bool(torch.isneginf(lse[n:]).all())


def test_unified_tick_attn_wants_the_padded_rows():
    tick = TickEnumeration(8)
    tick.add_decode("a", (1,), 3)
    eng = ServingEngine(num_pages=8, num_kv_heads=HK, head_dim=D, page_size=8,
                        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="row capacity"):
        unified_tick_attn(torch.zeros(1, HQ, D), eng.cache, tick)


def _run_ticks(ps, seed=11):
    """The same tick sequence through both engines; results compared per
    item, state after every tick."""
    rng = np.random.default_rng(seed)
    jeng, eng = _engines(ps)
    base = [int(t) for t in rng.integers(0, 40, 2 * ps + 3)]
    prompts, toks = {}, {}

    def admit(name, n, tokens=None):
        ja, a = jeng.admit(n, tokens=tokens), eng.admit(n, tokens=tokens)
        assert (ja.admitted, ja.slot, ja.reason, ja.prefix_len) == (
            a.admitted, a.slot, a.reason, a.prefix_len)
        prompts[name] = (a.slot, _rand(rng, n, HQ, D), _rand(rng, n, HK, D),
                         _rand(rng, n, HK, D, positive=True))
        toks[name] = a.prefix_len
        return a

    def tick(decode, prefill, **kw):
        d_np = [(prompts[n][0], _rand(rng, HQ, D), _rand(rng, HK, D),
                 _rand(rng, HK, D, positive=True)) for n in decode]
        p_np = []
        for name, lo, hi in prefill:
            slot, q, k, v = prompts[name]
            p_np.append((slot, q[lo:hi], k[lo:hi], v[lo:hi]))
        jd, jp = jeng.unified_tick([(s, *map(jnp.asarray, x)) for s, *x in d_np],
                                   [(s, *map(jnp.asarray, x)) for s, *x in p_np], **kw)
        d, p = eng.unified_tick([(s, *map(torch.from_numpy, x)) for s, *x in d_np],
                                [(s, *map(torch.from_numpy, x)) for s, *x in p_np], **kw)
        assert len(d) == len(jd) and len(p) == len(jp)
        for i, ((jo, jl), (o, l)) in enumerate(zip(jd + jp, d + p)):
            assert tuple(o.shape) == tuple(jo.shape) and tuple(l.shape) == tuple(jl.shape)
            if o.numel():
                _close(jo, jl, o, l, where=f"item {i}")
        info = dict(eng.last_tick_info)
        assert info == jeng.last_tick_info
        _same_state(jeng, eng)
        return info

    admit("a", 2 * ps + 3, tokens=base)
    admit("b", 13)
    infos = [tick([], [("a", 0, ps + 2), ("b", 0, 5)], num_splits=2)]
    infos.append(tick([], [("a", ps + 2, 2 * ps + 3), ("b", 5, 13)], num_splits=1))
    # forks on a's registered prompt: their first write splits the shared tail
    admit("c", 2 * ps + 7, tokens=base + [1, 2, 3, 4])
    admit("d", 2 * ps + 9, tokens=base + [5, 6, 7, 8, 9, 10])
    n = 2 * ps + 3
    infos.append(tick(["a", "b"], [("c", n, n + 4), ("d", n, n + 6)], cascade="on",
                      num_splits=1))
    infos.append(tick(["a", "b", "c", "d"], [], num_splits=1))  # cascade auto: {a, c, d}
    # a prompt the prefix covers whole: a zero-token item beside decode rows
    e = admit("e", 2 * ps + 3, tokens=base)
    infos.append(tick(["a", "c"], [("e", n, n)], num_splits=2))
    infos.append(tick([], [("e", n, n)]))  # no rows at all
    return infos, e, jeng, eng


@pytest.mark.parametrize("ps", [8, 16])
def test_engine_unified_tick_matches_jax(ps):
    infos, e, jeng, eng = _run_ticks(ps)
    assert [i["cascade_groups"] for i in infos] == [0, 0, 1, 1, 1, 0]
    assert infos[3]["cascade_group_of"] and len(infos[3]["cascade_group_of"]) == 3
    assert e.prefix_len == 2 * ps + 3
    assert infos[-1]["program"] is None and infos[0]["program"].startswith("tick[r=")
    assert eng.prefix.resident_pages == jeng.prefix.resident_pages


def test_zero_row_tick_and_dual_phase_refusal():
    jeng, eng = _engines(8)
    assert eng.unified_tick([], []) == ([], []) and eng.last_tick_info["program"] is None
    assert jeng.unified_tick([], []) == ([], [])
    res = eng.admit(4)
    jres = jeng.admit(4)
    q, k = torch.zeros(4, HQ, D), torch.zeros(4, HK, D)
    for engine, slot, mk in ((eng, res.slot, lambda x: x),
                             (jeng, jres.slot, lambda x: jnp.asarray(x.numpy()))):
        with pytest.raises(ValueError, match="both decode and prefill"):
            engine.unified_tick([(slot, mk(q[0]), mk(k[0]), mk(k[0]))],
                                [(slot, mk(q), mk(k), mk(k))])
    assert eng.allocator.pages_in_use == 1 and eng.length(res.slot) == 0


# -- the kernel's row-group bound ---------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
def test_decode_kernel_row_groups_bounded(shared, monkeypatch):
    """At 65535 row groups (gridDim.z) the wrapper launches once; past them
    it launches the rows in blocks of at most that many row groups, each
    block's rows, table rows and outputs at their offsets (recorded here,
    on CPU tensors)."""
    import types

    calls = []
    monkeypatch.setattr(csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    eng = ServingEngine(num_pages=4, num_kv_heads=1, head_dim=64, page_size=8,
                        dtype=torch.float32, device="cpu")
    prm = decode_attn.DecodeParams(0.125, 0.0, 1, torch.float32)
    per_group = decode_attn.KERNEL_SHARED_ROWS[torch.float32] if shared else 1
    limit = decode_attn.KERNEL_MAX_ROW_GROUPS * per_group
    rows = 1 if shared else limit
    bt, sl = torch.zeros(rows, 1, dtype=torch.int32), torch.zeros(rows, dtype=torch.int32)
    decode_attn._decode_partials_kernel(torch.zeros(limit, 1, 64), eng.cache, bt, sl, prm,
                                        shared=shared)
    assert [(n, a[7]) for n, a in calls] == [("paged_decode", limit)]
    if not shared:
        bt, sl = torch.zeros(limit + 1, 1, dtype=torch.int32), torch.zeros(limit + 1,
                                                                           dtype=torch.int32)
    calls.clear()
    q = torch.zeros(limit + per_group, 1, 64)
    out_parts, lse_parts = decode_attn._decode_partials_kernel(q, eng.cache, bt, sl, prm,
                                                               shared=shared)
    assert [(n, a[7]) for n, a in calls] == [("paged_decode", limit),
                                             ("paged_decode", per_group)]
    (_, first), (_, second) = calls
    item = q.element_size()
    assert second[0] - first[0] == limit * 64 * item  # q rows
    assert second[5] - first[5] == limit * 64 * 4  # out_parts rows (f32, 1 split, 1 head)
    assert second[6] - first[6] == limit * 4  # lse_parts rows
    table_step = 0 if shared else limit * 4  # one shared table row; else each block's rows
    assert second[3] - first[3] == table_step and second[4] - first[4] == table_step
    assert out_parts.shape[0] == lse_parts.shape[0] == limit + per_group


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("group", [1, 4, 8, 24, 48, 200])
@pytest.mark.parametrize("b", [0, 1, 65535, 65536, 70000, 8 * 65535 + 9, 600000])
def test_kernel_row_blocks(b, group, shared, dtype):
    """``kernel_row_blocks``: contiguous query ranges covering [0, b), one
    range when the batch fits, each range at most 65535 row groups
    (``kernel_row_slices`` per query flat: 1 up to one walk's rows, a wide
    group's row slices past them; KERNEL_SHARED_ROWS q rows, ``group`` a
    query, shared), every range but the last full. The bf16 flat groups
    past 32 rows (the wide walk) count walks instead, at most
    WIDE_MAX_WALKS a range (a query's row slices, at 1 kv head and 1
    split)."""
    blocks = decode_attn.kernel_row_blocks(b, group, dtype, shared)
    rows = decode_attn.KERNEL_SHARED_ROWS[dtype]
    slices = decode_attn.kernel_row_slices(group, dtype)
    assert slices == (1 if group <= {torch.bfloat16: 32, torch.float32: 64}[dtype]
                      else -(-group // {torch.bfloat16: 128, torch.float32: 64}[dtype]))
    groups = (lambda n: -(-n * group // rows)) if shared else (lambda n: n * slices)
    cap = decode_attn.KERNEL_MAX_ROW_GROUPS
    if dtype == torch.bfloat16 and not shared and group > 32:
        cap = decode_attn.WIDE_MAX_WALKS
    assert decode_attn.takes_wide_walk(group, dtype, shared) == (cap != decode_attn.KERNEL_MAX_ROW_GROUPS)
    assert blocks[0][0] == 0 and blocks[-1][1] == b
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(blocks, blocks[1:]))
    assert all(groups(hi - lo) <= cap for lo, hi in blocks)
    assert (len(blocks) == 1) == (groups(b) <= cap)
    assert all(groups(hi - lo + 1) > cap for lo, hi in blocks[:-1])


# -- the fault paths ------------------------------------------------------------------


class Planted(RuntimeError):
    pass


@pytest.mark.parametrize("free_first", [False, True], ids=["fault", "fault_after_free"])
def test_prefill_fault_surfaces_and_returns_the_pages(free_first, monkeypatch):
    """A failing kernel call mid prefill: the original error surfaces and
    the slot's pages return, also when releasing the slot fails itself (the
    slot was freed before the fault: a double free)."""
    eng = ServingEngine(num_pages=8, num_kv_heads=HK, head_dim=D, page_size=8, max_seqs=2,
                        max_pages_per_seq=4, dtype=torch.float32, device="cpu")
    res = eng.admit(20, tokens=list(range(20)))
    assert eng.allocator.pages_in_use == 3

    def failing(*a, **kw):
        if free_first:
            eng.free(res.slot)
        raise Planted("kernel launch failed")

    monkeypatch.setattr(engine_mod, "flex_flash_attn_func", failing)
    with pytest.raises(Planted):
        eng.prefill(torch.zeros(20, HQ, D), torch.zeros(20, HK, D), torch.zeros(20, HK, D),
                    res.slot)
    assert eng.allocator.pages_in_use == 0 and eng.allocator.active_seqs == 0
    assert eng.length(res.slot) == 0 and res.slot not in eng._tokens
    assert eng.admit(20).admitted


def test_unified_tick_fault_releases_prefill_slots_only(monkeypatch):
    eng = ServingEngine(num_pages=16, num_kv_heads=HK, head_dim=D, page_size=8, max_seqs=4,
                        max_pages_per_seq=4, dtype=torch.float32, device="cpu")
    dec = eng.admit(9)
    eng.prefill(torch.ones(9, HQ, D), torch.ones(9, HK, D), torch.ones(9, HK, D), dec.slot)
    pre = eng.admit(12)
    in_use = eng.allocator.pages_in_use

    def failing(*a, **kw):
        raise Planted("kernel launch failed")

    monkeypatch.setattr(engine_mod, "unified_tick_attn", failing)
    with pytest.raises(Planted):
        eng.unified_tick([(dec.slot, torch.ones(HQ, D), torch.ones(HK, D), torch.ones(HK, D))],
                         [(pre.slot, torch.ones(5, HQ, D), torch.ones(5, HK, D),
                           torch.ones(5, HK, D))])
    assert eng.allocator.pages_in_use == in_use - 2  # the prefill slot's two pages
    assert eng.allocator.active_seqs == 1 and eng.length(dec.slot) == 10
