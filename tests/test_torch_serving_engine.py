"""The serving slice as a whole: the same admissions, prompts (one chunked
through ``MAGI_ATTENTION_PREFILL_CHUNK``) and decode steps through the JAX
package's ``ServingEngine`` and the port's, on the CPU. Prefill and decode
out/lse within the float32 row of ``DEFAULT_BUDGETS``; block tables and
sequence lengths byte-identical; page contents equal. Plus the cache ops,
the page allocator and admission control against their JAX twins, and the
numpy state converters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops.block_meta import build_block_meta as jax_build
from magiattention_tpu.serving import (
    PageAllocator as JaxAllocator,
    ServingEngine as JaxEngine,
    append_kv as jax_append,
    assign_block_table as jax_assign,
    gather_kv as jax_gather,
    make_paged_kv_cache as jax_make_cache,
    reset_slot as jax_reset,
    write_prefill_kv as jax_write,
)
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.convert import (
    block_meta_from_numpy,
    block_meta_to_numpy,
    cache_from_numpy,
    cache_to_numpy,
)
from magiattention_tpu_torch.ops import build_block_meta, flex_attn_with_meta
from magiattention_tpu_torch.serving import (
    InvalidFreeError,
    PageAllocator,
    PageAllocatorError,
    PageShareError,
    ServingEngine,
    append_kv,
    assign_block_table,
    gather_kv,
    make_paged_kv_cache,
    reset_slot,
    write_prefill_kv,
)
from tests.torch_jax_backend import jax_backend

HQ, HK, D, PS = 4, 2, 32, 16
BUDGET = DEFAULT_BUDGETS["float32"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX engine on its dense jnp backend, both engines on 2 splits
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "2")


def _engines(num_pages=32, max_seqs=4, mpp=8):
    kw = dict(num_pages=num_pages, num_kv_heads=HK, head_dim=D, page_size=PS,
              max_seqs=max_seqs, max_pages_per_seq=mpp)
    return JaxEngine(dtype=jnp.float32, **kw), ServingEngine(dtype=torch.float32, device="cpu", **kw)


def _rand(rng, *shape, positive=False):
    if positive:  # values: keep outputs away from zero (see the flex tests)
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _same_state(jeng, eng):
    ref = {k: np.asarray(getattr(jeng.cache, k)) for k in
           ("k_pages", "v_pages", "block_tables", "seq_lens")}
    got = cache_to_numpy(eng.cache)
    for name in ("block_tables", "seq_lens"):
        assert ref[name].dtype == got[name].dtype
        assert ref[name].tobytes() == got[name].tobytes(), name
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(ref[name], got[name])


def _close(jo, jl, out, lse):
    assert_within_budget(divergence_report(
        np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl), test_lse=lse.numpy()), BUDGET)


@pytest.mark.parametrize("chunk", [None, 16], ids=["one_shot", "chunked"])
def test_engines_agree_end_to_end(chunk, monkeypatch):
    rng = np.random.default_rng(5)
    jeng, eng = _engines()
    prompts = [30, 9, 50]
    slots = []
    for t in prompts:
        ja, a = jeng.admit(t), eng.admit(t)
        assert (ja.admitted, ja.slot, ja.reason) == (a.admitted, a.slot, a.reason)
        slots.append(a.slot)
    _same_state(jeng, eng)
    for slot, t in zip(slots, prompts):
        q, k, v = _rand(rng, t, HQ, D), _rand(rng, t, HK, D), _rand(rng, t, HK, D, positive=True)
        if chunk is not None and t > chunk:
            monkeypatch.setenv("MAGI_ATTENTION_PREFILL_CHUNK", str(chunk))
        jo, jl = jeng.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slot)
        o, l = eng.prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), slot)
        monkeypatch.delenv("MAGI_ATTENTION_PREFILL_CHUNK", raising=False)
        _close(jo, jl, o, l)
    _same_state(jeng, eng)
    for _ in range(4):  # the 30-token prompt crosses into a fresh page
        q = _rand(rng, len(slots), HQ, D)
        k, v = _rand(rng, len(slots), HK, D), _rand(rng, len(slots), HK, D, positive=True)
        jo, jl = jeng.decode_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slots)
        o, l = eng.decode_step(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), slots)
        _close(jo, jl, o, l)
        _same_state(jeng, eng)
    assert [eng.length(s) for s in slots] == [t + 4 for t in prompts]
    assert jeng.allocator.occupancy() == eng.allocator.occupancy()
    for s in slots:
        jeng.free(s)
        eng.free(s)
    _same_state(jeng, eng)
    assert eng.allocator.pages_in_use == 0
    with pytest.raises(InvalidFreeError):
        eng.free(slots[0])


def test_admission_backpressure_and_eviction_match():
    jeng, eng = _engines(num_pages=6, max_seqs=3, mpp=4)
    asks = [(40, 0), (30, 0), (20, 1), (64, 0), (16, 2), (100, 5), (10, 0), (10, 0)]
    for tokens, prio in asks:
        ja, a = jeng.admit(tokens, priority=prio), eng.admit(tokens, priority=prio)
        assert (ja.admitted, ja.slot, ja.reason, ja.evicted) == (
            a.admitted, a.slot, a.reason, a.evicted), (tokens, prio)
    assert jeng.allocator.occupancy() == eng.allocator.occupancy()
    _same_state(jeng, eng)


def test_cache_ops_match():
    rng = np.random.default_rng(9)
    jc = jax_make_cache(12, PS, HK, D, max_seqs=3, max_pages_per_seq=3, dtype=jnp.float32)
    c = make_paged_kv_cache(12, PS, HK, D, max_seqs=3, max_pages_per_seq=3,
                            dtype=torch.float32, device="cpu")
    for slot, pages in ((0, [3, 1, 7]), (1, [2, 5]), (2, [4, 6, 8])):
        jc = jax_assign(jc, slot, pages)
        assign_block_table(c, slot, pages)
    k, v = _rand(rng, 40, HK, D), _rand(rng, 40, HK, D)
    jc = jax_write(jc, 0, jnp.asarray(k), jnp.asarray(v), length=35)
    write_prefill_kv(c, 0, torch.from_numpy(k), torch.from_numpy(v), length=35)
    jc = jax_write(jc, 2, jnp.asarray(k), jnp.asarray(v))
    write_prefill_kv(c, 2, torch.from_numpy(k), torch.from_numpy(v))
    jc = jax_write(jc, 2, jnp.asarray(k[:20]), jnp.asarray(v[:20]))  # past capacity: cut
    write_prefill_kv(c, 2, torch.from_numpy(k[:20]), torch.from_numpy(v[:20]))
    for _ in range(3):  # slot 2 is full: its appends are dropped
        kn, vn = _rand(rng, 3, HK, D), _rand(rng, 3, HK, D)
        jc = jax_append(jc, jnp.asarray([0, 1, 2]), jnp.asarray(kn), jnp.asarray(vn))
        append_kv(c, torch.tensor([0, 1, 2]), torch.from_numpy(kn), torch.from_numpy(vn))
    jc = jax_assign(jc, 1, [2, 5, 9], keep_len=True)
    assign_block_table(c, 1, [2, 5, 9], keep_len=True)
    for slot in range(3):
        jk, jv = jax_gather(jc, slot, max_len=40)
        gk, gv = gather_kv(c, slot, max_len=40)
        np.testing.assert_array_equal(np.asarray(jk), gk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), gv.numpy())
    jc = jax_reset(jc, 0)
    reset_slot(c, 0)
    got = cache_to_numpy(c)
    for name in ("k_pages", "v_pages", "block_tables", "seq_lens"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)), got[name])
    with pytest.raises(ValueError, match="overflow"):
        assign_block_table(c, 0, [1, 2, 3, 4])
    with pytest.raises(ValueError, match="keep_len"):
        assign_block_table(c, 0, [1], keep_len=17)


def _run_allocator(alloc, ops):
    """Apply ops, recording each result or the error's class name."""
    log = []
    for op, *args in ops:
        try:
            log.append(getattr(alloc, op)(*args))
        except (PageAllocatorError, RuntimeError, KeyError) as exc:
            log.append(type(exc).__name__)
    log.append(alloc.occupancy())
    return log


def test_page_allocator_matches():
    ops = [
        ("allocate", 40), ("allocate", 10), ("fork", [0, 1], 50), ("extend", 0, 64),
        ("cow_page", 2, 1), ("cow_page", 1, 0), ("retain", [5]), ("release_pages", [5]),
        ("retain", [30]), ("free", 1), ("free", 1), ("allocate", 400), ("extend", 0, 999),
        ("free", 2), ("allocate", 16), ("allocate", 16), ("allocate", 16), ("allocate", 16),
        ("slot_pages", 0), ("reserved_pages", 7), ("free", 0),
    ]
    ref = _run_allocator(JaxAllocator(16, PS, 4, 5), ops)
    got = _run_allocator(PageAllocator(16, PS, 4, 5), ops)
    assert got == ref
    assert "PageShareError" in got and "InvalidFreeError" in got
    assert issubclass(PageShareError, PageAllocatorError)


def test_converters_round_trip_and_plan_import():
    rng = np.random.default_rng(3)
    jc = jax_make_cache(4, PS, HK, D, max_seqs=2, max_pages_per_seq=2, dtype=jnp.bfloat16)
    jc = jax_assign(jc, 1, [3, 0])
    jc = jax_write(jc, 1, jnp.asarray(_rand(rng, 20, HK, D), jnp.bfloat16),
                   jnp.asarray(_rand(rng, 20, HK, D), jnp.bfloat16))
    c = cache_from_numpy(*(np.asarray(x) for x in (
        jc.k_pages, jc.v_pages, jc.block_tables, jc.seq_lens)))
    assert c.k_pages.dtype == torch.bfloat16 and c.block_tables.dtype == torch.int32
    back = cache_to_numpy(c)
    np.testing.assert_array_equal(back["k_pages"], np.asarray(jc.k_pages, np.float32))
    np.testing.assert_array_equal(back["seq_lens"], np.asarray(jc.seq_lens))

    qr, kr, ty = [(0, 40), (40, 100)], [(0, 40), (0, 100)], [1, 1]
    jmeta = jax_build(qr, kr, ty, 100, 100, block_q=32, block_k=32)
    meta = block_meta_from_numpy(jmeta)
    own = build_block_meta(qr, kr, ty, 100, 100, block_q=32, block_k=32)
    for name, value in block_meta_to_numpy(own).items():
        np.testing.assert_array_equal(np.asarray(getattr(meta, name)), np.asarray(value))
    q = torch.from_numpy(_rand(rng, 100, HQ, D))
    k, v = torch.from_numpy(_rand(rng, 100, HK, D)), torch.from_numpy(_rand(rng, 100, HK, D))
    a = flex_attn_with_meta(q, k, v, meta)
    b = flex_attn_with_meta(q, k, v, own)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
