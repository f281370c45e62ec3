"""The port's split-KV paged decode (plain version, CPU) against the JAX
package's ``decode_attn_paged`` in Pallas interpret mode (the path that
reaches ``_decode_pallas``) and under the jnp backend: same cache state
(carried across with ``convert.cache_from_numpy``) and queries, split
counts 1/2/4, ragged and zero lengths; out and lse within the float32 row
of ``telemetry.numerics.DEFAULT_BUDGETS``. The cascade's level-1 entry
``_decode_shared_prefix`` (the kernel's shared mode on the card) against
JAX ``decode_partials_for_tables`` over the broadcast table."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.serving import (
    assign_block_table as jax_assign,
    decode_attn_paged as jax_decode,
    decode_partials_for_tables as jax_partials,
    decode_reference as jax_reference,
    make_paged_kv_cache as jax_make_cache,
    write_prefill_kv as jax_write,
)
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.convert import cache_from_numpy
from magiattention_tpu_torch.serving.decode_attn import _decode_shared_prefix
from magiattention_tpu_torch.serving import (
    PagedKVCache,
    decode_attn_paged,
    decode_partials_for_tables,
    decode_reference,
    make_paged_kv_cache,
    resolve_num_splits,
)
from tests.torch_jax_backend import jax_backend

HQ, HK, D, PS, MPP = 4, 2, 32, 16, 8
LENGTHS = [0, 1, PS, 37, 100, MPP * PS]  # zero, one, a page boundary, ragged, full
BUDGET = DEFAULT_BUDGETS["float32"]


def _state(seed=0, lengths=LENGTHS, hq=HQ, hk=HK, d=D):
    """The same cache in both packages; page 0 left unreferenced, v positive
    (outputs stay away from zero, where ulp bounds measure summation order)."""
    rng = np.random.default_rng(seed)
    cache = jax_make_cache(len(lengths) * MPP + 1, PS, hk, d, max_seqs=len(lengths),
                           max_pages_per_seq=MPP, dtype=jnp.float32)
    for slot, t in enumerate(lengths):
        cache = jax_assign(cache, slot, list(range(1 + slot * MPP, 1 + (slot + 1) * MPP)))
        k = rng.standard_normal((t, hk, d)).astype(np.float32)
        v = rng.uniform(0.5, 1.5, (t, hk, d)).astype(np.float32)
        cache = jax_write(cache, slot, jnp.asarray(k), jnp.asarray(v))
    port = cache_from_numpy(*(np.asarray(x) for x in (
        cache.k_pages, cache.v_pages, cache.block_tables, cache.seq_lens)))
    q = rng.standard_normal((len(lengths), hq, d)).astype(np.float32)
    return cache, port, q


def _check(jo, jl, out, lse):
    assert_within_budget(divergence_report(
        np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl), test_lse=lse.numpy()), BUDGET)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_decode_matches_jax_pallas_interpret(splits):
    jcache, cache, q = _state()
    slots = np.arange(len(LENGTHS))
    jo, jl = jax_decode(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=splits,
                        interpret=True)
    out, lse = decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots),
                                 num_splits=splits)
    _check(jo, jl, out, lse)
    # the zero-length slot decodes to (0, -inf), NaN-free
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("hq,hk,d", [(48, 1, 128), (48, 1, 32), (24, 2, 32)],
                         ids=["g48_d128", "g48_d32", "g12_d32"])
def test_wide_groups_and_head_dim_32_match_jax_pallas_interpret(hq, hk, d):
    """The widths ``paged_decode`` took last: a multi-query group of 48 q
    heads (StarCoder-15B's layout) and head_dim 32, against JAX
    ``_decode_pallas`` in interpret mode, which has neither limit. out
    within the whole float32 row; lse within its absolute bound (1e-4): the
    one-token slot's lse is a single logit, which can sit near 0, where a
    few float32 rounding steps of two summation orders are thousands of
    ulps of the value."""
    jcache, cache, q = _state(seed=3, hq=hq, hk=hk, d=d)
    slots = np.arange(len(LENGTHS))
    budget = dataclasses.replace(BUDGET, lse_max_ulp=float("inf"))
    for splits in (1, 2):
        jo, jl = jax_decode(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=splits,
                            interpret=True)
        out, lse = decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots),
                                     num_splits=splits)
        assert_within_budget(divergence_report(
            np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl), test_lse=lse.numpy()), budget)


@pytest.mark.parametrize("softcap", [0.0, 4.0])
def test_decode_matches_jax_jnp_backend(softcap, monkeypatch):
    jax_backend(monkeypatch)
    jcache, cache, q = _state(seed=1)
    slots = np.asarray([5, 2, 0, 3])
    jo, jl = jax_decode(jnp.asarray(q[:4]), jcache, jnp.asarray(slots), num_splits=2,
                        softcap=softcap)
    out, lse = decode_attn_paged(torch.from_numpy(q[:4]), cache, torch.from_numpy(slots),
                                 num_splits=2, softcap=softcap)
    _check(jo, jl, out, lse)


def test_reference_and_explicit_tables_match_jax():
    jcache, cache, q = _state(seed=2)
    bt = np.array(jcache.block_tables)[:, 2:6]  # a table narrower than the cache's
    lens = np.minimum(np.asarray(jcache.seq_lens), 4 * PS).astype(np.int32)
    jo, jl = jax_reference(jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(lens))
    out, lse = decode_reference(torch.from_numpy(q), cache, torch.from_numpy(bt),
                                torch.from_numpy(lens))
    _check(jo, jl, out, lse)
    jo, jl = jax_partials(jnp.asarray(q), jcache, jnp.asarray(bt), jnp.asarray(lens),
                          num_splits=2, interpret=True)
    out, lse = decode_partials_for_tables(torch.from_numpy(q), cache, torch.from_numpy(bt),
                                          torch.from_numpy(lens), num_splits=2)
    _check(jo, jl, out, lse)


def test_resolve_num_splits(monkeypatch):
    cache = make_paged_kv_cache(64, 16, 2, 32, max_seqs=4, max_pages_per_seq=12,
                                device="cpu")
    assert resolve_num_splits(5, cache, 4) == 4  # largest divisor of 12 <= 5
    assert resolve_num_splits(100, cache, 4) == 12
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "3")
    assert resolve_num_splits(None, cache, 4) == 3
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "auto")
    # the Hopper rule: one split at any batch (the kernel spreads each walk
    # over a cluster of thread blocks; a split costs a merge round)
    assert resolve_num_splits(None, cache, 1) == 1
    assert resolve_num_splits(None, cache, 64) == 1
    assert resolve_num_splits(None, cache, 4, mpp=7) == 1


def test_incompatible_q_raises():
    _, cache, q = _state()
    with pytest.raises(ValueError, match="incompatible"):
        decode_attn_paged(torch.from_numpy(q[:, :3]), cache, torch.arange(len(LENGTHS)))


@pytest.mark.parametrize("softcap", [0.0, 4.0])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("members", [1, 3, 8])
def test_shared_prefix_matches_jax_partials_over_broadcast_table(members, group, ps, softcap):
    """Every member's query over one shared page row (a partial last page at
    page 16, so the mask runs), against JAX ``decode_partials_for_tables``
    in interpret mode on the table that repeats the row for each member."""
    rng = np.random.default_rng(members * 100 + group * 10 + ps + int(softcap))
    hk, w = 2, (4 if ps == 16 else 2)
    num_pages = 3 * w + 1
    k = rng.standard_normal((num_pages, ps, hk, D)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (num_pages, ps, hk, D)).astype(np.float32)
    jcache = jax_make_cache(num_pages, ps, hk, D, max_seqs=1, max_pages_per_seq=w,
                            dtype=jnp.float32)
    jcache = dataclasses.replace(jcache, k_pages=jnp.asarray(k), v_pages=jnp.asarray(v))
    cache = PagedKVCache(torch.from_numpy(k), torch.from_numpy(v),
                         torch.zeros((1, w), dtype=torch.int32),
                         torch.zeros((1,), dtype=torch.int32))
    pages = rng.permutation(np.arange(1, num_pages))[:w].astype(np.int32)
    prefix_len = w * ps - (3 if ps == 16 else 0)
    q = rng.standard_normal((members, group * hk, D)).astype(np.float32)
    splits = 2 if w % 2 == 0 else 1
    jo, jl = jax_partials(jnp.asarray(q), jcache, jnp.asarray(np.tile(pages, (members, 1))),
                          jnp.full((members,), prefix_len, jnp.int32), num_splits=splits,
                          softcap=softcap, interpret=True)
    out, lse = _decode_shared_prefix(torch.from_numpy(q), cache, torch.from_numpy(pages),
                                     prefix_len, num_splits=splits, softcap=softcap)
    _check(jo, jl, out, lse)
