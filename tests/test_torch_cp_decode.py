"""Context-parallel decode over gloo against the JAX package's
``cp_decode_attn`` on its virtual CPU mesh: each rank holds a contiguous,
uneven shard of every sequence's history in its local paged cache (one rank
holds nothing of one sequence), decodes it locally and merges across the
ranks. cp 1, 2 and 4 at 1 and 2 splits: the merged out and lse within the
float32 row of ``DEFAULT_BUDGETS`` of JAX's and of dense attention over the
whole history, the same on every rank; a merge that drops one rank's
partial must fail. ``cp_merge_partials`` against the two-rank formula, with
an uncovered rank carrying a garbage payload."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from magiattention_tpu.serving import assign_block_table, make_paged_kv_cache, write_prefill_kv
from magiattention_tpu.serving import cp_decode_attn as jax_cp_decode_attn
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    ErrorBudgetExceeded,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu.utils.compat import shard_map
from magiattention_tpu_torch.ops import correct_attn_out_lse
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

HQ, HK, D, PS, MPP = 4, 2, 32, 16, 4
LENS = (40, 64, 17)  # the sequences' whole histories
BUDGET = DEFAULT_BUDGETS["float32"]


@pytest.fixture(scope="module")
def pools():
    pools = {cp: RankPool(cp) for cp in (2, 4)}
    yield pools
    for p in pools.values():
        p.close()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    jax_backend(monkeypatch)
    monkeypatch.delenv("MAGI_ATTENTION_DECODE_SPLITS", raising=False)


def _problem(cp, seed=31):
    """Histories, a query a sequence and each rank's contiguous shards (the
    cut points drawn from the seed; the last rank holds none of sequence 0)."""
    rng = np.random.default_rng(seed)
    hist = [(rng.standard_normal((n, HK, D)).astype(np.float32),
             rng.uniform(0.5, 1.5, (n, HK, D)).astype(np.float32)) for n in LENS]
    q = rng.standard_normal((len(LENS), HQ, D)).astype(np.float32)
    shards = [[None] * len(LENS) for _ in range(cp)]
    for s, (k, v) in enumerate(hist):
        n = k.shape[0]
        cuts = np.sort(rng.integers(0, n + 1, cp - 1)).tolist()
        if s == 0 and cp > 1:
            cuts[-1] = n  # the last rank's shard of sequence 0 is empty
        bounds = [0] + cuts + [n]
        for r in range(cp):
            lo, hi = bounds[r], bounds[r + 1]
            shards[r][s] = (k[lo:hi], v[lo:hi])
    return hist, q, shards


def _dense(hist, q):
    outs, lses = [], []
    for (k, v), qs in zip(hist, q):
        kf = np.repeat(k.astype(np.float64), HQ // HK, 1)
        vf = np.repeat(v.astype(np.float64), HQ // HK, 1)
        z = np.einsum("hd,thd->ht", qs.astype(np.float64), kf) / math.sqrt(D)
        m = z.max(-1, keepdims=True)
        w = np.exp(z - m)
        outs.append(np.einsum("ht,thd->hd", w / w.sum(-1, keepdims=True), vf))
        lses.append(np.log(w.sum(-1)) + m[:, 0])
    return np.stack(outs), np.stack(lses)


def _jax_cache(mine):
    c = make_paged_kv_cache(len(mine) * MPP + 1, PS, HK, D, max_seqs=len(mine),
                            max_pages_per_seq=MPP, dtype=jnp.float32)
    for slot, (k, v) in enumerate(mine):
        c = assign_block_table(c, slot, list(range(1 + slot * MPP, 1 + (slot + 1) * MPP)))
        if k.shape[0]:
            c = write_prefill_kv(c, slot, jnp.asarray(k), jnp.asarray(v))
    return c


def _jax_cp_decode(shards, q, num_splits):
    cp = len(shards)
    caches = [_jax_cache(mine) for mine in shards]
    slots = jnp.arange(len(LENS))
    if cp == 1:
        return jax_cp_decode_attn(jnp.asarray(q), caches[0], slots, axis_name="cp", cp_size=1,
                                  num_splits=num_splits)
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))

    def step(cache, qq):
        cache = jax.tree_util.tree_map(lambda x: x[0], cache)
        return jax_cp_decode_attn(qq, cache, slots, axis_name="cp", cp_size=cp,
                                  num_splits=num_splits)

    f = shard_map(step, mesh=mesh, in_specs=(P("cp"), P()), out_specs=P(), check_vma=False)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *caches)
    return jax.jit(f)(stacked, jnp.asarray(q))


def _local_cache(mine):
    """One rank's local cache, built in this process (cp = 1)."""
    from magiattention_tpu_torch.serving import (
        assign_block_table as assign, make_paged_kv_cache as make, write_prefill_kv as write)

    cache = make(len(mine) * MPP + 1, PS, HK, D, max_seqs=len(mine), max_pages_per_seq=MPP,
                 dtype=torch.float32, device="cpu")
    for slot, (k, v) in enumerate(mine):
        assign(cache, slot, list(range(1 + slot * MPP, 1 + (slot + 1) * MPP)))
        write(cache, slot, torch.from_numpy(k), torch.from_numpy(v))
    return cache


@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("cp", [1, 2, 4])
def test_cp_decode_matches_jax_and_dense(cp, num_splits, pools):
    hist, q, shards = _problem(cp)
    if cp == 1:
        from magiattention_tpu_torch.serving import cp_decode_attn

        cache = _local_cache(shards[0])
        out, lse = cp_decode_attn(torch.from_numpy(q), cache, torch.arange(len(LENS)),
                                  group=None, cp_size=1, num_splits=num_splits)
        got = [{"out": out.numpy(), "lse": lse.numpy()}]
    else:
        got = pools[cp].run(workers.cp_decode, shards, q, num_splits, PS, MPP)
    for r in got[1:]:  # every rank holds the merged result
        np.testing.assert_array_equal(r["out"], got[0]["out"])
        np.testing.assert_array_equal(r["lse"], got[0]["lse"])
    jo, jl = _jax_cp_decode(shards, q, num_splits)
    ref_o, ref_l = _dense(hist, q)
    for ro, rl, where in ((jo, jl, "jax"), (ref_o, ref_l, "dense")):
        assert_within_budget(divergence_report(np.asarray(ro), got[0]["out"],
                                               ref_lse=np.asarray(rl), test_lse=got[0]["lse"]),
                             BUDGET, where=f"cp {cp} splits {num_splits} vs {where}")


def test_dropping_a_ranks_partial_is_caught(pools):
    hist, q, shards = _problem(2)
    got = pools[2].run(workers.cp_decode, shards, q, 1, PS, MPP, 1)[0]
    ref_o, ref_l = _dense(hist, q)
    # sequence 0: the dropped rank held nothing of it, so it still agrees
    assert_within_budget(divergence_report(ref_o[:1], got["out"][:1], ref_lse=ref_l[:1],
                                           test_lse=got["lse"][:1]), BUDGET)
    with pytest.raises(ErrorBudgetExceeded):
        assert_within_budget(divergence_report(ref_o, got["out"], ref_lse=ref_l,
                                               test_lse=got["lse"]), BUDGET)


def test_cp_merge_partials_is_the_two_rank_formula(pools):
    rng = np.random.default_rng(41)
    o = rng.standard_normal((2, 3, HQ, D)).astype(np.float32)
    lse = rng.standard_normal((2, 3, HQ)).astype(np.float32)
    lse[1, 0] = -np.inf  # rank 1 uncovered for sequence 0...
    o[1, 0] = np.nan  # ...with a garbage payload
    got = pools[2].run(workers.cp_merge, o, lse)
    ref_o, ref_l = correct_attn_out_lse(*(torch.from_numpy(x) for x in (
        np.where(np.isnan(o[0]), 0.0, o[0]).astype(np.float32), lse[0],
        np.where(np.isnan(o[1]), 0.0, o[1]).astype(np.float32), lse[1])))
    for r in got:
        assert np.isfinite(r["out"]).all()
        np.testing.assert_allclose(r["out"], ref_o.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["lse"], ref_l.numpy(), atol=1e-6)
