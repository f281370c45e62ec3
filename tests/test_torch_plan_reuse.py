"""Fingerprint-bucketed plan reuse under the keyed API
(``MAGI_ATTENTION_PLAN_REUSE=bucket``) against the JAX package's.

A stream of six varlen-causal requests (cp=2 over gloo on the CPU, chunk
64, 4 / 2 heads, d 32, float32) goes through ``magi_attn_varlen_key`` ->
``dispatch`` -> ``calc_attn`` -> ``undispatch`` and its backward in the
port, and through JAX's ``magi_attn_varlen_key`` on a 2-device CPU mesh
(jnp backend, 64 x 64 tiles pinned). A: cold (the canonical documents
[320, 512, 160, 640]); B: a bucket hit on A's canonical plan; C: B again,
an exact hit on B's runtime; D: B with its last document grown by 10 rows,
a bucket hit through the O(delta) tail extend of B's row maps; E: the
canonical documents themselves, an exact hit on the canonical runtime; F:
another bucket, cold. Held: each request's tier the same as JAX's and as
predicted, the three adapter tables byte-identical to JAX's, out / lse /
dq / dk / dv against JAX's and against the fp64 single-device oracle on
the request's real mask through the port's ``assert_within_budget`` (the
float32 row of ``DEFAULT_BUDGETS`` on positive ``v``; a gradient's whole
row on its entries of at least 1% of its largest magnitude, the absolute
bound on all), C bitwise B; ``roll`` and both new-mask keys refusing a
bucketed key with JAX's typed error; ``clear_cache`` per group and whole;
qo-comm opting out of reuse; the one-call and low-level entry points on
A's mask; the env validation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chip_smoke import key_tier
from magiattention_tpu import api as jax_api
from magiattention_tpu import env as jax_env
from magiattention_tpu.api import interface as jax_iface
from magiattention_tpu_torch import env
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.api.functools import infer_attn_mask_from_cu_seqlens
from magiattention_tpu_torch.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.testing import ref_attn_from_ranges
from magiattention_tpu_torch.testing.dist import RankPool

from . import torch_dist_workers as workers
from .torch_jax_backend import jax_backend

HQ, HK, D, CHUNK = 4, 2, 32, 64
STREAM = [
    ("A", [300, 500, 150, 600]),
    ("B", [290, 470, 140, 590]),
    ("C", [290, 470, 140, 590]),
    ("D", [290, 470, 140, 600]),
    ("E", [320, 512, 160, 640]),
    ("F", [700, 700, 200]),
]
PREDICTED = {"A": "cold", "B": "bucket", "C": "exact", "D": "bucket", "E": "exact", "F": "cold"}
BUDGET = DEFAULT_BUDGETS["float32"]
ABS_ONLY = dataclasses.replace(BUDGET, max_rel=float("inf"), max_ulp=float("inf"))
NEAR_ZERO = 1e-2  # of a gradient's largest magnitude


def _cu(docs):
    return np.concatenate([[0], np.cumsum(docs)]).astype(int).tolist()


def _inputs():
    """Per request, from one numpy seed (C reuses B's); positive ``v``."""
    rng = np.random.default_rng(13)
    out = {}
    for name, docs in STREAM:
        if name == "C":
            out[name] = out["B"]
            continue
        t = sum(docs)
        f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
        out[name] = dict(q=f(t, HQ, D), k=f(t, HK, D),
                         v=rng.uniform(0.5, 1.5, (t, HK, D)).astype(np.float32),
                         g_out=f(t, HQ, D), g_lse=f(t, HQ))
    return out


def _jax_stream(inputs):
    """JAX's keyed path on the same stream; the caller sets the env."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("cp",))
    res = {}
    for name, docs in STREAM:
        cu = _cu(docs)
        key, tier, _, patched = key_tier(jax_iface, lambda: jax_api.magi_attn_varlen_key(
            cu, cu[-1], mesh, num_heads=(HQ, HK), head_dim=D, chunk_size=CHUNK,
            out_dtype="float32"))
        x = inputs[name]
        g_out, g_lse = jnp.asarray(x["g_out"]), jnp.asarray(x["g_lse"])

        def fwd(q, k, v, key=key):
            out_d, meta = jax_api.calc_attn(*(jax_api.dispatch(a, key) for a in (q, k, v)), key)
            return jax_api.undispatch(out_d, key), jax_api.undispatch(meta.lse, key)

        def loss(q, k, v, g_out=g_out, g_lse=g_lse, fwd=fwd):
            o, lse = fwd(q, k, v)
            return (o * g_out).sum() + jnp.where(jnp.isneginf(lse), 0.0, lse * g_lse).sum()

        args = tuple(jnp.asarray(x[n]) for n in "qkv")
        out, lse = jax.jit(fwd)(*args)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
        mgr = jax_api.get_runtime_mgr(key)
        r = {"tier": tier, "patched": patched,
             "bucketed": isinstance(mgr, jax_iface.BucketedDistAttnRuntimeMgr),
             "canonical_total": mgr.dispatch_meta.total_seqlen,
             "out": np.asarray(out), "lse": np.asarray(lse),
             **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}
        if r["bucketed"]:
            r.update(dispatch_idx=mgr._bucket_dispatch_idx,
                     undispatch_idx=mgr._bucket_undispatch_idx,
                     position_ids=mgr._bucket_position_ids)
        res[name] = r
    return res


@pytest.fixture(scope="module")
def streams():
    inputs = _inputs()
    with RankPool(2) as pool:
        port = pool.run(workers.plan_reuse_stream, {"chunk": CHUNK},
                        [(n, _cu(d)) for n, d in STREAM], inputs)
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        for name, val in (("MAGI_ATTENTION_BLOCK_Q", "64"), ("MAGI_ATTENTION_BLOCK_K", "64"),
                          ("MAGI_ATTENTION_PLAN_REUSE", "bucket")):
            mp.setenv(name, val)
        jax_api.clear_cache()
        try:
            ref = _jax_stream(inputs)
        finally:
            jax_api.clear_cache()
    return {"port": port, "jax": ref, "inputs": inputs}


def test_tiers_match_jax_and_the_prediction(streams):
    for rank in streams["port"]:
        got = {n: r["tier"] for n, r in rank["requests"].items()}
        assert got == {n: r["tier"] for n, r in streams["jax"].items()} == PREDICTED
        for n, r in rank["requests"].items():
            assert r["patched"] == streams["jax"][n]["patched"] == (n == "D"), n
            assert r["bucketed"] == streams["jax"][n]["bucketed"] == (n != "E"), n
            assert r["most_recent_is_key"], n


def test_adapter_tables_are_jax_bytes(streams):
    rank0, rank1 = streams["port"]
    for name, ref in streams["jax"].items():
        got = rank0["requests"][name]
        assert got["canonical_total"] == ref["canonical_total"], name
        if not ref["bucketed"]:
            continue
        for table in ("dispatch_idx", "undispatch_idx", "position_ids"):
            assert got[table].dtype == ref[table].dtype == np.int32
            assert got[table].tobytes() == ref[table].tobytes(), (name, table)
            assert rank1["requests"][name][table].tobytes() == ref[table].tobytes()
        # each rank's position ids are its slice of the table
        shard = got["local_rows"]
        for r, rank in enumerate(streams["port"]):
            np.testing.assert_array_equal(rank["requests"][name]["local_position_ids"],
                                          ref["position_ids"][r * shard:(r + 1) * shard])


def test_a_bucket_hit_shares_the_canonical_plan(streams):
    """A, B and D run on A's canonical runtime (1664 padded rows); C is B's
    runtime object; E, on the grid, is that canonical runtime's own key."""
    for rank in streams["port"]:
        req = rank["requests"]
        assert {req[n]["canonical_total"] for n in "ABDE"} == {1664}
        assert req["F"]["canonical_total"] == 1792
        assert req["C"]["mgr_id"] == req["B"]["mgr_id"]
        assert all(req[n]["canonical_is_exact_key"] for n in "ABD")


def _within(ref, got, where, grad):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float32)
    if not grad:
        return assert_within_budget(divergence_report(ref, got), BUDGET, where=where)
    assert_within_budget(divergence_report(ref, got), ABS_ONLY, where=where)
    big = np.abs(ref) >= NEAR_ZERO * np.abs(ref).max()
    return assert_within_budget(divergence_report(ref[big], got[big]), BUDGET, where=where)


@pytest.mark.parametrize("name", [n for n, _ in STREAM])
def test_outputs_match_jax(streams, name):
    got, ref = streams["port"][0]["requests"][name], streams["jax"][name]
    assert_within_budget(divergence_report(ref["out"], got["out"], ref_lse=ref["lse"],
                                           test_lse=got["lse"]), BUDGET, where=f"{name}/out")
    for g in ("dq", "dk", "dv"):
        _within(ref[g], got[g], f"{name}/{g}", grad=True)
    for r in streams["port"][1:]:  # every rank holds the same global results
        for n in ("out", "lse", "dq", "dk", "dv"):
            np.testing.assert_array_equal(r["requests"][name][n], got[n])


@pytest.mark.parametrize("name", [n for n, _ in STREAM])
def test_outputs_match_single_device_attention(streams, name):
    """Against the fp64 dense oracle on the request's REAL mask."""
    x = streams["inputs"][name]
    qr, kr, ty = infer_attn_mask_from_cu_seqlens(_cu(dict(STREAM)[name]))
    q, k, v = (torch.from_numpy(x[n]).double().requires_grad_() for n in "qkv")
    out, lse, _ = ref_attn_from_ranges(q, k, v, qr.to_naive_ranges(), kr.to_naive_ranges(),
                                       [int(t) for t in ty])
    loss = (out * torch.from_numpy(x["g_out"]).double()).sum() + torch.where(
        torch.isfinite(lse), lse * torch.from_numpy(x["g_lse"]).double(), 0.0).sum()
    loss.backward()
    got = streams["port"][0]["requests"][name]
    assert_within_budget(divergence_report(out.detach().numpy(), got["out"],
                                           ref_lse=lse.detach().numpy(), test_lse=got["lse"]),
                         BUDGET, where=f"{name}/out")
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        _within(t.grad.numpy(), got[n], f"{name}/{n}", grad=True)


def test_an_exact_hit_is_bitwise_the_first_call(streams):
    req = streams["port"][0]["requests"]
    for n in ("out", "lse", "dq", "dk", "dv"):
        np.testing.assert_array_equal(req["C"][n], req["B"][n])


def test_roll_and_new_mask_keys_refuse_a_bucketed_key(streams):
    for rank in streams["port"]:
        ref = rank["refusals"]
        assert "roll is not supported on a bucketed (plan-reuse) key" in ref["roll"]
        for n in ("new_flex", "new_varlen"):
            assert "not supported on a bucketed (plan-reuse) key" in ref[n], n


def test_clear_cache_per_group_and_whole(streams):
    """The second group's bucketed key (its adapter and canonical runtime,
    one fingerprint) goes with ``clear_cache(other)``, the rest with
    ``clear_cache(group)``; the most recent key goes with its group."""
    for rank in streams["port"]:
        (n_rt, n_fp), after_other, after_all = rank["cache_sizes"]
        assert after_other == (n_rt - 2, n_fp - 1)
        assert after_all == (0, 0)
        assert not rank["most_recent_after_clear"]


def test_one_call_and_low_level_entry_points_resolve_the_same_key(streams):
    """``magi_attn_varlen_dispatch`` / ``magi_attn_flex_dispatch`` return
    request A's key and its dispatched shard; ``init_dist_attn_runtime_mgr``
    (the reference's signature, ``pad_size`` and ``cp_mesh`` ignored) its
    manager object."""
    for rank in streams["port"]:
        assert rank["entry_points"] == {"keys": True, "locals": True, "init_mgr": True}


def test_qo_comm_opts_out_of_reuse(streams):
    for rank in streams["port"]:
        assert rank["qo_opt_out"] == {"tier": "cold", "bucketed": False}


def test_plan_reuse_env_validation(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_REUSE", "aggressive")
    with pytest.raises(ValueError, match="PLAN_REUSE") as port_err:
        env.plan_reuse_mode()
    with pytest.raises(ValueError, match="PLAN_REUSE") as jax_err:
        jax_env.plan_reuse_mode()
    assert str(port_err.value) == str(jax_err.value)
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_REUSE", "bucket")
    assert env.plan_reuse_mode() == "bucket"
    bucket = interface.flags_fingerprint()
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_REUSE", "off")
    assert interface.flags_fingerprint() != bucket  # the mode re-keys
    off = interface.flags_fingerprint()
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_CACHE_SIZE", "7")
    assert interface.flags_fingerprint() == off  # the capacity does not
    assert env.plan_cache_size() == jax_env.plan_cache_size() == 7
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_CACHE_SIZE", "0")
    with pytest.raises(ValueError, match="PLAN_CACHE_SIZE"):
        env.plan_cache_size()
    monkeypatch.delenv("MAGI_ATTENTION_PLAN_CACHE_SIZE")
    monkeypatch.setenv("MAGI_ATTENTION_RUNTIME_DICT_SIZE", "33")
    assert env.plan_cache_size() == jax_env.plan_cache_size() == 33
