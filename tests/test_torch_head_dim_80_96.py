"""head_dim 80 and 96, Phi-2's and Phi-3-mini's attention widths (32 q /
32 kv heads each; Phi-3-mini's 2047-key sliding window), in the port
against the JAX package on the CPU, cut to small sizes: the same numpy
inputs from a seed through both, every check at d 80 and at d 96.

- ``flex_flash_attn_func`` forward and backward on both grids, head_block
  1 and G (2), over causal (a softcap), varlen-causal (a sink) and
  sliding-window (a softcap) masks: the JAX twin in Pallas interpret mode,
  the port on its plain versions. out and lse within the float32 row of
  ``telemetry.numerics.DEFAULT_BUDGETS`` (v positive); gradients within it
  as ``tests/test_torch_flex_attn_bwd.py`` scores them.
- ``paged_decode`` at G 1, 2 and 48, flat and shared mode, against JAX
  ``decode_attn_paged`` / ``decode_partials_for_tables`` in interpret mode,
  within the same float32 row.
- ``ServingEngine`` prefill (one shot and chunked) and decode at 4 / 4
  heads against JAX's engine on its jnp backend, within the float32 row.
- ``MagiLlama`` at ``head_dim=96`` (2 layers, dim 192): loss and every
  first-step gradient against the JAX model on the jnp backend, the weights
  carried across with ``convert.llama_params_from_numpy``, within rtol 2e-4
  / atol 2e-5.
- The card's gates, with the launch recorded instead of run: d 80 and 96 in
  bf16 and float32 are taken by all eight flex kernels and by
  ``paged_decode`` (G 1 to 32, the wide walk at G 48, the shared mode),
  each launch handed tensors of last dimension d (no pad on the host);
  the tuner's tiles and feasibility take both widths, and the roofline and
  the cost model count FLOPs at the true d; every plant that
  ``chip_smoke.py`` builds into the widened walks matches its source once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu import models as jax_models
from magiattention_tpu.api import infer_attn_mask_from_cu_seqlens as jax_mask
from magiattention_tpu.api import infer_attn_mask_from_sliding_window as jax_window
from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.parallel import dispatch
from magiattention_tpu.serving import (
    ServingEngine as JaxEngine,
    assign_block_table as jax_assign,
    decode_attn_paged as jax_decode,
    decode_partials_for_tables as jax_partials,
    make_paged_kv_cache as jax_make_cache,
    write_prefill_kv as jax_write,
)
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch import convert
from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
from magiattention_tpu_torch.api import infer_attn_mask_from_sliding_window as window
from magiattention_tpu_torch.convert import cache_from_numpy
from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.ops import flex_flash_attn_func
from magiattention_tpu_torch.serving import (
    PagedKVCache,
    ServingEngine,
    decode_attn_paged,
)
from magiattention_tpu_torch.serving.decode_attn import _decode_shared_prefix
from magiattention_tpu_torch.telemetry.roofline import analyze_workload
from magiattention_tpu_torch.tuning import cost_model
from tests.test_torch_flex_attn import _launch_recorded
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget
from tests.test_torch_head_dim_256 import FLEX_KERNELS, _decode_recorded
from tests.torch_jax_backend import jax_backend

DS = (80, 96)
SOFTCAP = 30.0
BUDGET = DEFAULT_BUDGETS["float32"]
C = 1


def _slices(mask: str, pkg: str):
    """(total, q ranges, k ranges, types) of a small mask, built by each
    package's own helpers where it has one."""
    if mask == "causal":
        return 128, [(0, 128)], [(0, 128)], [C]
    if mask == "varlen":
        cu = [(0, 50), (50, 100), (100, 136)]
        return 136, cu, cu, [C, C, C]
    # a sliding window of 48 keys on 192 tokens (Phi-3-mini's 2047, cut)
    qr, kr, ts = (jax_window if pkg == "jax" else window)(192, 48)
    return 192, qr.to_naive_ranges(), kr.to_naive_ranges(), [int(t) for t in ts]


# (mask, softcap, sink, grid, head_block): each grid at head_block 1 and G,
# each with a softcap and with a sink, every mask
FLEX_CASES = [("causal", SOFTCAP, None, "row_major", 1),
              ("varlen", 0.0, [0.5, -1.0, 2.0, 0.0], "row_major", 2),
              ("window", SOFTCAP, None, "sparse", 1),
              ("causal", 0.0, [1.0, -2.0, 0.25, 3.0], "sparse", 2)]


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("case", FLEX_CASES, ids=[f"{c[0]}_{c[3]}_hb{c[4]}" for c in FLEX_CASES])
def test_flex_forward_and_backward_match_jax(case, d):
    """Forward and vjp through JAX (Pallas interpret: ``_fwd_pallas`` /
    ``_fwd_pallas_hb`` / ``_fwd_pallas_sparse`` / ``_fwd_pallas_hb_sparse``
    and the dq / dkv kernels) and the port (its plain versions)."""
    mask, softcap, sink, grid, hb = case
    t, qr, kr, ty = _slices(mask, "jax")
    assert (t, qr, kr, ty) == _slices(mask, "port")
    rng = np.random.default_rng(d)
    q = rng.standard_normal((t, 4, d)).astype(np.float32)
    k = rng.standard_normal((t, 2, d)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (t, 2, d)).astype(np.float32)
    dout = rng.standard_normal((t, 4, d)).astype(np.float32)
    dlse = rng.standard_normal((t, 4)).astype(np.float32)
    s = None if sink is None else np.asarray(sink, np.float32)
    kw = dict(block_q=64, block_k=64, head_block=hb, grid=grid, softcap=softcap)

    def jax_fn(q, k, v, s):
        return jax_flex(q, k, v, qr, kr, ty, sink=s, interpret=True, **kw)

    @jax.jit  # one compile for the forward and the vjp, not an eager trace of each
    def jax_fwd_bwd(primals, cotangents):
        outs, vjp = jax.vjp(jax_fn, *primals)
        return outs, vjp(cotangents)

    primals = [jnp.asarray(x) for x in (q, k, v)] + [None if s is None else jnp.asarray(s)]
    (jo, jl), jgrads = jax_fwd_bwd(primals, (jnp.asarray(dout), jnp.asarray(dlse)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ts = None if s is None else torch.from_numpy(s).requires_grad_()
    out, lse = flex_flash_attn_func(*leaves, qr, kr, ty, sink=ts, **kw)
    grads = torch.autograd.grad((out, lse), leaves + ([ts] if ts is not None else []),
                                (torch.from_numpy(dout), torch.from_numpy(dlse)))
    where = f"d{d}/{mask}/{grid}/hb{hb}"
    assert out.shape[-1] == d
    assert_within_budget(divergence_report(np.asarray(jo), out.detach().numpy(),
                                           ref_lse=np.asarray(jl), test_lse=lse.detach().numpy()),
                         BUDGET, where=f"{where}/out")
    assert len(grads) == (4 if sink is not None else 3)
    for what, r, g in zip(("dq", "dk", "dv", "dsink"), jgrads, grads):
        _assert_grad_within_budget(r, g.numpy(), f"{where}/{what}")


# -- paged_decode -------------------------------------------------------------

PS, MPP = 16, 4
LENGTHS = [0, 1, PS, 37, MPP * PS]  # zero, one, a page boundary, ragged, full


def _decode_state(seed, hq, hk, d, lengths=LENGTHS):
    """The same cache in both packages (page 0 unreferenced, v positive)."""
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


def _close(jo, jl, out, lse, budget=BUDGET):
    assert_within_budget(divergence_report(np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl),
                                           test_lse=lse.numpy()), budget)


GROUPS = [(2, 2), (4, 2), (48, 1)]  # (hq, hk): G 1, 2 and 48 (the wide walk's on the card)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("hq,hk", GROUPS, ids=["g1", "g2", "g48"])
def test_flat_decode_matches_jax_pallas_interpret(hq, hk, d):
    """Flat decode at two splits. lse within its absolute bound only: the
    one-token slot's lse is a single logit near 0 (see
    ``tests/test_torch_decode_attn.py``)."""
    jcache, cache, q = _decode_state(hq + d, hq, hk, d)
    slots = np.arange(len(LENGTHS))
    jo, jl = jax_decode(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=2,
                        softcap=SOFTCAP, interpret=True)
    out, lse = decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots),
                                 num_splits=2, softcap=SOFTCAP)
    assert out.shape == (len(LENGTHS), hq, d)
    _close(jo, jl, out, lse, dataclasses.replace(BUDGET, lse_max_ulp=float("inf")))
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("group", [1, 2, 48])
def test_shared_decode_matches_jax_partials_over_broadcast_table(group, d):
    """The cascade's level 1 (the kernel's shared mode): three members' q
    heads over one shared page row with a partial last page, against JAX
    ``decode_partials_for_tables`` in interpret mode on the repeated row."""
    rng = np.random.default_rng(group + d)
    hk, w, members = 1, 4, 3
    num_pages = 3 * w + 1
    k = rng.standard_normal((num_pages, PS, hk, d)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (num_pages, PS, hk, d)).astype(np.float32)
    jcache = jax_make_cache(num_pages, PS, hk, d, max_seqs=1, max_pages_per_seq=w,
                            dtype=jnp.float32)
    jcache = dataclasses.replace(jcache, k_pages=jnp.asarray(k), v_pages=jnp.asarray(v))
    cache = PagedKVCache(torch.from_numpy(k), torch.from_numpy(v),
                         torch.zeros((1, w), dtype=torch.int32),
                         torch.zeros((1,), dtype=torch.int32))
    pages = rng.permutation(np.arange(1, num_pages))[:w].astype(np.int32)
    prefix_len = w * PS - 3
    q = rng.standard_normal((members, group * hk, d)).astype(np.float32)
    jo, jl = jax_partials(jnp.asarray(q), jcache, jnp.asarray(np.tile(pages, (members, 1))),
                          jnp.full((members,), prefix_len, jnp.int32), num_splits=2,
                          interpret=True)
    out, lse = _decode_shared_prefix(torch.from_numpy(q), cache, torch.from_numpy(pages),
                                     prefix_len, num_splits=2)
    _close(jo, jl, out, lse)


# -- the serving engine --------------------------------------------------------

HEADS = 4  # q heads = kv heads, as Phi's 32 / 32


CHUNK_TOKENS = 16  # the 30-token prompt is prefilled in two chunks, the 9-token one at once


@pytest.mark.parametrize("d", DS)
def test_engines_agree(d, monkeypatch):
    """Two prompts (30 tokens prefilled in chunks of 16, 9 tokens in one
    shot) and two decode steps through both engines at 4 / 4 heads of d:
    every prefill and decode (out, lse) within the float32 row, the block
    tables and lengths byte-identical."""
    chunk = CHUNK_TOKENS
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "2")
    kw = dict(num_pages=32, num_kv_heads=HEADS, head_dim=d, page_size=PS, max_seqs=4,
              max_pages_per_seq=8)
    jeng = JaxEngine(dtype=jnp.float32, **kw)
    eng = ServingEngine(dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(d)

    def rand(*shape, positive=False):
        if positive:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    prompts, slots = [30, 9], []
    for t in prompts:
        ja, a = jeng.admit(t), eng.admit(t)
        assert (ja.admitted, ja.slot) == (a.admitted, a.slot)
        slots.append(a.slot)
    for slot, t in zip(slots, prompts):
        q, k, v = rand(t, HEADS, d), rand(t, HEADS, d), rand(t, HEADS, d, positive=True)
        if t > chunk:
            monkeypatch.setenv("MAGI_ATTENTION_PREFILL_CHUNK", str(chunk))
        jo, jl = jeng.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slot)
        o, l = eng.prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), slot)
        monkeypatch.delenv("MAGI_ATTENTION_PREFILL_CHUNK", raising=False)
        _close(jo, jl, o, l)
    for _ in range(2):
        q = rand(len(slots), HEADS, d)
        k, v = rand(len(slots), HEADS, d), rand(len(slots), HEADS, d, positive=True)
        jo, jl = jeng.decode_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slots)
        o, l = eng.decode_step(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               slots)
        _close(jo, jl, o, l)
    got = convert.cache_to_numpy(eng.cache)
    for name in ("block_tables", "seq_lens"):
        assert np.asarray(getattr(jeng.cache, name)).tobytes() == got[name].tobytes(), name
    assert [eng.length(s) for s in slots] == [t + 2 for t in prompts]


# -- the trainer ----------------------------------------------------------------

TOTAL, CHUNK, BATCH = 128, 16, 2
CU = [0, 48, TOTAL]
FIELDS = dict(vocab_size=64, dim=192, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=96,
              ffn_hidden=128, dtype="float32")
RTOL, ATOL = 2e-4, 2e-5


def _tokens():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, FIELDS["vocab_size"], (BATCH, TOTAL)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_llama():
    """The JAX Llama at head_dim 96 (dp = cp = 1, jnp backend): float32
    params, loss and grads."""
    with pytest.MonkeyPatch.context() as mp:
        jax_backend(mp)
        cfg = jax_models.LlamaConfig(**FIELDS)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "cp"))
        qr, kr, ts = jax_mask(CU)
        model, meta = jax_models.build_magi_llama(
            cfg, mesh, TOTAL, qr, kr, ts, chunk_size=CHUNK, block_q=64, block_k=64)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jax_models.init_params(jax.random.PRNGKey(0), cfg))
        tokens_g, labels_g = _tokens()
        tokens = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(tokens_g))
        labels = jax.vmap(lambda x: dispatch(x, meta))(jnp.asarray(labels_g))
        pos = jnp.broadcast_to(jnp.asarray(meta.perm_idx), (BATCH, TOTAL))
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
            params, tokens, labels, pos, model.sharded_tables())
        out = jax.tree.map(np.array, {"params": params, "grads": grads})
        return {**out, "loss": float(loss)}


def _leaves(tree):
    yield "embed", tree["embed"]
    for i, layer in enumerate(tree["layers"]):
        for name in sorted(layer):
            yield f"layers[{i}].{name}", layer[name]
    yield "final_norm", tree["final_norm"]
    yield "lm_head", tree["lm_head"]


def test_llama_at_head_dim_96_matches_jax(jax_llama):
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    model = build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts,
                             params=convert.llama_params_from_numpy(jax_llama["params"]),
                             device="cpu")
    assert model.cfg.head_dim == 96 and model.head_block == 1
    tokens, labels = (torch.from_numpy(a).long() for a in _tokens())
    loss = model.loss(tokens, labels, torch.arange(TOTAL).expand(BATCH, TOTAL))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jax_llama["loss"], rtol=RTOL, atol=ATOL)
    grads = dict(_leaves(convert.llama_params_to_numpy(model, grad=True)))
    ref = dict(_leaves(jax_llama["grads"]))
    assert grads.keys() == ref.keys()
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL, err_msg=name)


# -- the card's gates, launches recorded ------------------------------------------


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel", FLEX_KERNELS)
def test_every_flex_kernel_takes_head_dims_80_and_96(kernel, dtype, d, monkeypatch):
    """The launch goes to the kernel with head_dim d among its sizes and
    the walk the dtype picks (``in_f32`` last but the stream), and the
    tensors behind its pointers are as wide as d: no pad on the host."""
    seen = {}
    real_ptr = torch.Tensor.data_ptr

    def data_ptr(x):
        p = real_ptr(x)
        seen[p] = tuple(x.shape)
        return p

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    calls = _launch_recorded(kernel, d, dtype, monkeypatch)
    assert [name for name, _ in calls] == [kernel]
    args = calls[0][1]
    assert d in args and args[-2] == int(dtype == torch.float32)
    widths = {seen[a][-1] for a in args[:4] if a in seen}  # q, k, v and the sink or dout
    assert d in widths and 128 not in widths and all(w in (d, 4) for w in widths), widths


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("shared", [False, True], ids=["flat", "shared"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hq,hk", [(32, 32), (4, 2), (64, 2), (48, 1)],
                         ids=["phi_mha", "g2", "g32", "g48_wide"])
def test_paged_decode_takes_head_dims_80_and_96(hq, hk, dtype, shared, d, monkeypatch):
    """Every group, flat (G 48: the wide walk in bf16, the CUDA-core WIDE
    mode in float32) and shared, at both dtypes: one launch at head_dim d
    of q [b, hq, d] and the cache's own [pages, page, hk, d] pages."""
    calls, out, lse = _decode_recorded(monkeypatch, hq, hk, d=d, dtype=dtype, shared=shared)
    [(name, a)] = calls
    ints = [x for x in a if type(x) is int][7:]  # past the seven pointers before the sizes
    assert name == "paged_decode" and ints[:4] == [3, hq, hk, d]
    assert ints[8] == int(dtype == torch.float32)
    assert out.shape == (3, 1, hq, d) and lse.shape == (3, 1, hq)


@pytest.mark.parametrize("d", DS)
def test_tuner_takes_the_widths_and_counts_flops_at_the_true_d(d):
    """The cost model's tiles and feasibility take d 80 / 96 at 64 x 64 (and
    nothing else), and its MMA time and the roofline's FLOPs scale with the
    true d, not with d 128's shared tile."""
    assert fa.HOPPER_TILES[d] == (64, 64) and fa.resolve_tile(d, None, None) == (64, 64)
    assert d in fa.KERNEL_F32_HEAD_DIMS
    assert cost_model.candidate_tiles(d) == [(64, 64)]
    assert cost_model.launch_feasible(4096, 4096, 32, 32, d, 64, 64, 1, "row_major")
    assert cost_model.launch_feasible(4096, 4096, 32, 32, d, 64, 64, 2, "sparse")
    assert not cost_model.launch_feasible(4096, 4096, 32, 32, d, 128, 64, 1, "row_major")
    assert cost_model.mma_seconds(d, 32, 100, 64, 64) == pytest.approx(
        cost_model.mma_seconds(128, 32, 100, 64, 64) * d / 128)
    rep = analyze_workload([(0, 1024)], [(0, 1024)], [C], num_heads_q=32, num_heads_kv=32,
                           head_dim=d, block_q=64, block_k=64, card="NVIDIA H100 80GB HBM3")
    assert rep.mask_flops == 4.0 * rep.mask_area * 32 * d


def test_plants_of_the_widened_walks_match_their_sources_once():
    """Each fault ``chip_smoke.py`` plants into the walks widened to d 80
    and 96 (a k slice short, d - 16 columns stored, a row's tail read from
    the next row) is found once in the source it mutates."""
    import os

    import chip_smoke

    csrc_dir = os.path.join(os.path.dirname(fa.__file__), "..", "csrc")
    for name in ("flex_fwd_d80_96_short_k", "flex_dkv_d80_96_short_store",
                 "paged_decode_d80_96_next_row"):
        _source, mutated, plants = chip_smoke.PLANTED[name]
        text = open(os.path.join(csrc_dir, mutated)).read()
        for old, new in plants:
            assert text.count(old) == 1 and old != new, name
