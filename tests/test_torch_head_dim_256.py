"""head_dim 256, Gemma-2-9B's attention width (16 q / 8 kv heads of d 256,
logit softcap 50, a 4096-token sliding window), in the port against the JAX
package on the CPU, cut to small sizes: the same numpy inputs from a seed
through both.

- ``flex_flash_attn_func`` forward and backward on both grids, head_block
  1 and G (2), on causal, varlen-causal and sliding-window masks, with a
  softcap of 50 and a sink: the JAX twin in Pallas interpret mode (the
  paths that reach ``_fwd_pallas`` / ``_fwd_pallas_hb`` /
  ``_fwd_pallas_sparse`` / ``_fwd_pallas_hb_sparse`` and the dq / dkv
  kernels), the port on its plain versions. out and lse within the float32
  row of ``telemetry.numerics.DEFAULT_BUDGETS`` (v positive, as the other
  flex tests); gradients within it as ``tests/test_torch_flex_attn_bwd.py``
  scores them.
- ``paged_decode`` at G 2 and 32, flat and shared mode, against JAX
  ``decode_attn_paged`` / ``decode_partials_for_tables`` in interpret mode,
  within the same float32 row.
- ``ServingEngine`` prefill (one shot and chunked) and decode at 4 / 2
  heads against JAX's engine on its jnp backend, within the float32 row.
- ``MagiLlama`` at ``head_dim=256`` (2 layers, dim 64): loss and every
  first-step gradient against the JAX model on the jnp backend, the weights
  carried across with ``convert.llama_params_from_numpy``, within rtol 2e-4
  / atol 2e-5 (the JAX package's own layouts' bound).
- The card's gates, with the launch recorded instead of run: d 256 in bf16
  is taken by all eight flex kernels and by ``paged_decode`` (G up to 32
  flat, any G shared); float32 at d 256, a flat group past 32 at d 256 and
  head dims outside the build (72, 112) raise, naming their ROADMAP item."""

import dataclasses
import types

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
    make_paged_kv_cache,
)
from magiattention_tpu_torch.serving import decode_attn as da
from magiattention_tpu_torch.serving.decode_attn import _decode_shared_prefix
from tests.test_torch_flex_attn import _launch_recorded
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget
from tests.torch_jax_backend import jax_backend

D = 256
SOFTCAP = 50.0  # Gemma 2's attn_logit_softcapping
BUDGET = DEFAULT_BUDGETS["float32"]
C = 1
FLEX_KERNELS = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv", "flex_fwd_sparse",
                "flex_fwd_sparse_hb", "flex_dq_sparse", "flex_dkv_sparse")


def _slices(mask: str, pkg: str):
    """(total, q ranges, k ranges, types) of a small mask, built by each
    package's own helpers where it has one."""
    if mask == "causal":
        return 192, [(0, 192)], [(0, 192)], [C]
    if mask == "varlen":
        cu = [(0, 70), (70, 150), (150, 200)]
        return 200, cu, cu, [C, C, C]
    # a sliding window of 64 keys on 256 tokens (Gemma 2's local layers, cut)
    qr, kr, ts = (jax_window if pkg == "jax" else window)(256, 64)
    return 256, qr.to_naive_ranges(), kr.to_naive_ranges(), [int(t) for t in ts]


def _flex_inputs(seed, t, hq=4, hk=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t, hq, D)).astype(np.float32)
    k = rng.standard_normal((t, hk, D)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (t, hk, D)).astype(np.float32)
    dout = rng.standard_normal((t, hq, D)).astype(np.float32)
    dlse = rng.standard_normal((t, hq)).astype(np.float32)
    return q, k, v, dout, dlse


# (mask, softcap, sink): Gemma's softcap on the window, a sink on varlen
FLEX_CASES = [("causal", SOFTCAP, None), ("varlen", 0.0, [0.5, -1.0, 2.0, 0.0]),
              ("window", SOFTCAP, None)]
VARIANTS = [("row_major", 1), ("row_major", 2), ("sparse", 1), ("sparse", 2)]


def _flex_both(mask, softcap, sink, grid, hb, seed=7):
    """Forward and vjp through JAX (Pallas interpret) and the port (plain
    versions): ((jax out, lse), jax grads, (out, lse), grads)."""
    t, qr, kr, ty = _slices(mask, "jax")
    pt, pqr, pkr, pty = _slices(mask, "port")
    assert (t, qr, kr, ty) == (pt, pqr, pkr, pty)
    q, k, v, dout, dlse = _flex_inputs(seed, t)
    s = None if sink is None else np.asarray(sink, np.float32)
    kw = dict(block_q=64, block_k=64, head_block=hb, grid=grid, softcap=softcap)

    def jax_fn(q, k, v, s):
        return jax_flex(q, k, v, qr, kr, ty, sink=s, interpret=True, **kw)

    primals = [jnp.asarray(x) for x in (q, k, v)] + [None if s is None else jnp.asarray(s)]
    (jo, jl), vjp = jax.vjp(jax_fn, *primals)
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ts = None if s is None else torch.from_numpy(s).requires_grad_()
    out, lse = flex_flash_attn_func(*leaves, qr, kr, ty, sink=ts, **kw)
    grads = torch.autograd.grad((out, lse), leaves + ([ts] if ts is not None else []),
                                (torch.from_numpy(dout), torch.from_numpy(dlse)))
    return (jo, jl), jgrads, (out.detach(), lse.detach()), grads


@pytest.mark.parametrize("grid,hb", VARIANTS, ids=[f"{g}_hb{h}" for g, h in VARIANTS])
@pytest.mark.parametrize("case", FLEX_CASES, ids=[c[0] for c in FLEX_CASES])
def test_flex_forward_and_backward_match_jax(case, grid, hb):
    mask, softcap, sink = case
    (jo, jl), jgrads, (out, lse), grads = _flex_both(mask, softcap, sink, grid, hb)
    assert out.shape[-1] == D
    assert_within_budget(divergence_report(np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl),
                                           test_lse=lse.numpy()), BUDGET,
                         where=f"{mask}/{grid}/hb{hb}/out")
    assert len(grads) == (4 if sink is not None else 3)
    for what, r, g in zip(("dq", "dk", "dv", "dsink"), jgrads, grads):
        _assert_grad_within_budget(r, g.numpy(), f"{mask}/{grid}/hb{hb}/{what}")


# -- paged_decode -------------------------------------------------------------

PS, MPP = 16, 4
LENGTHS = [0, 1, PS, 37, MPP * PS]  # zero, one, a page boundary, ragged, full


def _decode_state(seed, hq, hk, lengths=LENGTHS):
    """The same cache in both packages (page 0 unreferenced, v positive)."""
    rng = np.random.default_rng(seed)
    cache = jax_make_cache(len(lengths) * MPP + 1, PS, hk, D, max_seqs=len(lengths),
                           max_pages_per_seq=MPP, dtype=jnp.float32)
    for slot, t in enumerate(lengths):
        cache = jax_assign(cache, slot, list(range(1 + slot * MPP, 1 + (slot + 1) * MPP)))
        k = rng.standard_normal((t, hk, D)).astype(np.float32)
        v = rng.uniform(0.5, 1.5, (t, hk, D)).astype(np.float32)
        cache = jax_write(cache, slot, jnp.asarray(k), jnp.asarray(v))
    port = cache_from_numpy(*(np.asarray(x) for x in (
        cache.k_pages, cache.v_pages, cache.block_tables, cache.seq_lens)))
    q = rng.standard_normal((len(lengths), hq, D)).astype(np.float32)
    return cache, port, q


def _close(jo, jl, out, lse, budget=BUDGET):
    assert_within_budget(divergence_report(np.asarray(jo), out.numpy(), ref_lse=np.asarray(jl),
                                           test_lse=lse.numpy()), budget)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("hq,hk", [(4, 2), (64, 2)], ids=["g2", "g32"])
def test_flat_decode_matches_jax_pallas_interpret(hq, hk, splits):
    """Flat decode at G 2 (Gemma-2-9B's 16 / 8) and G 32 (the most one walk
    takes at d 256), softcap 50. lse within its absolute bound only: the
    one-token slot's lse is a single logit near 0 (see
    ``tests/test_torch_decode_attn.py``)."""
    jcache, cache, q = _decode_state(hq + splits, hq, hk)
    slots = np.arange(len(LENGTHS))
    jo, jl = jax_decode(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=splits,
                        softcap=SOFTCAP, interpret=True)
    out, lse = decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots),
                                 num_splits=splits, softcap=SOFTCAP)
    _close(jo, jl, out, lse, dataclasses.replace(BUDGET, lse_max_ulp=float("inf")))
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("group", [2, 32])
def test_shared_decode_matches_jax_partials_over_broadcast_table(group):
    """The cascade's level 1 (the kernel's shared mode): three members' q
    heads over one shared page row with a partial last page, against JAX
    ``decode_partials_for_tables`` in interpret mode on the repeated row."""
    rng = np.random.default_rng(group)
    hk, w, members = 2, 4, 3
    num_pages = 3 * w + 1
    k = rng.standard_normal((num_pages, PS, hk, D)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (num_pages, PS, hk, D)).astype(np.float32)
    jcache = jax_make_cache(num_pages, PS, hk, D, max_seqs=1, max_pages_per_seq=w,
                            dtype=jnp.float32)
    jcache = dataclasses.replace(jcache, k_pages=jnp.asarray(k), v_pages=jnp.asarray(v))
    cache = PagedKVCache(torch.from_numpy(k), torch.from_numpy(v),
                         torch.zeros((1, w), dtype=torch.int32),
                         torch.zeros((1,), dtype=torch.int32))
    pages = rng.permutation(np.arange(1, num_pages))[:w].astype(np.int32)
    prefix_len = w * PS - 3
    q = rng.standard_normal((members, group * hk, D)).astype(np.float32)
    jo, jl = jax_partials(jnp.asarray(q), jcache, jnp.asarray(np.tile(pages, (members, 1))),
                          jnp.full((members,), prefix_len, jnp.int32), num_splits=2,
                          softcap=SOFTCAP, interpret=True)
    out, lse = _decode_shared_prefix(torch.from_numpy(q), cache, torch.from_numpy(pages),
                                     prefix_len, num_splits=2, softcap=SOFTCAP)
    _close(jo, jl, out, lse)


# -- the serving engine --------------------------------------------------------

HQ, HK = 4, 2


@pytest.mark.parametrize("chunk", [None, 16], ids=["one_shot", "chunked"])
def test_engines_agree_at_head_dim_256(chunk, monkeypatch):
    """Three prompts (one past the chunk, prefilled in chunks when set) and
    four decode steps through both engines at 4 / 2 heads of d 256 with
    Gemma's softcap: every prefill and decode (out, lse) within the float32
    row, the block tables and lengths byte-identical."""
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "2")
    kw = dict(num_pages=32, num_kv_heads=HK, head_dim=D, page_size=PS, max_seqs=4,
              max_pages_per_seq=8)
    jeng = JaxEngine(dtype=jnp.float32, **kw)
    eng = ServingEngine(dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(5)

    def rand(*shape, positive=False):
        if positive:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    prompts, slots = [30, 9, 50], []
    for t in prompts:
        ja, a = jeng.admit(t), eng.admit(t)
        assert (ja.admitted, ja.slot) == (a.admitted, a.slot)
        slots.append(a.slot)
    for slot, t in zip(slots, prompts):
        q, k, v = rand(t, HQ, D), rand(t, HK, D), rand(t, HK, D, positive=True)
        if chunk is not None and t > chunk:
            monkeypatch.setenv("MAGI_ATTENTION_PREFILL_CHUNK", str(chunk))
        jo, jl = jeng.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slot,
                              softcap=SOFTCAP)
        o, l = eng.prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), slot,
                           softcap=SOFTCAP)
        monkeypatch.delenv("MAGI_ATTENTION_PREFILL_CHUNK", raising=False)
        _close(jo, jl, o, l)
    for _ in range(4):
        q = rand(len(slots), HQ, D)
        k, v = rand(len(slots), HK, D), rand(len(slots), HK, D, positive=True)
        jo, jl = jeng.decode_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slots,
                                  softcap=SOFTCAP)
        o, l = eng.decode_step(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               slots, softcap=SOFTCAP)
        _close(jo, jl, o, l)
    got = convert.cache_to_numpy(eng.cache)
    for name in ("block_tables", "seq_lens"):
        assert np.asarray(getattr(jeng.cache, name)).tobytes() == got[name].tobytes(), name
    assert [eng.length(s) for s in slots] == [t + 4 for t in prompts]


# -- the trainer ----------------------------------------------------------------

TOTAL, CHUNK, BATCH = 128, 16, 2
CU = [0, 48, TOTAL]
FIELDS = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=D,
              ffn_hidden=96, dtype="float32")
RTOL, ATOL = 2e-4, 2e-5


def _tokens():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, FIELDS["vocab_size"], (BATCH, TOTAL)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def jax_llama():
    """The JAX Llama at head_dim 256 (dp = cp = 1, jnp backend): float32
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


def test_llama_at_head_dim_256_matches_jax(jax_llama):
    qr, kr, ts = infer_attn_mask_from_cu_seqlens(CU)
    model = build_magi_llama(LlamaConfig(**FIELDS), TOTAL, qr, kr, ts,
                             params=convert.llama_params_from_numpy(jax_llama["params"]),
                             device="cpu")
    assert model.cfg.head_dim == D and model.head_block == 2
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


@pytest.mark.parametrize("kernel", FLEX_KERNELS)
def test_every_flex_kernel_takes_bf16_at_head_dim_256(kernel, monkeypatch):
    calls = _launch_recorded(kernel, D, torch.bfloat16, monkeypatch)
    assert [name for name, _ in calls] == [kernel]
    args = calls[0][1]
    assert D in args and args[-2] == 0  # the head dim the entry switches on; the wgmma walk


@pytest.mark.parametrize("kernel", FLEX_KERNELS)
def test_flex_kernels_refuse_float32_at_head_dim_256(kernel, monkeypatch):
    with pytest.raises(TypeError, match="ROADMAP.md B.10"):
        _launch_recorded(kernel, D, torch.float32, monkeypatch)


# head dims the kernels are not built for (ROADMAP.md B.13), beside the
# built 64 / 80 / 96 / 128. The two tests below keep the names they had when
# head_dim 96 was the width outside the build.
UNBUILT_HEAD_DIMS = (72, 112)


@pytest.mark.parametrize("kernel", FLEX_KERNELS)
def test_flex_kernels_refuse_head_dim_96(kernel, monkeypatch):
    for d in UNBUILT_HEAD_DIMS:
        with pytest.raises(ValueError, match="ROADMAP.md B.13"):
            _launch_recorded(kernel, d, torch.bfloat16, monkeypatch)


def _decode_recorded(monkeypatch, hq, hk, d=D, dtype=torch.bfloat16, shared=False, b=3):
    """``_decode_partials_kernel`` on CPU tensors with the launch recorded:
    (calls, out, lse)."""
    cache = make_paged_kv_cache(9, 16, hk, d, max_seqs=4, max_pages_per_seq=2, dtype=dtype,
                                device="cpu")
    rows = 1 if shared else b
    bt = torch.zeros((rows, 2), dtype=torch.int32)
    sl = torch.full((rows,), 20, dtype=torch.int32)
    calls = []
    monkeypatch.setattr(da.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    prm = da.DecodeParams(d ** -0.5, SOFTCAP, 1, torch.float32)
    out, lse = da._decode_partials_kernel(torch.zeros((b, hq, d), dtype=dtype), cache, bt, sl,
                                          prm, shared=shared)
    return calls, out, lse


@pytest.mark.parametrize("shared", [False, True], ids=["flat", "shared"])
@pytest.mark.parametrize("hq,hk", [(16, 8), (64, 2)], ids=["gemma2_9b", "g32"])
def test_paged_decode_takes_bf16_at_head_dim_256(hq, hk, shared, monkeypatch):
    calls, out, lse = _decode_recorded(monkeypatch, hq, hk, shared=shared)
    [(name, a)] = calls
    ints = [x for x in a if type(x) is int][7:]  # past the seven pointers before the sizes
    assert name == "paged_decode" and ints[:4] == [3, hq, hk, D]
    assert ints[8] == 0  # is_f32: the tensor-core walk
    assert out.shape == (3, 1, hq, D) and lse.shape == (3, 1, hq)


def test_paged_decode_refuses_float32_at_head_dim_256(monkeypatch):
    with pytest.raises(TypeError, match="ROADMAP.md B.10"):
        _decode_recorded(monkeypatch, 16, 8, dtype=torch.float32)


def test_paged_decode_refuses_the_wide_walk_at_head_dim_256(monkeypatch):
    """G 33 in the flat mode is the wide walk's, not built at d 256; the
    shared mode takes it (16 rows a walk)."""
    with pytest.raises(ValueError, match="ROADMAP.md B.11"):
        _decode_recorded(monkeypatch, 33, 1)
    calls, _, _ = _decode_recorded(monkeypatch, 33, 1, shared=True)
    assert [name for name, _ in calls] == ["paged_decode"]


def test_paged_decode_refuses_head_dim_96(monkeypatch):
    for d in UNBUILT_HEAD_DIMS:
        with pytest.raises(ValueError, match="ROADMAP.md B.13"):
            _decode_recorded(monkeypatch, 16, 8, d=d)


@pytest.mark.parametrize("group,shared,per", [(2, False, 65535), (32, False, 32767),
                                              (24, False, 32767), (32, True, 32767),
                                              (2, True, 524280)])
def test_row_blocks_count_d256_row_groups(group, shared, per):
    """At d 256 a walk holds 16 rows: a flat group past 16 takes a row
    group per 16 rows, the shared mode 16 rows a row group; the launches
    split a batch past the grid's 65,535 row groups accordingly."""
    assert da.kernel_row_groups(group, torch.bfloat16, D) == -(-group // 16)
    b = per + 1
    blocks = da.kernel_row_blocks(b, group, torch.bfloat16, shared, head_dim=D)
    assert blocks == [(0, per), (per, b)]
    assert da.kernel_row_blocks(per, group, torch.bfloat16, shared, head_dim=D) == [(0, per)]


def test_tile_table_and_resolve_at_head_dim_256():
    """d 256 keeps the 64 x 64 tile, so the host tables are JAX's at that
    tile (the tests above pin it on both sides)."""
    assert fa.HOPPER_TILES[D] == (64, 64)
    assert fa.resolve_tile(D, None, None) == (64, 64)


@pytest.mark.parametrize("d,group,row_groups", [(256, 2, 1), (256, 24, 2), (256, 32, 2),
                                                (128, 24, 1), (128, 32, 1)])
def test_split_tuner_prices_the_d256_row_tiles(d, group, row_groups, monkeypatch):
    """The split tuner prices a launch by its walks: at d 256 a flat group
    past 16 q heads runs one walk per 16-row tile, as the launch does
    (``kernel_row_groups``), and at d 128 one walk a group."""
    from magiattention_tpu_torch.tuning import autotuner

    walks = []
    real = autotuner._decode_blocks

    def spy(n, split_tokens, sms):
        walks.append(n)
        return real(n, split_tokens, sms)

    monkeypatch.setattr(autotuner, "_decode_blocks", spy)
    rows, width, hk = 3, 8, 2
    scored = autotuner._price_splits(rows, width, 128, hk, d, "bfloat16", 132, group)
    splits = sorted(s for _, s in scored)
    assert splits == [1, 2, 4, 8]
    assert sorted(walks) == [hk * s * rows * row_groups for s in splits]
