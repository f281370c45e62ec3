"""The C entry points of the port's CUDA kernels against the ctypes
signatures ``csrc.KERNELS`` declares for them.

The sources compile only on the machine with the card, and a wrong
``argtypes`` list shows there only as a wrong result or a fault. This test
reads each ``csrc/*.cu``'s ``extern "C"`` entry point as text and checks
its parameters one by one: a pointer (``void*``, the stream too) is
``c_void_p``, an ``int`` is ``c_int``, a ``float`` is ``c_float``."""

import ctypes
import os
import re

import pytest

from magiattention_tpu_torch import csrc

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}


def _param_kind(decl: str) -> str:
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    words = decl.replace("const ", "").split()
    return {"int": "int", "float": "float"}.get(words[0], f"unknown: {decl}")


def _entry_params(source: str, entry: str) -> list[str]:
    with open(os.path.join(csrc._DIR, source)) as f:
        text = f.read()
    extern = text[text.index('extern "C"'):]
    m = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)\s*\{{", extern)
    assert m, f"{source} has no extern \"C\" definition of {entry}"
    return [_param_kind(p) for p in m.group(1).split(",")]


def test_every_source_is_a_kernel():
    sources = sorted(f for f in os.listdir(csrc._DIR) if f.endswith(".cu"))
    assert sources == sorted(k.source for k in csrc.KERNELS.values())


@pytest.mark.parametrize("name", sorted(csrc.KERNELS))
def test_entry_point_matches_argtypes(name):
    kernel = csrc.KERNELS[name]
    declared = [KINDS[t] for t in kernel.argtypes]
    assert _entry_params(kernel.source, kernel.entry) == declared


@pytest.mark.parametrize("name", sorted(csrc.KERNELS))
def test_headers_are_the_ones_included(name):
    """The library hash covers every header of this directory that the
    source reaches: a header edit rebuilds the kernel."""
    def includes(path):
        with open(os.path.join(csrc._DIR, path)) as f:
            found = re.findall(r'#include "([^"]+)"', f.read())
        return {h for h in found if os.path.exists(os.path.join(csrc._DIR, h))}

    kernel = csrc.KERNELS[name]
    reached, todo = set(), [kernel.source]
    while todo:
        for h in includes(todo.pop()) - reached:
            reached.add(h)
            todo.append(h)
    assert reached == set(kernel.headers)


def _sparse_backward_problem(hq, hk, d=64, t=640):
    """CPU tensors of a sparse backward call at ``hq``/``hk`` heads on a
    varlen mask, with its tables and work lists."""
    import torch

    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.testing import workloads

    qr, kr, ty = workloads.split_slices(workloads.varlen_block_causal(t, 4, 3))
    meta = fa.build_block_meta(qr, kr, ty, t, t, block_q=64, block_k=64)
    tqp, tkp = meta.num_q_blocks * 64, meta.num_k_blocks * 64
    q, do = (torch.zeros((hq, tqp, d), dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.zeros((hk, tkp, d), dtype=torch.bfloat16) for _ in range(2))
    lse, delta = torch.zeros((hq, tqp)), torch.zeros((hq, tqp))
    params = fa.FlexAttnParams(64, 64, d ** -0.5, 0.0, False, torch.bfloat16, hq // hk, "sparse")
    work = fa.sparse_work(meta, "cpu", hq, hk, hq // hk)
    return fa, (q, k, v, do, lse, delta), fa.fwd_tables(meta, "cpu"), fa.bwd_tables(meta, "cpu"), \
        work, params


@pytest.mark.parametrize("hq,hk", [(4, 4), (8, 4), (6, 2), (8, 2), (16, 2)],
                         ids=["g1", "g2", "g3", "g4", "g8"])
def test_sparse_backward_launchers_pass_what_the_entry_points_take(hq, hk, monkeypatch):
    """``_dq_sparse_kernel`` and ``_dkv_sparse_kernel`` with the launch
    recorded instead of run: as many arguments as the entry point's
    argtypes, each of the kind declared, and the item count the entry point
    accepts (dq: hq / 2 * nq at even G, its items head pairs, else hq * nq;
    dkv: hk * nk)."""
    import types

    import torch

    fa, args, ftab, btab, work, params = _sparse_backward_problem(hq, hk)
    calls = []
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    fa._dq_sparse_kernel(*args, ftab, work, params)
    fa._dkv_sparse_kernel(*args, btab, work, params)
    python_kind = {"pointer": int, "int": int, "float": float}
    nq, nk = args[0].shape[1] // 64, args[1].shape[1] // 64
    want_items = {"flex_dq_sparse": (hq // 2 if (hq // hk) % 2 == 0 else hq) * nq,
                  "flex_dkv_sparse": hk * nk}
    assert [name for name, _ in calls] == ["flex_dq_sparse", "flex_dkv_sparse"]
    for name, a in calls:
        kinds = [KINDS[t] for t in csrc.KERNELS[name].argtypes]
        assert len(a) == len(kinds)
        assert all(type(x) is python_kind[kind] for x, kind in zip(a, kinds))
        n_items = a[kinds.index("int") + 8]  # hq hk tqp tkp head_dim n block_q block_k n_items
        assert n_items == want_items[name] == (work.dq if name == "flex_dq_sparse"
                                               else work.dkv).numel()


@pytest.mark.parametrize("what", ["q", "k", "v", "dout", "lse", "delta"])
def test_sparse_backward_launchers_refuse_what_tma_cannot_load(what, monkeypatch):
    """A base that is not 16-byte aligned (an offset view) raises before any
    launch: q, k, v and dout load through TMA tensor maps in both kernels,
    lse and delta through bulk copies in the dk/dv walk."""
    import torch

    fa, args, ftab, btab, work, params = _sparse_backward_problem(8, 2)
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: pytest.fail(f"{name} launched"))
    index = ["q", "k", "v", "dout", "lse", "delta"].index(what)
    x = args[index]
    shifted = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    args = (*args[:index], shifted, *args[index + 1:])
    if what in ("q", "k", "v", "dout"):
        with pytest.raises(ValueError, match=f"flex_dq_sparse: {what} at .* not 16-byte aligned"):
            fa._dq_sparse_kernel(*args, ftab, work, params)
    with pytest.raises(ValueError, match=f"flex_dkv_sparse: {what} at .* not 16-byte aligned"):
        fa._dkv_sparse_kernel(*args, btab, work, params)


@pytest.mark.parametrize("hq,hk", [(4, 4), (8, 4), (6, 2), (8, 2), (16, 2)],
                         ids=["g1", "g2", "g3", "g4", "g8"])
@pytest.mark.parametrize("head_block", ["1", "G"])
def test_sparse_forward_launchers_pass_what_the_entry_points_take(hq, hk, head_block,
                                                                   monkeypatch):
    """``_fwd_sparse_kernel`` (head_block 1) and ``_fwd_sparse_hb_kernel``
    (head_block G) with the launch recorded instead of run: as many
    arguments as the entry point's argtypes, each of the kind declared, and
    the item count and heads per item the entry points accept (one item per
    (group of heads_per_item q heads, q block))."""
    import dataclasses
    import types

    import torch

    fa, args, ftab, _, _, params = _sparse_backward_problem(hq, hk)
    hb = 1 if head_block == "1" else hq // hk
    params = dataclasses.replace(params, head_block=hb)
    meta_work = fa.sparse_work(_plan(hq, hk), "cpu", hq, hk, hb)
    calls = []
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v = args[:3]
    fwd = fa._fwd_sparse_hb_kernel if hb > 1 else fa._fwd_sparse_kernel
    fwd(q, k, v, torch.zeros(hq), ftab, meta_work, params)
    name, a = calls[0]
    assert name == ("flex_fwd_sparse_hb" if hb > 1 else "flex_fwd_sparse")
    kinds = [KINDS[t] for t in csrc.KERNELS[name].argtypes]
    python_kind = {"pointer": int, "int": int, "float": float}
    assert len(a) == len(kinds)
    assert all(type(x) is python_kind[kind] for x, kind in zip(a, kinds))
    first = kinds.index("int")  # hq hk tqp tkp head_dim nq block_q block_k n_items heads_per_item
    n_items, heads_per_item = a[first + 8], a[first + 9]
    assert heads_per_item == hb
    assert n_items == hq // hb * (q.shape[1] // 64) == meta_work.fwd.numel()


def _plan(hq, hk, t=640):
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.testing import workloads

    qr, kr, ty = workloads.split_slices(workloads.varlen_block_causal(t, 4, 3))
    return fa.build_block_meta(qr, kr, ty, t, t, block_q=64, block_k=64)


@pytest.mark.parametrize("what", ["q", "k", "v"])
def test_sparse_forward_launchers_refuse_what_tma_cannot_load(what, monkeypatch):
    """The sparse forwards load q, k and v through TMA tensor maps: a base
    that is not 16-byte aligned raises before any launch, in both."""
    import dataclasses

    import torch

    fa, args, ftab, _, _, params = _sparse_backward_problem(8, 2)
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: pytest.fail(f"{name} launched"))
    qkv = dict(zip("qkv", args[:3]))
    x = qkv[what]
    qkv[what] = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    for hb, name, fwd in ((1, "flex_fwd_sparse", fa._fwd_sparse_kernel),
                          (4, "flex_fwd_sparse_hb", fa._fwd_sparse_hb_kernel)):
        work = fa.sparse_work(_plan(8, 2), "cpu", 8, 2, hb)
        with pytest.raises(ValueError, match=f"{name}: {what} at .* not 16-byte aligned"):
            fwd(qkv["q"], qkv["k"], qkv["v"], torch.zeros(8), ftab, work,
                dataclasses.replace(params, head_block=hb))


def test_sparse_hb_forward_refuses_a_head_block_off_the_group(monkeypatch):
    """``flex_fwd_sparse_hb`` takes a head_block that is a multiple of the
    GQA group dividing hq, as ``_launch_fwd``'s head-batched path checks."""
    import dataclasses

    import torch

    fa, args, ftab, _, _, params = _sparse_backward_problem(8, 2)
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: pytest.fail(f"{name} launched"))
    work = fa.sparse_work(_plan(8, 2), "cpu", 8, 2, 4)
    with pytest.raises(ValueError, match="head_block 2 must be"):
        fa._fwd_sparse_hb_kernel(*args[:3], torch.zeros(8), ftab, work,
                                 dataclasses.replace(params, head_block=2))


_HOST_KINDS = {ctypes.POINTER(ctypes.c_int64): "int64*", ctypes.c_int64: "int64",
               ctypes.c_double: "double"}


@pytest.mark.parametrize("entry", sorted(csrc.HOST_ENTRY_POINTS))
def test_host_entry_point_matches_argtypes(entry):
    """The host planner's library (``entry_table.cpp``, g++): each of its
    four C entry points against the argtypes ``csrc.HOST_ENTRY_POINTS``
    declares (every one returns int64)."""
    with open(csrc.HOST_SOURCE) as f:
        text = f.read()
    extern = text[text.index('extern "C"'):]
    m = re.search(rf"\bint64_t\s+{entry}\s*\(([^)]*)\)\s*\{{", extern)
    assert m, f"entry_table.cpp has no extern \"C\" definition of {entry}"

    def kind(decl):
        decl = decl.strip().replace("const ", "")
        return {"int64_t*": "int64*", "int64_t": "int64", "double": "double"}.get(
            decl.split()[0].rstrip("*") + ("*" if "*" in decl else ""), f"unknown: {decl}")

    got = [kind(p) for p in m.group(1).split(",")]
    assert got == [_HOST_KINDS[t] for t in csrc.HOST_ENTRY_POINTS[entry]]
    assert set(re.findall(r"\bint64_t\s+(magi_\w+)\s*\(", extern)) == set(csrc.HOST_ENTRY_POINTS)


@pytest.mark.parametrize("cluster_heads", [0, 8], ids=["own", "full_pool"])
def test_paged_decode_launcher_passes_what_the_entry_point_takes(cluster_heads, monkeypatch):
    """``_decode_partials_kernel`` with the launch recorded instead of run:
    as many arguments as ``magi_paged_decode``'s argtypes, each of the kind
    declared, and the kv-head count the clusters are sized for after
    ``is_f32``: the cache's own (4 here) by default, the whole pool's for a
    tensor-parallel head slice."""
    import types

    import torch

    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import make_paged_kv_cache

    cache = make_paged_kv_cache(9, 16, 4, 64, max_seqs=2, max_pages_per_seq=4, device="cpu")
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    calls = []
    monkeypatch.setattr(da.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    params = da.DecodeParams(0.125, 0.0, 2, torch.bfloat16, cluster_heads=cluster_heads)
    da._decode_partials_kernel(q, cache, cache.block_tables, cache.seq_lens, params)
    (name, a), = calls
    kinds = [KINDS[t] for t in csrc.KERNELS[name].argtypes]
    python_kind = {"pointer": int, "int": int, "float": float}
    assert name == "paged_decode" and len(a) == len(kinds)
    assert all(type(x) is python_kind[kind] for x, kind in zip(a, kinds))
    ints = a[kinds.index("int"):kinds.index("float")]  # b hq hk d ps mpp splits shared f32 heads
    assert ints == (2, 16, 4, 64, 16, 4, 2, 0, 0, cluster_heads or 4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hq,hk", [(8, 4), (6, 2)], ids=["g2", "g3"])
def test_sparse_launchers_pass_in_f32(dtype, hq, hk, monkeypatch):
    """All four sparse-grid launchers on q/k/v of ``dtype``: the arguments
    their entry points declare, ``in_f32`` (the one before the stream) 1
    for float32 q/k/v and 0 for bf16, the outputs float32 either way."""
    import dataclasses
    import types

    import torch

    fa, args, ftab, btab, work, params = _sparse_backward_problem(hq, hk)
    dt = getattr(torch, dtype)
    args = tuple(x.to(dt) if i < 4 else x for i, x in enumerate(args))
    params = dataclasses.replace(params, out_dtype=dt)
    calls = []
    monkeypatch.setattr(fa.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v = args[:3]
    fwd_work = fa.sparse_work(_plan(hq, hk), "cpu", hq, hk, 1)
    outs = [fa._fwd_sparse_kernel(q, k, v, torch.zeros(hq), ftab, fwd_work,
                                  dataclasses.replace(params, head_block=1))[0],
            fa._fwd_sparse_hb_kernel(q, k, v, torch.zeros(hq), ftab, work, params)[0],
            fa._dq_sparse_kernel(*args, ftab, work, params),
            *fa._dkv_sparse_kernel(*args, btab, work, params)]
    assert [n for n, _ in calls] == ["flex_fwd_sparse", "flex_fwd_sparse_hb", "flex_dq_sparse",
                                     "flex_dkv_sparse"]
    python_kind = {"pointer": int, "int": int, "float": float}
    for name, a in calls:
        kinds = [KINDS[t] for t in csrc.KERNELS[name].argtypes]
        assert len(a) == len(kinds) and all(type(x) is python_kind[kd] for x, kd in zip(a, kinds))
        assert a[-2] == int(dtype == "float32")  # in_f32
    assert [o.dtype for o in outs] == [dt, dt, torch.float32, torch.float32, torch.float32]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("d,hq,hk", [(32, 8, 4), (128, 48, 1), (32, 200, 1)],
                         ids=["d32_g2", "d128_g48", "d32_g200"])
def test_decode_launcher_passes_what_the_entry_point_takes(d, hq, hk, shared, dtype,
                                                           monkeypatch):
    """``_decode_partials_kernel`` at head_dim 32 and at groups past one
    walk's rows (48: StarCoder-15B's layout; 200: a group the wide walks cut
    into row slices), launch recorded: the entry point's arguments, the
    head dim and head counts as given, ``is_f32``, one launch (the batch
    fits the grid's row groups) and no refusal."""
    import types

    import torch

    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import make_paged_kv_cache

    dt = getattr(torch, dtype)
    cache = make_paged_kv_cache(9, 16, hk, d, max_seqs=4, max_pages_per_seq=2, dtype=dt,
                                device="cpu")
    b = 3
    rows = 1 if shared else b
    bt = torch.zeros((rows, 2), dtype=torch.int32)
    sl = torch.full((rows,), 20, dtype=torch.int32)
    calls = []
    monkeypatch.setattr(da.csrc, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    prm = da.DecodeParams(d ** -0.5, 0.0, 1, torch.float32)
    out, lse = da._decode_partials_kernel(torch.zeros((b, hq, d), dtype=dt), cache, bt, sl, prm,
                                          shared=shared)
    [(name, a)] = calls
    kinds = [KINDS[t] for t in csrc.KERNELS[name].argtypes]
    python_kind = {"pointer": int, "int": int, "float": float}
    assert name == "paged_decode" and len(a) == len(kinds)
    assert all(type(x) is python_kind[kd] for x, kd in zip(a, kinds))
    ints = a[kinds.index("int"):kinds.index("float")]
    # b hq hk head_dim page_size mpp num_splits shared is_f32 cluster_heads
    assert list(ints) == [b, hq, hk, d, 16, 2, 1, int(shared), int(dtype == "float32"), hk]
    assert out.shape == (b, 1, hq, d) and lse.shape == (b, 1, hq)
