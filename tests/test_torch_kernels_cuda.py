"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without ``torch.cuda.is_available()`` (the
CPU has no nvcc and no card). On a machine with an H100 run
``python -m pytest tests/test_torch_kernels_cuda.py -q``; ``chip_smoke.py``
holds the same kernels against the same plain versions at their main
paths' widths. bf16 tolerances as in ``chip_smoke.py``: out within 1e-2 + 1e-2 *
|ref| (P and the output are rounded to bf16), lse within 2e-4; dq, dk and
dv against the plain f32 backward (the kernels round P and dS to bf16
before their products): the largest error within 2e-2 max|ref| + 1e-3, the
relative L2 error within 1e-2, and each 64-row (or 64-key) block of each
head within 2e-2 of its own largest entry plus 1e-5 max|ref|, so that the
large first rows and keys of a causal walk cannot hide a wrong tail."""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda

F, C, I, B = 0, 1, 2, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _close(out, ref, lse, ref_lse):
    out, ref = out.float(), ref.float()
    assert ((out - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all()
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    fin = torch.isfinite(ref_lse)
    assert ((lse[fin] - ref_lse[fin]).abs() <= 2e-4).all()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("types", [[C], [F], [I], [B]], ids=["causal", "full", "inv", "bi"])
def test_flex_fwd_matches_plain(card, d, types, group, out_dtype):
    """``flex_fwd`` (a head pair per block at even G, one head with its
    walk split between two consumer warpgroups at G = 1) against the plain
    forward, out in bf16 or float32, and two runs bit for bit."""
    from magiattention_tpu_torch.ops import flex_attn as fa

    tq, tk, hq = 300, 500, 8
    hk = hq // group
    meta = fa.build_block_meta([(0, tq)], [(0, tk)], types, tq, tk, block_q=64, block_k=64)
    tqp, tkp = meta.num_q_blocks * 64, meta.num_k_blocks * 64

    def rand(h, t, tp):
        return fa._pad_tokens(
            torch.randn((h, t, d), generator=card, device="cuda").bfloat16(), tp)

    q, k, v = rand(hq, tq, tqp), rand(hk, tk, tkp), rand(hk, tk, tkp)
    sink = torch.randn((hq,), generator=card, device="cuda")
    params = fa.FlexAttnParams(64, 64, 1.0 / math.sqrt(d), 0.0, True, out_dtype)
    tables = fa.fwd_tables(meta, "cuda:0")
    out, lse, rowmax = fa._fwd_kernel(q, k, v, sink, tables, params)
    assert out.dtype == out_dtype
    ref, ref_lse, ref_rowmax = fa._fwd_torch(q, k, v, sink, tables, params)
    _close(out[:, :tq], ref[:, :tq], lse[:, :tq], ref_lse[:, :tq])
    assert torch.equal(torch.isneginf(rowmax[:, :tq]), torch.isneginf(ref_rowmax[:, :tq]))
    again = fa._fwd_kernel(q, k, v, sink, tables, params)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), again))


@pytest.mark.parametrize("hb_of_group", [1, 2], ids=["hbG", "hb2G"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "case",
    [
        ("causal", [(0, 700)], [(0, 700)], [C], 0.0, False),
        ("varlen_softcap", [(0, 300), (300, 700)], [(0, 300), (300, 700)], [C, C], 30.0, False),
        ("full_inv_bi", [(0, 200), (200, 450), (450, 700)], [(0, 700), (0, 500), (100, 700)],
         [F, I, B], 0.0, False),
        ("uncovered_sink", [(100, 400)], [(0, 350)], [C], 0.0, True),
    ],
    ids=lambda c: c[0],
)
def test_flex_fwd_hb_matches_plain(card, case, d, group, hb_of_group):
    """``flex_fwd_hb`` (head_block G or 2G; 2 at G = 1, an item of two kv
    heads) against the plain forward, twice for the same bits, and bit for
    bit against ``flex_fwd``: a row's walk does not depend on the heads a
    block holds."""
    import dataclasses

    _, qr, kr, ty, softcap, sink = case
    hk = 2
    hq = hk * group
    fa, args, ftab, _, params = _bwd_problem(card, 700, 700, hq, hk, d, qr, kr, ty, softcap, sink)
    q, k, v = args[:3]
    sink_t = torch.randn((hq,), generator=card, device="cuda")
    hb = group * 2 if hb_of_group == 2 or group == 1 else group
    hb_params = dataclasses.replace(params, head_block=hb)
    out, lse, rowmax = fa._fwd_hb_kernel(q, k, v, sink_t, ftab, hb_params)
    ref, ref_lse, ref_rowmax = fa._fwd_torch(q, k, v, sink_t, ftab, params)
    _close(out[:, :700], ref[:, :700], lse[:, :700], ref_lse[:, :700])
    _close(out[:, :700], ref[:, :700], rowmax[:, :700], ref_rowmax[:, :700])
    again = fa._fwd_hb_kernel(q, k, v, sink_t, ftab, hb_params)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), again))
    one = fa._fwd_kernel(q, k, v, sink_t, ftab, params)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), one))


def test_forward_checks_catch_planted_faults(card):
    """The smoke's forward checks on mutated builds of the forward walk:
    every head of a ``flex_fwd_hb`` item on its first head's kv head, and
    the second consumer warpgroup's partial dropped from the odd-G merge of
    ``flex_fwd``. Each must fail a check."""
    import chip_smoke
    from magiattention_tpu_torch import csrc

    csrc.load("flex_fwd")
    csrc.load("flex_fwd_hb")
    planted = chip_smoke.planted_libraries(
        chip_smoke.start_planted_build(["flex_fwd_hb", "flex_fwd_drop_partial"]))
    caught = chip_smoke.fwd_planted_faults(card, planted)
    assert len(caught) == 2 and all(c["failed_checks"] for c in caught.values())


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "case",
    [("causal", [(0, 700)], [(0, 700)], [C], {}),
     ("varlen_softcap_sink", [(0, 300), (300, 700)], [(0, 300), (300, 700)], [C, C],
      {"softcap": 30.0, "sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
     ("full_inv_bi", [(0, 200), (200, 450), (450, 700)], [(0, 700), (0, 500), (100, 700)],
      [F, I, B], {})],
    ids=lambda c: c[0],
)
def test_row_major_kernels_in_float32_match_plain(card, case, d, group):
    """``flex_fwd``, ``flex_fwd_hb``, ``flex_dq`` and ``flex_dkv`` on
    float32 q/k/v (the CUDA-core walks) within the float32 row of
    ``DEFAULT_BUDGETS`` (the smoke's ``f32_problem_check``: gradients held
    to the whole row on their entries of at least 1% of the largest), each
    twice for the same bits, the head-batched forward bit for bit
    ``flex_fwd``'s."""
    import chip_smoke

    _, qr, kr, ty, kw = case
    p = chip_smoke.Flex(card, 700, 700, 8, 8 // group, qr, kr, ty, d=d, dtype=torch.float32,
                        **kw)
    chip_smoke.f32_problem_check(p, case[0])


def test_narrow_and_float32_checks_catch_planted_faults(card):
    """The smoke's checks on mutated builds of this slice's walks: the d-32
    tile path reading every k slice of S = Q K^T from the first, and the
    float32 forward not rescaling O when a row's max rises."""
    import chip_smoke
    from magiattention_tpu_torch import csrc

    csrc.load("flex_fwd")
    csrc.load("flex_fwd_hb")
    planted = chip_smoke.planted_libraries(chip_smoke.start_planted_build(
        ["flex_fwd_hb_d32_first_slice", "flex_fwd_f32_no_rescale"]))
    caught = chip_smoke.narrow_planted_faults(card, planted)
    assert len(caught) == 2


def _bwd_problem(gen, tq, tk, hq, hk, d, q_ranges, k_ranges, types, softcap=0.0, sink=False):
    from magiattention_tpu_torch.ops import flex_attn as fa

    meta = fa.build_block_meta(q_ranges, k_ranges, types, tq, tk, block_q=64, block_k=64)
    tqp, tkp = meta.num_q_blocks * 64, meta.num_k_blocks * 64

    def rand(h, t, tp):
        return fa._pad_tokens(
            torch.randn((h, t, d), generator=gen, device="cuda").bfloat16(), tp)

    q, k, v, do = rand(hq, tq, tqp), rand(hk, tk, tkp), rand(hk, tk, tkp), rand(hq, tq, tqp)
    sink_t = torch.randn((hq,), generator=gen, device="cuda")
    params = fa.FlexAttnParams(64, 64, 1.0 / math.sqrt(d), softcap, sink, torch.bfloat16)
    ftab, btab = fa.fwd_tables(meta, "cuda:0"), fa.bwd_tables(meta, "cuda:0")
    out, lse, _ = fa._fwd_torch(q, k, v, sink_t, ftab, params)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    delta = (do.float() * out.float()).sum(-1) - dlse
    return fa, (q, k, v, do, lse, delta), ftab, btab, params


def _bwd_failures(got, ref):
    """The gradient checks (head-major [h, t, d]) that ``got`` fails."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return ["finite"]
    diff = (got - ref).abs()
    ref_max = ref.abs().max()
    pad = (0, 0, 0, (-ref.shape[1]) % 64)

    def block_max(x):
        x = torch.nn.functional.pad(x, pad)
        return x.reshape(x.shape[0], -1, 64 * x.shape[2]).amax(-1)

    checks = {
        "max": diff.max() <= 2e-2 * ref_max + 1e-3,
        "rel_l2": (got - ref).norm() <= 1e-2 * ref.norm(),
        "blocks": (block_max(diff) <= 2e-2 * block_max(ref.abs()) + 1e-5 * ref_max).all(),
    }
    return [name for name, ok in checks.items() if not bool(ok)]


def _bwd_close(got, ref):
    assert _bwd_failures(got, ref) == []


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "case",
    [
        ("causal", [(0, 700)], [(0, 700)], [C], 0.0, False),
        ("varlen_softcap", [(0, 300), (300, 700)], [(0, 300), (300, 700)], [C, C], 30.0, False),
        ("full_inv_bi", [(0, 200), (200, 450), (450, 700)], [(0, 700), (0, 500), (100, 700)],
         [F, I, B], 0.0, False),
        ("uncovered_sink", [(100, 400)], [(0, 350)], [C], 0.0, True),
    ],
    ids=lambda c: c[0],
)
def test_flex_bwd_matches_plain(card, case, d, group):
    """``flex_dq`` (a head pair per block at even G, one head with its walk
    split between two warpgroups at G = 1) and ``flex_dkv`` against the
    plain backward, and two runs bit for bit (no atomics; the warpgroups'
    partials are added in a fixed order)."""
    _, qr, kr, ty, softcap, sink = case
    fa, args, ftab, btab, params = _bwd_problem(card, 700, 700, 4 * group, 4, d, qr, kr, ty,
                                                softcap, sink)
    dq = fa._dq_kernel(*args, ftab, params)
    dk, dv = fa._dkv_kernel(*args, btab, params)
    torch.cuda.synchronize()
    _bwd_close(dq, fa._dq_torch(*args, ftab, params))
    ref_dk, ref_dv = fa._dkv_torch(*args, btab, params)
    _bwd_close(dk, ref_dk)
    _bwd_close(dv, ref_dv)
    # no atomics: a second run gives the same bits
    dq2 = fa._dq_kernel(*args, ftab, params)
    dk2, dv2 = fa._dkv_kernel(*args, btab, params)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_grad_checks_catch_planted_faults(card):
    """A long causal walk whose last entries are skipped: the first rows
    and keys set the tensor's largest entry, the late ones are small, and
    the checks must still see the fault."""
    fa, args, ftab, btab, params = _bwd_problem(card, 4096, 4096, 8, 4, 128,
                                                [(0, 4096)], [(0, 4096)], [C])

    def skip_last(tab):
        return (*tab[:6], (tab[6] - 1).clamp_min(0).contiguous())

    ref_dk, ref_dv = fa._dkv_torch(*args, btab, params)
    dk, dv = fa._dkv_kernel(*args, skip_last(btab), params)
    assert _bwd_failures(dk, ref_dk) and _bwd_failures(dv, ref_dv)
    assert _bwd_failures(fa._dq_kernel(*args, skip_last(ftab), params),
                         fa._dq_torch(*args, ftab, params))
    dk, dv = fa._dkv_kernel(*args, btab, params)
    dk[:, -64:], dv[:, -64:] = 0.0, 0.0
    assert _bwd_failures(dk, ref_dk) and _bwd_failures(dv, ref_dv)


def test_autograd_runs_the_kernels(card):
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.ops import flex_flash_attn_func

    q = torch.randn((300, 8, 128), generator=card, device="cuda").bfloat16().requires_grad_()
    k = torch.randn((300, 2, 128), generator=card, device="cuda").bfloat16().requires_grad_()
    v = torch.randn((300, 2, 128), generator=card, device="cuda").bfloat16().requires_grad_()
    csrc.reset_launch_counts()
    # the default choice on a causal mask at G = 4: the row-major grid, head_block 4
    out, lse = flex_flash_attn_func(q, k, v, [(0, 300)], [(0, 300)], [C])
    (out.float().sum() + lse.sum()).backward()
    assert q.grad.dtype == torch.bfloat16 and torch.isfinite(q.grad.float()).all()
    names = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv")
    assert {n: csrc.launches[n] for n in names} == {
        "flex_fwd": 0, "flex_fwd_hb": 1, "flex_dq": 1, "flex_dkv": 1}
    flex_flash_attn_func(q, k, v, [(0, 300)], [(0, 300)], [C], head_block=1)
    assert csrc.launches["flex_fwd"] == 1


def test_flex_fwd_refuses_what_it_does_not_implement(card):
    from magiattention_tpu_torch.ops import flex_flash_attn_func

    q = torch.randn((64, 4, 128), generator=card, device="cuda").bfloat16()
    k = q[:, :2].contiguous()
    out, lse = flex_flash_attn_func(q, k, k, [(0, 64)], [(0, 64)], [C], grid="sparse")
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    out, lse = flex_flash_attn_func(q, k, k, [(0, 64)], [(0, 64)], [C], grid="row_major",
                                    head_block=4)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    with pytest.raises(ValueError, match="head_block 3"):
        flex_flash_attn_func(q, k, k, [(0, 64)], [(0, 64)], [C], grid="row_major", head_block=3)
    # float32 runs the CUDA-core walks, on either grid; a mixed-dtype call is refused
    q32, k32 = q.float(), k.float()
    for grid in ("row_major", "sparse"):
        out, lse = flex_flash_attn_func(q32, k32, k32, [(0, 64)], [(0, 64)], [C], grid=grid)
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(TypeError, match="sparse grid"):
        flex_flash_attn_func(q32, k, k, [(0, 64)], [(0, 64)], [C], grid="sparse")
    with pytest.raises(ValueError, match="tile"):
        flex_flash_attn_func(q, k, k, [(0, 64)], [(0, 64)], [C], block_q=32)


# the sparse grid: each kernel against its plain version, twice for the same bits


def _sparse_masks():
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    return {
        "varlen_block_causal": split_slices(varlen_block_causal(1500, 6, 3)),
        "shared_question": split_slices(shared_question_q_overlap(1500, 4)),
        "full_inv_bi": ([(0, 500), (500, 1000), (1000, 1500)],
                        [(0, 1500), (0, 1200), (300, 1500)], [F, I, B]),
    }


@pytest.mark.parametrize("hb_of_group", [1, 0, 2], ids=["hbG", "hb1", "hb2G"])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("mask", ["varlen_block_causal", "shared_question", "full_inv_bi"])
def test_sparse_kernels_match_plain(card, mask, d, group, hb_of_group):
    import dataclasses

    qr, kr, ty = _sparse_masks()[mask]
    hk = 2
    hq = hk * group
    hb = {1: group, 0: 1, 2: 2 * group}[hb_of_group]
    fa, args, ftab, btab, params = _bwd_problem(card, 1500, 1500, hq, hk, d, qr, kr, ty,
                                                softcap=30.0 if d == 64 else 0.0,
                                                sink=mask == "shared_question")
    params = dataclasses.replace(params, head_block=hb, grid="sparse")
    meta = fa.build_block_meta(qr, kr, ty, 1500, 1500, block_q=64, block_k=64)
    work = fa.sparse_work(meta, "cuda:0", hq, hk, hb)
    q, k, v = args[:3]
    sink = torch.randn((hq,), generator=card, device="cuda")
    fwd = fa._fwd_sparse_hb_kernel if hb > 1 else fa._fwd_sparse_kernel
    out, lse, rowmax = fwd(q, k, v, sink, ftab, work, params)
    ref, ref_lse, ref_rowmax = fa._fwd_torch_sparse(q, k, v, sink, ftab, params)
    _close(out[:, :1500], ref[:, :1500], lse[:, :1500], ref_lse[:, :1500])
    _close(out[:, :1500], ref[:, :1500], rowmax[:, :1500], ref_rowmax[:, :1500])
    again = fwd(q, k, v, sink, ftab, work, params)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), again))

    dq = fa._dq_sparse_kernel(*args, ftab, work, params)
    dk, dv = fa._dkv_sparse_kernel(*args, btab, work, params)
    torch.cuda.synchronize()
    _bwd_close(dq, fa._dq_torch(*args, ftab, params))
    ref_dk, ref_dv = fa._dkv_torch(*args, btab, params)
    _bwd_close(dk, ref_dk)
    _bwd_close(dv, ref_dv)
    assert torch.equal(dq, fa._dq_sparse_kernel(*args, ftab, work, params))
    dk2, dv2 = fa._dkv_sparse_kernel(*args, btab, work, params)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _rising_keys(k, t, top=12.0):
    """k with its first t keys scaled from 1 to ``top`` along the sequence:
    later tiles' logits pass a row's AMLA reference, so that it moves."""
    ramp = torch.linspace(1.0, top, t, device=k.device)[None, :, None]
    k = k.clone()
    k[:, :t] = (k[:, :t].float() * ramp).to(k.dtype)
    return k


@pytest.mark.parametrize("hb_of_group", [0, 1], ids=["hb1", "hbG"])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("mask", ["varlen_block_causal", "shared_question", "full_inv_bi",
                                  "one_tile_walks", "rising_logits", "uncovered_rows"])
def test_sparse_forward_matches_plain(card, mask, d, group, hb_of_group):
    """``flex_fwd_sparse`` (head_block 1: one q head an item, each consumer
    warpgroup taking items of its own) and ``flex_fwd_sparse_hb`` (head_block
    G, 2 at G = 1: head pairs of one kv head at even G) against
    the plain AMLA forward: out within 1e-2 + 1e-2 |ref|, lse and rowmax
    within 2e-4, two runs bit for bit. Softcap at d 64, a sink on the
    shared-question mask; on rising logits the AMLA reference moves, so the
    exponent-add rescale runs."""
    import dataclasses

    t = 1500
    if mask == "one_tile_walks":
        qr, kr, ty = _one_tile_docs(t)
    elif mask == "rising_logits":
        qr, kr, ty = [(0, t)], [(0, t)], [C]
    elif mask == "uncovered_rows":
        qr, kr, ty = [(100, 900)], [(0, 800)], [C]
    else:
        qr, kr, ty = _sparse_masks()[mask]
    hk = 2
    hq = hk * group
    hb = max(group, 2) if hb_of_group else 1
    fa, args, ftab, _, params = _bwd_problem(card, t, t, hq, hk, d, qr, kr, ty,
                                             softcap=30.0 if d == 64 else 0.0,
                                             sink=mask == "shared_question")
    params = dataclasses.replace(params, head_block=hb, grid="sparse")
    meta = fa.build_block_meta(qr, kr, ty, t, t, block_q=64, block_k=64)
    work = fa.sparse_work(meta, "cuda:0", hq, hk, hb)
    q, k, v = args[:3]
    if mask == "rising_logits":
        k = _rising_keys(k, t)
    sink = torch.randn((hq,), generator=card, device="cuda")
    fwd = fa._fwd_sparse_hb_kernel if hb > 1 else fa._fwd_sparse_kernel
    out, lse, rowmax = fwd(q, k, v, sink, ftab, work, params)
    ref, ref_lse, ref_rowmax = fa._fwd_torch_sparse(q, k, v, sink, ftab, params)
    _close(out[:, :t], ref[:, :t], lse[:, :t], ref_lse[:, :t])
    _close(out[:, :t], ref[:, :t], rowmax[:, :t], ref_rowmax[:, :t])
    again = fwd(q, k, v, sink, ftab, work, params)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), again))


@pytest.mark.parametrize("what", ["q", "k", "v"])
def test_sparse_forward_refuses_misaligned_inputs(card, what):
    """q, k and v load through TMA tensor maps in the sparse forwards: a base
    off 16 bytes raises before any launch."""
    import dataclasses

    from magiattention_tpu_torch import csrc

    qr, kr, ty = _sparse_masks()["varlen_block_causal"]
    fa, args, ftab, _, params = _bwd_problem(card, 1500, 1500, 4, 2, 128, qr, kr, ty)
    meta = fa.build_block_meta(qr, kr, ty, 1500, 1500, block_q=64, block_k=64)
    q, k, v = args[:3]
    x = {"q": q, "k": k, "v": v}[what]
    shifted = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    qkv = {"q": q, "k": k, "v": v, what: shifted}
    sink = torch.zeros((4,), device="cuda")
    csrc.reset_launch_counts()
    for hb, fwd in ((1, fa._fwd_sparse_kernel), (2, fa._fwd_sparse_hb_kernel)):
        work = fa.sparse_work(meta, "cuda:0", 4, 2, hb)
        prm = dataclasses.replace(params, head_block=hb, grid="sparse")
        with pytest.raises(ValueError, match="not 16-byte aligned"):
            fwd(qkv["q"], qkv["k"], qkv["v"], sink, ftab, work, prm)
    assert csrc.launches["flex_fwd_sparse"] == csrc.launches["flex_fwd_sparse_hb"] == 0


def test_sparse_forward_checks_catch_planted_faults(card):
    """The forward checks on mutated builds of both sparse forwards whose
    AMLA rescale of O is skipped once per row, on causal 4096 with rising
    logits (so that the reference moves). Each must fail a check."""
    import chip_smoke
    from magiattention_tpu_torch import csrc

    for name in ("flex_fwd_sparse", "flex_fwd_sparse_hb"):
        csrc.load(name)
    planted = chip_smoke.planted_libraries(chip_smoke.start_planted_build(
        ["flex_fwd_sparse", "flex_fwd_sparse_hb"]))
    hq, hk = 8, 4
    p = chip_smoke.Flex(card, 4096, 4096, hq, hk, [(0, 4096)], [(0, 4096)], [C],
                        k_ramp=chip_smoke.RISING_K)
    for name, hb in (("flex_fwd_sparse", 1), ("flex_fwd_sparse_hb", 2)):
        p.set_head_block(hb)
        got = chip_smoke.with_library(name, planted[name], p.sparse_kernel)()
        torch.cuda.synchronize()
        _, failed = chip_smoke.out_errors(*p.sparse_fwd_pairs(got))
        assert failed, name


def _one_tile_docs(t):
    """Documents of one 64-token tile each: every q and k block walks one
    tile, so the persistent kernels take many one-tile items."""
    docs = [(a, min(a + 64, t)) for a in range(0, t, 64)]
    return docs, docs, [C] * len(docs)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "mask", ["varlen_block_causal", "shared_question", "full_inv_bi", "one_tile_walks"])
def test_sparse_backward_matches_plain_and_row_major(card, mask, d, group):
    """``flex_dq_sparse`` (persistent; head pairs at even G, a walk split
    between the two warpgroups at odd G) and ``flex_dkv_sparse`` against
    the plain backward, two runs bit for bit, and bit for bit ``flex_dq`` /
    ``flex_dkv`` on the same tables: each item is the row-major kernel's
    per-block walk, in its order."""
    qr, kr, ty = _one_tile_docs(1500) if mask == "one_tile_walks" else _sparse_masks()[mask]
    hk = 2
    hq = hk * group
    fa, args, ftab, btab, params = _bwd_problem(card, 1500, 1500, hq, hk, d, qr, kr, ty,
                                                softcap=30.0 if d == 64 else 0.0,
                                                sink=mask == "shared_question")
    meta = fa.build_block_meta(qr, kr, ty, 1500, 1500, block_q=64, block_k=64)
    if mask == "one_tile_walks":
        assert (ftab[6] == 1).all() and (btab[6] == 1).all()
    work = fa.sparse_work(meta, "cuda:0", hq, hk, group)
    dq = fa._dq_sparse_kernel(*args, ftab, work, params)
    dk, dv = fa._dkv_sparse_kernel(*args, btab, work, params)
    torch.cuda.synchronize()
    _bwd_close(dq, fa._dq_torch(*args, ftab, params))
    ref_dk, ref_dv = fa._dkv_torch(*args, btab, params)
    _bwd_close(dk, ref_dk)
    _bwd_close(dv, ref_dv)
    assert torch.equal(dq, fa._dq_sparse_kernel(*args, ftab, work, params))
    dk2, dv2 = fa._dkv_sparse_kernel(*args, btab, work, params)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, fa._dq_kernel(*args, ftab, params))
    rm_dk, rm_dv = fa._dkv_kernel(*args, btab, params)
    assert torch.equal(dk, rm_dk) and torch.equal(dv, rm_dv)


@pytest.mark.parametrize("what", ["q", "k", "dout", "lse"])
def test_sparse_backward_refuses_misaligned_inputs(card, what):
    """A base that TMA (or a bulk copy) cannot load raises before any
    launch, on the card as on the CPU: no fallback."""
    from magiattention_tpu_torch import csrc

    qr, kr, ty = _sparse_masks()["varlen_block_causal"]
    fa, args, ftab, btab, params = _bwd_problem(card, 1500, 1500, 4, 2, 128, qr, kr, ty)
    meta = fa.build_block_meta(qr, kr, ty, 1500, 1500, block_q=64, block_k=64)
    work = fa.sparse_work(meta, "cuda:0", 4, 2, 2)
    index = ["q", "k", "v", "dout", "lse", "delta"].index(what)
    x = args[index]
    shifted = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    args = (*args[:index], shifted, *args[index + 1:])
    csrc.reset_launch_counts()
    if what != "lse":
        with pytest.raises(ValueError, match="not 16-byte aligned"):
            fa._dq_sparse_kernel(*args, ftab, work, params)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        fa._dkv_sparse_kernel(*args, btab, work, params)
    assert csrc.launches["flex_dq_sparse"] == csrc.launches["flex_dkv_sparse"] == 0


def test_sparse_backward_checks_catch_planted_faults(card):
    """The gradient checks on mutated builds of the persistent sparse
    backward, on a problem of many items a block: each dq item after a
    block's first reusing the previous item's resident Q and dO, and the
    dK/dV partials not zeroed between a block's items. Each must fail."""
    import chip_smoke
    from magiattention_tpu_torch import csrc

    fa, args, ftab, btab, params = _bwd_problem(card, 4096, 4096, 8, 4, 128,
                                                *_sparse_masks_at(4096))
    meta = fa.build_block_meta(*_sparse_masks_at(4096), 4096, 4096, block_q=64, block_k=64)
    work = fa.sparse_work(meta, "cuda:0", 8, 4, 2)
    csrc.load("flex_dq_sparse")
    csrc.load("flex_dkv_sparse")
    planted = chip_smoke.planted_libraries(chip_smoke.start_planted_build(
        ["flex_dq_sparse_stale_resident", "flex_dkv_sparse_unzeroed"]))
    real = {n: csrc._libs[n] for n in ("flex_dq_sparse", "flex_dkv_sparse")}
    try:
        csrc._libs["flex_dq_sparse"] = planted["flex_dq_sparse_stale_resident"]
        csrc._libs["flex_dkv_sparse"] = planted["flex_dkv_sparse_unzeroed"]
        dq = fa._dq_sparse_kernel(*args, ftab, work, params)
        dk, dv = fa._dkv_sparse_kernel(*args, btab, work, params)
        torch.cuda.synchronize()
    finally:
        csrc._libs.update(real)
    ref_dk, ref_dv = fa._dkv_torch(*args, btab, params)
    assert _bwd_failures(dq, fa._dq_torch(*args, ftab, params))
    assert _bwd_failures(dk, ref_dk) and _bwd_failures(dv, ref_dv)


def _sparse_masks_at(t):
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    return split_slices(varlen_block_causal(t))


@pytest.mark.parametrize("heads", [(8, 2), (4, 4)], ids=["hq8_hk2", "hq4_hk4"])
def test_autograd_on_the_sparse_grid_runs_the_sparse_kernels(card, heads, monkeypatch):
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.ops import flex_flash_attn_func

    monkeypatch.delenv("MAGI_ATTENTION_GRID", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_HEAD_BLOCK", raising=False)
    hq, hk = heads
    qr, kr, ty = _sparse_masks()["varlen_block_causal"]

    def rand(h):
        return torch.randn((1500, h, 128), generator=card, device="cuda").bfloat16().requires_grad_()

    q, k, v = rand(hq), rand(hk), rand(hk)
    csrc.reset_launch_counts()
    out, lse = flex_flash_attn_func(q, k, v, qr, kr, ty)  # the default choice: the sparse grid
    (out.float().sum() + lse.sum()).backward()
    assert torch.isfinite(q.grad.float()).all() and torch.isfinite(k.grad.float()).all()
    fwd = "flex_fwd_sparse_hb" if hq > hk else "flex_fwd_sparse"
    names = ("flex_fwd", "flex_dq", "flex_dkv", "flex_fwd_sparse", "flex_fwd_sparse_hb",
             "flex_dq_sparse", "flex_dkv_sparse")
    assert {n: csrc.launches[n] for n in names} == {
        n: int(n in (fwd, "flex_dq_sparse", "flex_dkv_sparse")) for n in names}


@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_matches_plain(card, splits, dtype):
    from magiattention_tpu_torch.serving import (
        assign_block_table, decode_attn_paged, decode_reference, make_paged_kv_cache,
        write_prefill_kv,
    )

    lengths, mpp, ps = [0, 1, 128, 129, 700, 12 * 128], 12, 128
    cache = make_paged_kv_cache(len(lengths) * mpp + 1, ps, 8, 128,
                                max_seqs=len(lengths), max_pages_per_seq=mpp, dtype=dtype)
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, list(range(1 + slot * mpp, 1 + (slot + 1) * mpp)))
        kv = torch.randn((2, n, 8, 128), generator=card, device="cuda").to(dtype)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    q = torch.randn((len(lengths), 32, 128), generator=card, device="cuda").to(dtype)
    out, lse = decode_attn_paged(q, cache, torch.arange(len(lengths), device="cuda"),
                                 num_splits=splits, out_dtype=torch.float32)
    ref, ref_lse = decode_reference(q, cache, cache.block_tables, cache.seq_lens)
    _close(out, ref, lse, ref_lse)
    assert (out[0] == 0).all()


def test_cascade_decode_on_card_matches_flat(card):
    """Shared-prefix serving on the card: three forks of a 2.5-page prompt
    (each first write a copy-on-write split), then a decode step through
    cascade decode and through the flat path on the same state."""
    from magiattention_tpu_torch.serving import ServingEngine, decode_reference

    eng = ServingEngine(num_pages=64, num_kv_heads=2, head_dim=128, page_size=128,
                        max_seqs=4, max_pages_per_seq=8)
    prefix = list(range(320))
    slots = []
    for i, extra in enumerate((0, 40, 200, 7)):
        toks = prefix + [1000 + i] * extra
        res = eng.admit(len(toks), tokens=toks)
        assert res.admitted and res.prefix_len == (len(prefix) if i else 0)
        n = len(toks) - res.prefix_len
        q, kv = (torch.randn((n, h, 128), generator=card, device="cuda").bfloat16()
                 for h in (8, 4))
        eng.prefill(q, kv[:, :2], kv[:, 2:], res.slot)
        slots.append(res.slot)
    lens = eng.cache.seq_lens.clone()
    q = torch.randn((4, 8, 128), generator=card, device="cuda").bfloat16()
    kv = torch.randn((4, 4, 128), generator=card, device="cuda").bfloat16()
    out_c, lse_c = eng.decode_step(q, kv[:, :2], kv[:, 2:], slots, cascade="on",
                                   out_dtype=torch.float32)
    idx = torch.as_tensor(slots, device="cuda")
    ref, ref_lse = decode_reference(q, eng.cache, eng.cache.block_tables[idx],
                                    eng.cache.seq_lens[idx])
    _close(out_c, ref, lse_c, ref_lse)
    eng.cache.seq_lens.copy_(lens)  # rewind the append: the flat path on the same state
    for s in slots:
        eng._lengths[s] -= 1
    out_f, lse_f = eng.decode_step(q, kv[:, :2], kv[:, 2:], slots, cascade="off",
                                   out_dtype=torch.float32)
    assert ((out_c - out_f).abs() <= 1e-3).all() and ((lse_c - lse_f).abs() <= 2e-4).all()


def _decode_problem(gen, d, dtype, hq, hk, ps, lengths, mpp):
    """One random sequence per slot on a shuffled run of the pool's pages."""
    from magiattention_tpu_torch.serving import (
        assign_block_table, make_paged_kv_cache, write_prefill_kv,
    )

    b = len(lengths)
    cache = make_paged_kv_cache(b * mpp + 1, ps, hk, d, max_seqs=b, max_pages_per_seq=mpp,
                                dtype=dtype)
    pages = (torch.randperm(b * mpp, generator=gen, device="cuda") + 1).tolist()
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, pages[slot * mpp:(slot + 1) * mpp])
        kv = torch.randn((2, n, hk, d), generator=gen, device="cuda").to(dtype)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    return cache, q


def _decode_parts(q, cache, bt, sl, splits, softcap=0.0, shared=False):
    from magiattention_tpu_torch.serving import decode_attn as da

    params = da.DecodeParams(1.0 / math.sqrt(q.shape[2]), softcap, splits, torch.float32)
    return da._decode_partials_kernel(q, cache, bt, sl, params, shared=shared)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


_DECODE_CASES = [(d, dt, g, ps) for d in (64, 128) for dt in (torch.bfloat16, torch.float32)
                 for g in (1, 2, 4, 8) + ((16,) if dt == torch.bfloat16 else ())
                 for ps in (16, 64, 128)]


@pytest.mark.parametrize("d,dtype,group,ps", _DECODE_CASES,
                         ids=[f"d{d}-{str(dt)[6:]}-g{g}-ps{ps}" for d, dt, g, ps in _DECODE_CASES])
def test_paged_decode_cases_match_plain(card, d, dtype, group, ps):
    """Ragged and zero lengths on shuffled pages, splits 1/3/4/16, softcap on
    one page size; every launch run twice for the same bits."""
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    mpp, hk = 48, 2
    full = mpp * ps
    lens = [0, 1, ps - 1, ps + 1, 5 * ps + 3, full // 2 + 7, full - 1, full]
    cache, q = _decode_problem(card, d, dtype, group * hk, hk, ps, lens, mpp)
    bt, sl = cache.block_tables, cache.seq_lens
    softcap = 4.0 if ps == 64 else 0.0
    ref, ref_lse = decode_reference(q, cache, bt, sl, softcap=softcap)
    for splits in (1, 3, 4, 16):
        parts = _decode_parts(q, cache, bt, sl, splits, softcap)
        assert _same_bits(parts, _decode_parts(q, cache, bt, sl, splits, softcap))
        out, lse = da._merge_splits(*parts)
        _close(out, ref, lse, ref_lse)
        assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_never_reads_past_the_lengths(card, dtype):
    """NaN in every position past each sequence's length, in its last page
    and the pages after it, leaves every output bit as it was."""
    import dataclasses

    mpp, ps = 12, 64
    lens = [0, 1, 63, 65, 300, 700]
    cache, q = _decode_problem(card, 128, dtype, 8, 2, ps, lens, mpp)
    dirty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                v_pages=cache.v_pages.clone())
    for slot, n in enumerate(lens):
        pos = torch.arange(n, mpp * ps, device="cuda")
        page = cache.block_tables[slot].long()[pos // ps]
        dirty.k_pages[page, pos % ps] = float("nan")
        dirty.v_pages[page, pos % ps] = float("nan")
    for splits in (1, 4):
        clean = _decode_parts(q, cache, cache.block_tables, cache.seq_lens, splits)
        assert _same_bits(clean, _decode_parts(q, dirty, cache.block_tables, cache.seq_lens,
                                               splits))


@pytest.mark.parametrize("members", [1, 3, 8])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_shared_mode_matches_flat_and_plain(card, d, dtype, group, members):
    """The cascade's level 1: every member on one shared page row (a partial
    last page), through ``_decode_shared_prefix`` and the kernel's shared
    mode, against the plain version and the flat mode over the broadcast
    table; two runs give the same bits."""
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    hk, w, ps = 2, 12, 64
    cache = da.PagedKVCache(
        *(torch.randn((3 * w + 1, ps, hk, d), generator=card, device="cuda").to(dtype)
          for _ in range(2)),
        torch.zeros((1, w), dtype=torch.int32, device="cuda"),
        torch.zeros((1,), dtype=torch.int32, device="cuda"))
    pages = (torch.randperm(3 * w, generator=card, device="cuda")[:w] + 1).int()
    plen = w * ps - 5
    q = torch.randn((members, group * hk, d), generator=card, device="cuda").to(dtype)
    bt_b = pages[None].expand(members, w).contiguous()
    sl_b = torch.full((members,), plen, dtype=torch.int32, device="cuda")
    ref, ref_lse = decode_reference(q, cache, bt_b, sl_b)
    for splits in (1, 3, 4):
        parts = _decode_parts(q, cache, pages[None], sl_b[:1], splits, shared=True)
        assert _same_bits(parts, _decode_parts(q, cache, pages[None], sl_b[:1], splits,
                                               shared=True))
        out, lse = da._decode_shared_prefix(q, cache, pages, plen, num_splits=splits)
        assert _same_bits((out, lse), da._merge_splits(*parts))
        _close(out, ref, lse, ref_lse)
        flat, flat_lse = da._merge_splits(*_decode_parts(q, cache, bt_b, sl_b, splits))
        _close(out, flat, lse, flat_lse)


def test_cascade_level1_runs_the_shared_mode(card, monkeypatch):
    """``cascade_decode_attn`` launches the kernel's shared mode once per
    group for the prefix and the flat mode for the suffixes, every launch
    counted under ``paged_decode``."""
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import CascadeGroup, cascade_decode_attn
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    lens = [300, 420, 256 + 7]
    cache, q = _decode_problem(card, 128, torch.bfloat16, 8, 2, 64, lens, 8)
    shared = cache.block_tables[0, :4].tolist()
    for slot in (1, 2):  # members 1 and 2 start with slot 0's first 4 pages
        cache.block_tables[slot, :4] = cache.block_tables[0, :4]
    modes = []
    real = da._decode_partials_kernel

    def counting(*args, shared=False, **kw):
        modes.append(shared)
        return real(*args, shared=shared, **kw)

    monkeypatch.setattr(da, "_decode_partials_kernel", counting)
    csrc.reset_launch_counts()
    group = CascadeGroup(tuple(shared), 256, (0, 1, 2))
    out, lse = cascade_decode_attn(q, cache, [0, 1, 2], [group], out_dtype=torch.float32)
    assert modes == [True, False] and csrc.launches["paged_decode"] == 2
    ref, ref_lse = decode_reference(q, cache, cache.block_tables, cache.seq_lens)
    _close(out, ref, lse, ref_lse)


def test_paged_decode_refuses_what_it_does_not_implement(card):
    from magiattention_tpu_torch.serving import decode_attn_paged, make_paged_kv_cache

    cache = make_paged_kv_cache(5, 16, 1, 64, max_seqs=1, max_pages_per_seq=4,
                                dtype=torch.float32)
    # any group is taken (the float32 walk's WIDE mode past 8 rows)
    out, _ = decode_attn_paged(torch.zeros((1, 16, 64), device="cuda"), cache,
                               torch.zeros(1, dtype=torch.long, device="cuda"))
    assert out.shape == (1, 16, 64)
    with pytest.raises(NotImplementedError):
        decode_attn_paged(torch.zeros((1, 4, 64), device="cuda", requires_grad=True), cache,
                          torch.zeros(1, dtype=torch.long, device="cuda"))


# -- the bf16 wide walk (decode_wide_sm90.cuh): flat groups past 32 q heads ------------

_WIDE_CASES = [(d, g, hk, ps) for d in (32, 64, 128)
               for g, hk in ((33, 1), (48, 1), (64, 1), (71, 1), (128, 1), (200, 1), (48, 2))
               for ps in (16, 64, 128)]


def _nan_past(cache, lens):
    """A copy of ``cache`` with NaN in K and V at every position past each
    slot's length in its own pages (the rest of the last page and the pages
    after it)."""
    import dataclasses

    dirty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                v_pages=cache.v_pages.clone())
    ps = cache.page_size
    for slot, n in enumerate(lens):
        pos = torch.arange(n, cache.max_pages_per_seq * ps, device="cuda")
        page = cache.block_tables[slot].long()[pos // ps]
        dirty.k_pages[page, pos % ps] = float("nan")
        dirty.v_pages[page, pos % ps] = float("nan")
    return dirty


@pytest.mark.parametrize("d,group,hk,ps", _WIDE_CASES,
                         ids=[f"d{d}-g{g}-hk{hk}-ps{ps}" for d, g, hk, ps in _WIDE_CASES])
def test_paged_decode_wide_walk_matches_plain(card, d, group, hk, ps):
    """The wide walk: ragged tails not a multiple of 64 (and zero, one and
    full lengths) on shuffled pages, splits 1, 2 and 4, softcap on at one
    page size; against the plain version on the clean cache; two runs give
    the same bits, and NaN planted past every length (in the last page and
    the pages after it) changes no bit."""
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    mpp = max(24, -(-(700 // ps + 1) // 4) * 4)  # room for every length below; 4 splits
    lens = [0, 1, 63, ps + 3, 300, 2 * 64 * 5 + 17, mpp * ps]
    cache, q = _decode_problem(card, d, torch.bfloat16, group * hk, hk, ps, lens, mpp)
    bt, sl = cache.block_tables, cache.seq_lens
    softcap = 30.0 if ps == 64 else 0.0
    ref, ref_lse = decode_reference(q, cache, bt, sl, softcap=softcap)
    dirty = _nan_past(cache, lens)
    for splits in (1, 2, 4):
        parts = _decode_parts(q, cache, bt, sl, splits, softcap)
        assert _same_bits(parts, _decode_parts(q, cache, bt, sl, splits, softcap))
        assert _same_bits(parts, _decode_parts(q, dirty, bt, sl, splits, softcap))
        out, lse = da._merge_splits(*parts)
        _close(out, ref, lse, ref_lse)
        assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()


@pytest.mark.parametrize("splits", [1, 2])
def test_paged_decode_wide_walk_tp_slices_give_the_one_launch_bits(card, splits):
    """96 q heads over 2 kv heads (G 48) under ``tp_decode_attn`` at tp 2:
    each slice's launch passes the pool's kv heads, cuts its walks as the
    one launch does and gives its bits."""
    from magiattention_tpu_torch.serving import decode_attn_paged, shard_kv_cache, tp_decode_attn

    lens = [5, 700, 1500, 3001]
    cache, q = _decode_problem(card, 128, torch.bfloat16, 96, 2, 128, lens, 32)
    slots = torch.arange(len(lens), device="cuda")
    one = decode_attn_paged(q, cache, slots, num_splits=splits, out_dtype=torch.float32)
    sc = shard_kv_cache(cache, ["cuda:0", "cuda:0"])
    tp = tp_decode_attn(q, sc, slots, devices=["cuda:0", "cuda:0"], num_splits=splits,
                        out_dtype=torch.float32)
    assert _same_bits(one, tp)


def test_paged_decode_wide_walk_launches_row_blocks_past_its_walks(card):
    """A batch of more walks than one launch numbers (WIDE_MAX_WALKS)
    launches in row blocks, each cut by the whole batch's schedule: held
    against the plain version, and the launch count is the blocks'."""
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    b = da.WIDE_MAX_WALKS + 7
    lens = [1 + (i * 37) % 128 for i in range(b)]
    cache, q = _decode_problem(card, 64, torch.bfloat16, 48, 1, 128, lens, 1)
    bt, sl = cache.block_tables, cache.seq_lens
    csrc.reset_launch_counts()
    out, lse = da._merge_splits(*_decode_parts(q, cache, bt, sl, 1))
    assert csrc.launches["paged_decode"] == len(
        da.kernel_row_blocks(b, 48, torch.bfloat16, False, head_dim=64)) == 2
    ref, ref_lse = decode_reference(q, cache, bt, sl)
    _close(out, ref, lse, ref_lse)
