"""``MAGI_ATTENTION_KERNEL_BACKEND`` in the port (fault C.5, repaired).

The JAX package reads the flag (``pallas|jnp|jnp_online``), validates it in
``check_flag_comb``, folds it into its key and swaps the Pallas core for its
dense or online jnp forward on the flex and decode paths. The port read none
of it, so ``torch`` on the port still ran the kernels. The port's names are
``cuda|torch|torch_online``; a JAX name raises naming the port's one.

Held here: the C.5 test (a JAX name makes the port's key raise, and the
backend is in the port's fingerprint; both fail on the unrepaired port);
every value picking its path in ``flex_flash_attn_func``,
``flex_attn_with_meta`` and the decode path, on CPU tensors and on tensors
that claim a card (``on_card`` patched: the kernel wrappers must not be
reached under ``torch``); ``torch_online`` against ``torch``, against JAX's
``_fwd_jnp_online`` and against the plain oracle, forward and gradients,
within the float32 row of ``DEFAULT_BUDGETS``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import flex_flash_attn_func as jax_flex
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch import env
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.ops import flex_attn_with_meta, flex_flash_attn_func
from magiattention_tpu_torch.ops.block_meta import build_block_meta
from magiattention_tpu_torch.serving import decode_attn as da
from magiattention_tpu_torch.serving import decode_attn_paged

from tests.test_torch_decode_attn import _check as decode_check
from tests.test_torch_decode_attn import _state as decode_state
from tests.test_torch_flex_attn import _inputs
from tests.test_torch_flex_attn_bwd import _assert_grad_within_budget, _cotangents
from tests.torch_jax_backend import jax_backend

BUDGET = DEFAULT_BUDGETS["float32"]
BACKENDS = ("cuda", "torch", "torch_online")
# (name, tq, tk, q_ranges, k_ranges, types, hq, hk, d, softcap, sink)
CASES = [
    ("varlen_causal", 200, 200, [(0, 70), (70, 200)], [(0, 70), (70, 200)], [1, 1], 4, 2, 32,
     0.0, None),
    ("mixed_softcap_sink", 192, 160, [(0, 64), (64, 192)], [(0, 160), (20, 150)], [0, 3], 4, 1,
     32, 4.0, [0.5, -1.0, 2.0, 0.0]),
    ("uncovered_rows", 130, 130, [(20, 100)], [(0, 90)], [1], 2, 2, 64, 0.0, None),
]


def _key(**kw):
    return interface.magi_attn_flex_key([(0, 256)], [(0, 256)], [1], 256, 256, None,
                                        num_heads=(4, 2), head_dim=64, chunk_size=64,
                                        device="cpu", **kw)


@pytest.mark.parametrize("jax_name,port_name", [("jnp", "torch"), ("jnp_online", "torch_online"),
                                                ("pallas", "cuda")])
def test_c5_jax_name_refused_and_backend_keyed(jax_name, port_name, monkeypatch):
    """C.5: the port's keyed API refuses the JAX names (naming the port's
    counterpart) before planning, and the backend is part of its key."""
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", jax_name)
    with pytest.raises(ValueError, match=f"port calls it '{port_name}'"):
        _key()
    with pytest.raises(ValueError, match=f"port calls it '{port_name}'"):
        interface.check_flag_comb()
    monkeypatch.delenv("MAGI_ATTENTION_KERNEL_BACKEND")
    default = interface.flags_fingerprint()
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", port_name)
    assert (interface.flags_fingerprint() != default) == (port_name != "cuda")


@pytest.mark.parametrize("value", ["bogus", "triton", "pallas_interpret", ""])
def test_unknown_backend_raises(value, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", value)
    with pytest.raises(ValueError, match="is not one of"):
        env.kernel_backend()


@pytest.mark.parametrize("value", ["cuda", "TORCH", " torch_online "])
def test_port_names_accepted(value, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", value)
    assert env.kernel_backend() == value.strip().lower()
    interface.check_flag_comb()


class _Spies:
    """Counts the calls of the flex paths' entry functions."""

    def __init__(self, monkeypatch):
        self.calls = {"core": 0, "torch": 0, "torch_online": 0}
        real_core, real_torch, real_online = (fa._FlexAttnCore.apply, fa._fwd_torch,
                                              fa._fwd_torch_online)

        def wrap(name, fn):
            def spy(*a, **k):
                self.calls[name] += 1
                return fn(*a, **k)
            return spy

        monkeypatch.setattr(fa._FlexAttnCore, "apply", wrap("core", real_core))
        monkeypatch.setattr(fa, "_fwd_torch", wrap("torch", real_torch))
        monkeypatch.setattr(fa, "_fwd_torch_online", wrap("torch_online", real_online))


def _problem(case, grad=True):
    name, tq, tk, qr, kr, ty, hq, hk, d, softcap, sink = case
    q, k, v = (torch.from_numpy(x).requires_grad_(grad) for x in _inputs(5, tq, tk, hq, hk, d))
    s = None if sink is None else torch.tensor(sink, requires_grad=grad)
    return q, k, v, s


@pytest.mark.parametrize("entry", ["flex_flash_attn_func", "flex_attn_with_meta"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_each_value_picks_its_path(backend, entry, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", backend)
    spies = _Spies(monkeypatch)
    name, tq, tk, qr, kr, ty, hq, hk, d, softcap, sink = CASES[1]
    q, k, v, s = _problem(CASES[1])
    if entry == "flex_flash_attn_func":
        out, lse = flex_flash_attn_func(q, k, v, qr, kr, ty, softcap=softcap, sink=s)
    else:
        meta = build_block_meta(qr, kr, ty, tq, tk, block_q=64, block_k=64)
        out, lse = flex_attn_with_meta(q, k, v, meta, softcap=softcap, sink=s)
    torch.autograd.grad((out.sum(), lse.sum()), (q, k, v, s))
    want = {"cuda": "core", "torch": "torch", "torch_online": "torch_online"}[backend]
    assert spies.calls[want] == 1
    assert sum(spies.calls.values()) == 1 + (backend == "cuda")  # the core runs _fwd_torch inside


@pytest.mark.parametrize("backend", BACKENDS)
def test_on_a_card_only_cuda_reaches_the_kernels(backend, monkeypatch):
    """Tensors that claim a card: ``cuda`` reaches the kernel wrapper,
    ``torch`` / ``torch_online`` run the plain forward there instead."""
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", backend)
    monkeypatch.setattr(fa, "on_card", lambda *t: True)

    def launch(*a, **k):
        raise RuntimeError("kernel wrapper reached")

    for name in ("_fwd_kernel", "_fwd_hb_kernel", "_fwd_sparse_kernel", "_fwd_sparse_hb_kernel"):
        monkeypatch.setattr(fa, name, launch)
    name, tq, tk, qr, kr, ty, hq, hk, d, softcap, sink = CASES[0]
    q, k, v, _ = _problem(CASES[0], grad=False)
    if backend == "cuda":
        with pytest.raises(RuntimeError, match="kernel wrapper reached"):
            flex_flash_attn_func(q, k, v, qr, kr, ty)
    else:
        out, _ = flex_flash_attn_func(q, k, v, qr, kr, ty)
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_honours_the_backend(backend, monkeypatch):
    """The decode path: on a card, ``cuda`` launches ``paged_decode``,
    ``torch`` and ``torch_online`` run the plain decode (as JAX's jnp
    backends both do); either way the result is JAX's."""
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", backend)
    monkeypatch.setattr(da, "on_card", lambda *t: True)
    launched = []

    def kernel(q, cache, bt, seq_lens, params, shared=False):
        launched.append(shared)
        raise RuntimeError("paged_decode reached")

    monkeypatch.setattr(da, "_decode_partials_kernel", kernel)
    jcache, cache, q = decode_state(seed=3)
    slots = np.arange(q.shape[0])
    if backend == "cuda":
        with pytest.raises(RuntimeError, match="paged_decode reached"):
            decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots), num_splits=2)
        with pytest.raises(RuntimeError, match="paged_decode reached"):
            da._decode_shared_prefix(torch.from_numpy(q), cache, cache.block_tables[4], 100)
        assert launched == [False, True]
        return
    out, lse = decode_attn_paged(torch.from_numpy(q), cache, torch.from_numpy(slots), num_splits=2)
    da._decode_shared_prefix(torch.from_numpy(q), cache, cache.block_tables[4], 100)
    assert launched == []
    from magiattention_tpu.serving import decode_attn_paged as jax_decode

    jax_backend(monkeypatch)
    jo, jl = jax_decode(jnp.asarray(q), jcache, jnp.asarray(slots), num_splits=2)
    decode_check(jo, jl, out, lse)


def _grads(fn, q, k, v, s, dout, dlse):
    out, lse = fn(q, k, v, s)
    leaves = [x for x in (q, k, v, s) if x is not None]
    return out, lse, torch.autograd.grad((out, lse), leaves, (dout, dlse))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_torch_online_matches_torch_and_jax_online(case, monkeypatch):
    name, tq, tk, qr, kr, ty, hq, hk, d, softcap, sink = case
    qn, kn, vn = _inputs(9, tq, tk, hq, hk, d)
    dout, dlse = _cotangents(13, tq, hq, d)
    sn = None if sink is None else np.asarray(sink, np.float32)

    # JAX: _fwd_jnp_online under jax.vjp, 64 x 64 tiles (its k step)
    jax_backend(monkeypatch, "jnp_online")

    def jax_fn(q, k, v, s):
        return jax_flex(q, k, v, qr, kr, ty, sink=s, softcap=softcap, block_q=64, block_k=64,
                        head_block=1, grid="row_major")

    primals = [jnp.asarray(x) for x in (qn, kn, vn)] + [None if sn is None else jnp.asarray(sn)]
    (jo, jl), vjp = jax.vjp(jax_fn, *primals)
    jgrads = [g for g in vjp((jnp.asarray(dout), jnp.asarray(dlse))) if g is not None]

    results = {}
    for backend in ("torch", "torch_online"):
        monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", backend)
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
        s = None if sn is None else torch.from_numpy(sn).requires_grad_()
        results[backend] = _grads(
            lambda q, k, v, s: flex_flash_attn_func(q, k, v, qr, kr, ty, sink=s, softcap=softcap,
                                                    block_q=64, block_k=64, head_block=1),
            q, k, v, s, torch.from_numpy(dout), torch.from_numpy(dlse))
    for backend, (out, lse, grads) in results.items():
        assert_within_budget(divergence_report(np.asarray(jo), out.detach().numpy(),
                                               ref_lse=np.asarray(jl),
                                               test_lse=lse.detach().numpy()),
                             BUDGET, where=f"{name}/{backend}")
        for what, r, g in zip(("dq", "dk", "dv", "dsink"), jgrads, grads):
            _assert_grad_within_budget(r, g.numpy(), f"{name}/{backend}/{what}")
    # and the two port backends against each other
    (o1, l1, g1), (o2, l2, g2) = results["torch"], results["torch_online"]
    assert_within_budget(divergence_report(o1.detach().numpy(), o2.detach().numpy(),
                                           ref_lse=l1.detach().numpy(),
                                           test_lse=l2.detach().numpy()), BUDGET)
    for a, b in zip(g1, g2):
        _assert_grad_within_budget(a.numpy(), b.numpy(), f"{name}/torch vs torch_online")


def test_torch_online_float64_matches_the_fp64_oracle(monkeypatch):
    """In float64 the online recurrence and the dense oracle agree to
    rounding, forward and gradients."""
    from magiattention_tpu_torch.testing import ref_attn_from_ranges

    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "torch_online")
    name, tq, tk, qr, kr, ty, hq, hk, d, softcap, sink = CASES[1]
    qn, kn, vn = _inputs(2, tq, tk, hq, hk, d)
    dout, dlse = (torch.from_numpy(x).double() for x in _cotangents(4, tq, hq, d))
    kw = dict(softcap=softcap)

    def run(fn):
        q, k, v = (torch.from_numpy(x).double().requires_grad_() for x in (qn, kn, vn))
        s = torch.tensor(sink, dtype=torch.float64, requires_grad=True)
        out, lse = fn(q, k, v, qr, kr, ty, sink=s, **kw)[:2]
        lse = torch.where(torch.isfinite(lse), lse, 0.0)
        return (out, *torch.autograd.grad((out * dout).sum() + (lse * dlse).sum(), (q, k, v, s)))

    for a, b in zip(run(flex_flash_attn_func), run(ref_attn_from_ranges)):
        torch.testing.assert_close(a, b, atol=1e-11, rtol=1e-9)
