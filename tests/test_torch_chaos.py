"""The port's fault injectors (``resilience/chaos.py``) against the JAX
package's on the same numpy inputs: the exception injectors' fire counts
over the same call sequence and ``reset_chaos``, the OSError flavour, the
positions and values a value injector plants (``corrupt_partial``,
``corrupt_cast_payload``, ``corrupt_reduce_payload``) at several seeds,
fields and shapes, bit for bit; the rank gate; the off passthrough; and
``straggler_delay`` leaving its payload bit for bit unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.resilience import chaos as J
from magiattention_tpu_torch.resilience import chaos as C


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_CHAOS", raising=False)
    C.reset_chaos()
    J.reset_chaos()
    yield
    C.reset_chaos()
    J.reset_chaos()


def _arm(monkeypatch, spec):
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", spec)
    C.reset_chaos()
    J.reset_chaos()


def _fires(mod, calls):
    """Which of ``calls`` ((kind, want) or "reset") raised, and the type."""
    seen = []
    for call in calls:
        if call == "reset":
            mod.reset_chaos()
            continue
        kind, want = call
        try:
            mod.maybe_fail(kind, **want)
            seen.append(None)
        except OSError as e:
            seen.append(("oserror", isinstance(e, mod.ChaosInjectedError)))
        except mod.ChaosInjectedError:
            seen.append("raised")
    return seen


@pytest.mark.parametrize("spec,calls", [
    ("alloc_fail:times=2", [("alloc_fail", {})] * 3 + ["reset", ("alloc_fail", {})]),
    ("prefill_error:times=0", [("prefill_error", {})] * 3 + [("alloc_fail", {})]),
    ("plan_error;hops_build_error:times=2",
     [("plan_error", {}), ("hops_build_error", {})] * 3 + ["reset", ("plan_error", {})]),
    ("decode_fault:times=1;decode_fault:times=1", [("decode_fault", {})] * 3),
    ("cache_io_error:op=load", [("cache_io_error", {"op": "store"}),
                                ("cache_io_error", {"op": "load"}),
                                ("cache_io_error", {"op": "load"})]),
], ids=["bound", "unlimited", "two_kinds", "two_clauses", "oserror"])
def test_exception_injectors_fire_as_jax(spec, calls, monkeypatch):
    _arm(monkeypatch, spec)
    got, want = _fires(C, calls), _fires(J, calls)
    assert got == want
    assert any(got)


def test_cache_io_error_is_an_oserror(monkeypatch):
    _arm(monkeypatch, "cache_io_error:op=load")
    with pytest.raises(OSError) as e:
        C.maybe_fail("cache_io_error", op="load")
    assert isinstance(e.value, C.ChaosInjectedError)
    C.reset_chaos()
    C.maybe_fail("cache_io_error", op="store")  # the other op does not fire


def test_pool_exhausted_and_enabled_follow_the_spec(monkeypatch):
    assert not C.enabled() and not C.pool_exhausted()
    _arm(monkeypatch, "pool_exhaust")
    assert C.enabled() and C.pool_exhausted() == J.pool_exhausted() is True
    _arm(monkeypatch, "alloc_fail")
    assert not C.pool_exhausted()


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)


@pytest.mark.parametrize("shape", [(8, 2, 4), (5, 3, 16), (3, 7, 9, 8)])
@pytest.mark.parametrize("clause", [
    "field=out,value=nan,seed=5", "field=lse,value=inf,seed=30", "value=nan,seed=0",
    "field=both,value=finite:8.0,seed=123", "value=inf,seed=1000",
])
def test_corrupt_partial_plants_where_jax_does(shape, clause, monkeypatch):
    _arm(monkeypatch, f"corrupt_partial:site=stage0,{clause}")
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    out = rng.standard_normal(shape).astype(np.float32)
    lse = rng.standard_normal(shape[:-1]).astype(np.float32)
    o_t, l_t = torch.from_numpy(out), torch.from_numpy(lse)
    got = C.corrupt_partial(o_t, l_t, "stage0")
    want = J.corrupt_partial(jnp.asarray(out), jnp.asarray(lse), "stage0")
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert not (_same(got[0], out) and _same(got[1], lse)), "nothing was planted"
    assert _same(o_t, out) and _same(l_t, lse), "the inputs were written"
    other = C.corrupt_partial(o_t, l_t, "stage1")  # another site: untouched
    assert other[0] is o_t and other[1] is l_t


@pytest.mark.parametrize("rank", [0, 1])
def test_corrupt_partial_rank_gate(rank, monkeypatch):
    """``rank=`` plants on that rank of the flat group only; ``rank=None``
    (a hierarchical plan) plants on every rank, as JAX without an axis."""
    _arm(monkeypatch, "corrupt_partial:site=host,value=nan,rank=1,seed=3")
    out, lse = np.ones((4, 2, 3), np.float32), np.zeros((4, 2), np.float32)
    want = J.corrupt_partial(jnp.asarray(out), jnp.asarray(lse), "host")
    got = C.corrupt_partial(torch.from_numpy(out), torch.from_numpy(lse), "host", rank=rank)
    planted = rank == 1
    assert _same(got[0], want[0] if planted else out)
    assert _same(got[1], want[1] if planted else lse)
    every = C.corrupt_partial(torch.from_numpy(out), torch.from_numpy(lse), "host", rank=None)
    assert _same(every[0], want[0]) and _same(every[1], want[1])


@pytest.mark.parametrize("rows", [1, 6, 40])
@pytest.mark.parametrize("spec", [
    "corrupt_cast:value=nan,seed=0", "corrupt_cast:value=inf,seed=17",
    "permute_cast", "corrupt_cast:value=finite:0.5,seed=9;permute_cast",
])
def test_corrupt_cast_payload_as_jax(rows, spec, monkeypatch):
    _arm(monkeypatch, spec)
    x = np.random.default_rng(rows).standard_normal((rows, 2, 3)).astype(np.float32)
    got = C.corrupt_cast_payload(torch.from_numpy(x))
    assert _same(got, J.corrupt_cast_payload(jnp.asarray(x)))
    gated = C.corrupt_cast_payload(torch.from_numpy(x), rank=0)  # rank=-1: every rank
    assert _same(gated, J.corrupt_cast_payload(jnp.asarray(x)))


@pytest.mark.parametrize("rows", [3, 16])
@pytest.mark.parametrize("spec", ["corrupt_reduce:value=nan,seed=4",
                                  "corrupt_reduce:value=inf,seed=21,rank=0"])
def test_corrupt_reduce_payload_as_jax(rows, spec, monkeypatch):
    _arm(monkeypatch, spec)
    for shape in ((rows, 4, 8), (rows, 4)):  # an out payload and an lse payload
        x = np.random.default_rng(rows).standard_normal(shape).astype(np.float32)
        got = C.corrupt_reduce_payload(torch.from_numpy(x), rank=0)
        assert _same(got, J.corrupt_reduce_payload(jnp.asarray(x)))
    # the rank gate: rank 1 is not the clause's (rank=0 clause) / is (rank -1)
    off_rank = C.corrupt_reduce_payload(torch.from_numpy(x), rank=1)
    assert _same(off_rank, J.corrupt_reduce_payload(jnp.asarray(x)) if "rank=0" not in spec
                 else x)


def test_chaos_off_injectors_are_passthrough(monkeypatch):
    assert not C.enabled()
    x = torch.arange(6.0)
    out, lse = torch.zeros((2, 1, 3)), torch.zeros((2, 1))
    assert C.corrupt_cast_payload(x) is x
    assert C.corrupt_reduce_payload(x) is x
    assert C.straggler_delay(x, 1) is x
    got = C.corrupt_partial(out, lse, "merged")
    assert got[0] is out and got[1] is lse
    C.maybe_fail("plan_error")  # no-op
    assert not C.pool_exhausted()


@pytest.mark.parametrize("delay", [1, 8])
def test_straggler_is_bit_transparent(delay, monkeypatch):
    _arm(monkeypatch, f"straggler:hop=2,delay={delay}")
    x = torch.from_numpy(np.random.default_rng(delay).standard_normal((12, 3)).astype(np.float32))
    x[0, 0] = float("nan")
    got = C.straggler_delay(x, 2)
    assert got is not x and _same(got, x.numpy())
    assert _same(got, np.asarray(J.straggler_delay(jnp.asarray(x.numpy()), 2)))
    assert C.straggler_delay(x, 1) is x  # the untargeted hop: nothing
