"""The guard, chaos, validate and numerics flags in the port.

The port honours ``MAGI_ATTENTION_GUARD`` and ``_CHAOS`` (``resilience/``)
and ``_NUMERICS`` (the value census, ``telemetry/numerics.py``): set to a
value that does not fire there (or, for the census, to ``census``),
``check_flag_comb``, ``ServingEngine``, ``TieredEngine`` and
``decode_attn_paged`` run and return what they return unset. It does not
honour ``_VALIDATE`` yet (ROADMAP A.18): set to anything but ``off``, it
makes those four entry points raise, naming the item that will honour it. A value
outside a flag's domain raises the JAX package's ``ValueError``, word for
word; guard, chaos and numerics are in ``flags_fingerprint`` and validate
is not, as in the JAX package's ``env.py``."""

import numpy as np
import pytest
import torch

from magiattention_tpu import env as jax_env
from magiattention_tpu.resilience.chaos import parse_chaos_spec as jax_parse_chaos_spec
from magiattention_tpu_torch import env
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.resilience import parse_chaos_spec
from magiattention_tpu_torch.serving import (
    ServingEngine,
    TieredEngine,
    assign_block_table,
    decode_attn_paged,
    make_paged_kv_cache,
)

FLAGS = {  # variable -> (a value that is not off, the ROADMAP item that honours it)
    "MAGI_ATTENTION_GUARD": ("check", "A.13"),
    "MAGI_ATTENTION_CHAOS": ("decode_fault:times=1", "A.13"),
    "MAGI_ATTENTION_VALIDATE": ("plan", "A.18"),
    "MAGI_ATTENTION_NUMERICS": ("census", "A.15"),
}
HONOURED = ("MAGI_ATTENTION_GUARD", "MAGI_ATTENTION_CHAOS", "MAGI_ATTENTION_NUMERICS")
REFUSED = ("MAGI_ATTENTION_VALIDATE",)
BAD = {  # variable -> a value outside its domain
    "MAGI_ATTENTION_GUARD": "bogus",
    "MAGI_ATTENTION_CHAOS": "decode_fault:times=x",
    "MAGI_ATTENTION_VALIDATE": "everything",
    "MAGI_ATTENTION_NUMERICS": "full",
}
JAX_ACCESSOR = {
    "MAGI_ATTENTION_GUARD": jax_env.guard_mode,
    "MAGI_ATTENTION_CHAOS": jax_env.chaos_spec,
    "MAGI_ATTENTION_VALIDATE": jax_env.validate_mode,
    "MAGI_ATTENTION_NUMERICS": jax_env.numerics_mode,
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)


def _engine():
    return ServingEngine(num_pages=4, num_kv_heads=2, head_dim=16, page_size=8, max_seqs=2,
                         dtype=torch.float32, device="cpu")


def _tiered():
    return TieredEngine(num_pages=4, num_kv_heads=2, head_dim=16, page_size=8, max_seqs=2,
                        dtype=torch.float32, devices=["cpu"] * 2)


def _decode():
    cache = make_paged_kv_cache(3, 8, 2, 16, max_seqs=1, max_pages_per_seq=2,
                                dtype=torch.float32, device="cpu")
    assign_block_table(cache, 0, [1, 2], keep_len=5)
    return decode_attn_paged(torch.ones((1, 4, 16)), cache, torch.zeros(1, dtype=torch.int32))


ENTRY_POINTS = {
    "check_flag_comb": interface.check_flag_comb,
    "ServingEngine": _engine,
    "TieredEngine": _tiered,
    "decode_attn_paged": _decode,
}


def _result(x):
    """What an entry point returns, in a form that compares by value."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(t.numpy() for t in x)
    return (type(x).__name__, x.allocator.occupancy() if hasattr(x, "allocator") else
            [(r.devices, r.engine.allocator.occupancy()) for r in x.replicas])


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("name", REFUSED)
def test_each_flag_is_refused_at_each_entry_point(name, entry, monkeypatch):
    ENTRY_POINTS[entry]()  # unset: runs
    value, item = FLAGS[name]
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=rf"{entry}: {name}=.*ROADMAP {item}"):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("name", HONOURED)
def test_guard_and_chaos_are_honoured_at_each_entry_point(name, entry, monkeypatch):
    """Guard ``check`` with nothing to catch, a chaos clause with no site
    at these entry points and the census: each runs and returns what it
    returns unset (the decode's out and lse bit for bit)."""
    want = _result(ENTRY_POINTS[entry]())
    monkeypatch.setenv(name, FLAGS[name][0])
    got = _result(ENTRY_POINTS[entry]())
    if isinstance(want, tuple) and want and isinstance(want[0], np.ndarray):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    else:
        assert got == want


@pytest.mark.parametrize("name", ["MAGI_ATTENTION_GUARD", "MAGI_ATTENTION_VALIDATE",
                                  "MAGI_ATTENTION_NUMERICS"])
def test_off_is_accepted(name, monkeypatch):
    monkeypatch.setenv(name, "off")
    interface.check_flag_comb()
    _engine()


@pytest.mark.parametrize("name", sorted(BAD))
def test_a_bad_value_raises_the_jax_message(name, monkeypatch):
    monkeypatch.setenv(name, BAD[name])
    with pytest.raises(ValueError) as want:
        JAX_ACCESSOR[name]()
    with pytest.raises(ValueError) as got:
        interface.check_flag_comb()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "decode_fault:times=2", "corrupt_partial:site=merged,value=finite:8.0;pool_exhaust",
    "straggler:hop=2,delay=4", "cache_io_error:op=store,times=0", "bogus", "pool_exhaust:times=1",
    "corrupt_partial:value=nan", "corrupt_cast:value=finite:-1", "corrupt_cast:value=zero",
    "alloc_fail:times", "straggler:delay=0", "corrupt_partial:site=host,field=all",
    "cache_io_error:op=delete",
])
def test_chaos_grammar_matches_jax(spec):
    """The port's parser accepts what JAX's does, into the same clauses, and
    refuses the rest with the same message."""
    try:
        want = jax_parse_chaos_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_chaos_spec(spec)
        assert str(got.value) == str(e)
        return
    got = parse_chaos_spec(spec)
    fields = ("kind", "site", "field", "value", "rank", "seed", "hop", "delay", "op", "times")
    assert [[getattr(c, f) for f in fields] for c in got] == \
        [[getattr(c, f) for f in fields] for c in want]


@pytest.mark.parametrize("name,keyed", [("MAGI_ATTENTION_GUARD", True),
                                        ("MAGI_ATTENTION_CHAOS", True),
                                        ("MAGI_ATTENTION_NUMERICS", True),
                                        ("MAGI_ATTENTION_VALIDATE", False)])
def test_fingerprint_folds_guard_chaos_numerics(name, keyed, monkeypatch):
    before = interface.flags_fingerprint()
    monkeypatch.setenv(name, FLAGS[name][0])
    assert (interface.flags_fingerprint() != before) == keyed
    # the JAX package keys the same three and leaves validate out
    monkeypatch.delenv(name)
    jax_before = jax_env.flags_fingerprint()
    monkeypatch.setenv(name, FLAGS[name][0])
    assert (jax_env.flags_fingerprint() != jax_before) == keyed


def test_accessors_read_what_jax_reads(monkeypatch):
    for name, (value, _item) in FLAGS.items():
        monkeypatch.setenv(name, value)
    assert (env.guard_mode(), env.chaos_spec(), env.validate_mode(), env.numerics_mode()) == \
        (jax_env.guard_mode(), jax_env.chaos_spec(), jax_env.validate_mode(),
         jax_env.numerics_mode())
    assert np.array_equal(env.GUARD_MODES, jax_env.GUARD_MODES)
