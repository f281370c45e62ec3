"""``utils/instrument.py`` of the port against the JAX package's: the
gating of the instrumentation by telemetry and profile mode (the same
answers from both packages), the free off path (one shared null context),
host spans, and ``switch_profile``'s profile-mode default, re-entrancy and
exception safety over ``torch.profiler`` (a fake profiler records the
session's calls; one case records a real CPU session and reads its Chrome
trace)."""

import json
import os

import pytest
import torch

from magiattention_tpu import telemetry as jax_telemetry
from magiattention_tpu.utils import instrument as jax_instrument
from magiattention_tpu_torch import env, telemetry
from magiattention_tpu_torch.utils import instrument


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_PROFILE_MODE", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_TELEMETRY", raising=False)
    for t in (telemetry, jax_telemetry):
        t.set_enabled(None)
        t.reset()
    yield
    for t in (telemetry, jax_telemetry):
        t.set_enabled(None)
        t.reset()


class FakeProfile:
    """Stands in for ``torch.profiler.profile``: records its calls into
    ``calls`` and writes a small JSON file on export."""

    calls: list = []
    fail_start = fail_stop = False

    def __init__(self, activities=None):
        self.activities = activities

    def __enter__(self):
        if FakeProfile.fail_start:
            raise RuntimeError("profiler already active")
        FakeProfile.calls.append("start")
        return self

    def __exit__(self, *exc):
        if FakeProfile.fail_stop:
            raise RuntimeError("flush failed")
        FakeProfile.calls.append("stop")
        return False

    def export_chrome_trace(self, path):
        FakeProfile.calls.append(("export", os.path.dirname(path)))
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.fixture
def fake_profiler(monkeypatch):
    FakeProfile.calls = []
    FakeProfile.fail_start = FakeProfile.fail_stop = False
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    return FakeProfile


@pytest.mark.parametrize("tel", [None, True, False])
@pytest.mark.parametrize("profile", [None, "0", "1"])
def test_instrumentation_active_agrees_with_jax(tel, profile, monkeypatch):
    if profile is not None:
        monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", profile)
    telemetry.set_enabled(tel)
    jax_telemetry.set_enabled(tel)
    assert instrument.instrumentation_active() == jax_instrument.instrumentation_active()
    assert instrument.instrumentation_active() == (bool(tel) or profile == "1")


def test_named_scope_off_is_one_shared_null_context():
    """The off path does no work: every scope is the same null context."""
    a, b = instrument.named_scope("magi_decode_attn"), instrument.named_scope("magi_other")
    assert a is b and a is instrument._NULL_SCOPE
    with a:
        pass
    with a:  # re-entered: a null context is reusable
        assert not instrument.trace_session_active()


@pytest.mark.parametrize("switch", ["telemetry", "profile_mode", "session"])
def test_named_scope_marks_a_range_while_active(switch, monkeypatch, fake_profiler, tmp_path):
    ranges = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: _Recorded(name, ranges))
    if switch == "telemetry":
        telemetry.set_enabled(True)
    elif switch == "profile_mode":
        monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    with (instrument.switch_profile(str(tmp_path)) if switch == "session"
          else _nothing()):
        scope = instrument.named_scope("magi_prefill_attn")
        assert scope is not instrument._NULL_SCOPE
        with scope:
            pass
    assert ranges == ["magi_prefill_attn"]


class _Recorded:
    def __init__(self, name, into):
        self.name, self.into = name, into

    def __enter__(self):
        self.into.append(self.name)

    def __exit__(self, *exc):
        return False


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_disabled_decorator_is_identity():
    def f(x):
        return x + 1

    assert instrument.instrument_trace(f) is f
    assert instrument.instrument_trace(name="named")(f) is f
    assert jax_instrument.instrument_trace(f) is f  # as the JAX package


def test_enabled_decorator_wraps_records_and_goes_quiet():
    telemetry.set_enabled(True)

    @instrument.instrument_trace(name="traced-fn")
    def f(x):
        return x * 2

    assert f.__wrapped__ is not None and f(3) == 6
    assert any(e["name"] == "traced-fn" for e in telemetry.get_event_buffer().events())
    n = len(telemetry.get_event_buffer())
    telemetry.set_enabled(False)
    assert f(2) == 4  # still a function, now silent
    assert len(telemetry.get_event_buffer()) == n


@pytest.mark.parametrize("enabled", [False, True])
def test_add_trace_event_records_only_while_enabled(enabled):
    telemetry.set_enabled(enabled)
    with instrument.add_trace_event("region"):
        pass
    names = [e["name"] for e in telemetry.get_event_buffer().events()]
    assert names == (["region"] if enabled else [])


def test_spans_survive_exceptions():
    """A raising region still lands in the trace: it is the one being
    debugged."""
    telemetry.set_enabled(True)
    with pytest.raises(RuntimeError):
        with instrument.add_trace_event("boom-ctx"):
            raise RuntimeError("x")

    @instrument.instrument_trace(name="boom-fn")
    def f():
        raise RuntimeError("y")

    with pytest.raises(RuntimeError):
        f()
    names = [e["name"] for e in telemetry.get_event_buffer().events()]
    assert "boom-ctx" in names and "boom-fn" in names


def test_switch_profile_noop_without_flag(fake_profiler):
    with instrument.switch_profile() as sess:
        assert not instrument.trace_session_active()
    assert fake_profiler.calls == [] and sess.path is None


def test_switch_profile_honours_profile_mode_default(monkeypatch, tmp_path, fake_profiler):
    """``MAGI_ATTENTION_PROFILE_MODE=1`` makes the bare ``switch_profile()``
    a session into ``env.trace_dir()``."""
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path / "tr"))
    with instrument.switch_profile() as sess:
        assert instrument.trace_session_active()
    assert fake_profiler.calls == ["start", "stop", ("export", str(tmp_path / "tr"))]
    assert env.trace_dir() == str(tmp_path / "tr")
    assert sess.path.startswith(str(tmp_path / "tr")) and os.path.exists(sess.path)
    assert not instrument.trace_session_active()


def test_switch_profile_explicit_dir_wins(monkeypatch, tmp_path, fake_profiler):
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    with instrument.switch_profile(str(tmp_path / "explicit")):
        pass
    assert fake_profiler.calls == ["start", "stop", ("export", str(tmp_path / "explicit"))]


def test_switch_profile_stops_on_exception(tmp_path, fake_profiler):
    with pytest.raises(RuntimeError):
        with instrument.switch_profile(str(tmp_path)):
            raise RuntimeError("boom")
    assert fake_profiler.calls[:2] == ["start", "stop"]
    assert not instrument.trace_session_active()


def test_switch_profile_nested_session_is_noop(tmp_path, fake_profiler):
    """A session inside an active one warns and records nothing; the outer
    one is stopped exactly once."""
    with instrument.switch_profile(str(tmp_path / "outer")):
        assert instrument.trace_session_active()
        with instrument.switch_profile(str(tmp_path / "inner")) as inner:
            pass
        assert instrument.trace_session_active() and inner.path is None
    assert not instrument.trace_session_active()
    assert fake_profiler.calls == ["start", "stop", ("export", str(tmp_path / "outer"))]


def test_switch_profile_start_failure_degrades(tmp_path, fake_profiler):
    fake_profiler.fail_start = True
    ran = []
    with instrument.switch_profile(str(tmp_path)) as sess:
        ran.append(1)  # the body still runs
    assert ran == [1] and fake_profiler.calls == [] and sess.path is None
    assert not instrument.trace_session_active()


def test_switch_profile_stop_failure_never_masks_body_exception(tmp_path, fake_profiler):
    fake_profiler.fail_stop = True
    with pytest.raises(ValueError, match="body error"):
        with instrument.switch_profile(str(tmp_path)):
            raise ValueError("body error")
    assert not instrument.trace_session_active()  # the guard is released


def test_switch_profile_reusable_after_exception(tmp_path, fake_profiler):
    with pytest.raises(RuntimeError):
        with instrument.switch_profile(str(tmp_path / "a")):
            raise RuntimeError
    with instrument.switch_profile(str(tmp_path / "b")):
        pass
    assert fake_profiler.calls == ["start", "stop", ("export", str(tmp_path / "a")),
                                   "start", "stop", ("export", str(tmp_path / "b"))]


def test_a_real_session_writes_the_ranges(monkeypatch, tmp_path):
    """A ``torch.profiler`` session on the CPU under profile mode: the
    Chrome trace it writes holds each named scope entered inside it, as a
    ``user_annotation`` range around the ops run in it."""
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TRACE_DIR", str(tmp_path))
    x = torch.ones(64, 64)
    with instrument.switch_profile() as sess:
        with instrument.named_scope("magi_stage0_kernel"):
            y = x @ x
        with instrument.named_scope("magi_stage0_lse_merge"):
            y = y + 1
    assert float(y[0, 0]) == 65.0
    with open(sess.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"magi_stage0_kernel", "magi_stage0_lse_merge"} <= names


def test_named_scope_sites_carry_the_jax_labels():
    """Each label of the JAX package's named scopes has its twin in the
    port's source (the profiler's device traces read the same names)."""
    import re

    import magiattention_tpu
    import magiattention_tpu_torch

    def labels(pkg, pattern):
        root = os.path.dirname(pkg.__file__)
        found = set()
        for d, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(d, f)) as fh:
                        found |= set(re.findall(pattern, fh.read()))
        return found

    jax_labels = labels(magiattention_tpu, r'named_scope\(f?"(magi_[a-z0-9_{}]+)"\)')
    # the port also passes a label through a helper (models/llama.py's row_output)
    port_labels = labels(magiattention_tpu_torch, r'f?"(magi_[a-z0-9_{}]+)"')
    # magi_hop_reverse: a scope of the JAX hops' hand-written transpose, which
    # the port's autograd Function computes as cast_transpose
    assert jax_labels - {"magi_hop_reverse"} <= port_labels
