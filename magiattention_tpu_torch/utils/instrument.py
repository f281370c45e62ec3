"""Tracing and profiling instrumentation: the port's twin of the JAX
package's ``utils/instrument.py``.

- :func:`named_scope` marks a region of the program (a stage's cast, its
  kernel, the LSE merge, a decode step's attention) as a
  ``torch.profiler.record_function`` range and, on a machine with a card, an
  NVTX range, so that a profiler's device trace shows ``magi_stage0_cast``
  around the launches it encloses. JAX's ``named_scope`` acts at trace time
  and costs nothing at run time; PyTorch runs eagerly, so a range costs a
  few host microseconds each time it is entered. The port's scope is
  therefore gated: while profile mode (``MAGI_ATTENTION_PROFILE_MODE``) and
  telemetry are off and no :func:`switch_profile` session records, it
  returns one shared null context that does no work.
- :func:`switch_profile` is a ``torch.profiler`` session over CPU and CUDA
  activity that writes a Chrome trace into a directory (by default, with
  profile mode on, ``env.trace_dir()``); re-entrant and exception-safe, as
  JAX's ``jax.profiler`` wrapper is.
- :func:`instrument_trace` and :func:`add_trace_event` mark a region and,
  with telemetry on, record it as a host span (``telemetry/events.py``);
  both are free passthroughs while instrumentation is off, with the JAX
  package's gating: the decorator decides when it decorates, the context
  manager each time it is entered.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("magiattention_tpu_torch.utils.instrument")

_NULL_SCOPE = contextlib.nullcontext()  # what named_scope returns while off

# torch.profiler keeps one session per process: this guard makes
# switch_profile re-entrant (a nested session warns and does nothing) and
# stops the session exactly once.
_session_lock = threading.Lock()
_session_dir: str | None = None
_session_serial = itertools.count()


def trace_session_active() -> bool:
    """Is a :func:`switch_profile` session recording?"""
    return _session_dir is not None


def instrumentation_active() -> bool:
    """Should regions be marked and spans recorded now? Telemetry or profile
    mode on, as in the JAX package, or a :func:`switch_profile` session
    recording."""
    if _session_dir is not None:
        return True
    from .. import env, telemetry

    return telemetry.enabled() or env.is_profile_mode()


@contextlib.contextmanager
def _ranges(name: str):
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def named_scope(name: str):
    """A context marking its region ``name`` in profiler traces while
    instrumentation is active (:func:`instrumentation_active`); otherwise the
    one shared null context, which does no work."""
    if not instrumentation_active():
        return _NULL_SCOPE
    return _ranges(name)


def instrument_trace(fn: Optional[Callable] = None, *, name: str | None = None):
    """Decorator: each call of the function in :func:`named_scope` and, with
    telemetry on, a host span. While instrumentation is off when it
    decorates, it returns the function itself (``instrument_trace(f) is
    f``); a function decorated while it was on checks again at each call."""

    def deco(f):
        if not instrumentation_active():
            return f
        scope = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not instrumentation_active():
                return f(*args, **kwargs)
            from .. import telemetry

            t0 = time.perf_counter()
            try:
                with _ranges(scope):
                    return f(*args, **kwargs)
            finally:
                # recorded when f raises too: the span of a failing region
                # is the one being debugged
                telemetry.record_event(scope, t0, time.perf_counter() - t0)

        return wrapper

    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def add_trace_event(name: str):
    """A region in :func:`named_scope` and, with telemetry on, a host span;
    nothing while instrumentation is off."""
    if not instrumentation_active():
        yield
        return
    from .. import telemetry

    t0 = time.perf_counter()
    try:
        with _ranges(name):
            yield
    finally:
        telemetry.record_event(name, t0, time.perf_counter() - t0)


class ProfileSession:
    """What :func:`switch_profile` yields: ``path`` is the Chrome trace it
    wrote, set when the session stops (None for a session that did not
    record)."""

    def __init__(self, trace_dir: str | None):
        self.trace_dir = trace_dir
        self.path: str | None = None


@contextlib.contextmanager
def switch_profile(trace_dir: str | None = None):
    """A ``torch.profiler`` session over CPU (and, with a card, CUDA)
    activity around the body, written as a Chrome trace
    ``magi_trace_<pid>_<n>.json`` into ``trace_dir``. ``trace_dir=None``
    follows ``MAGI_ATTENTION_PROFILE_MODE``: on, the trace goes into
    ``env.trace_dir()`` (``MAGI_ATTENTION_TRACE_DIR``); off, the session is
    a no-op. Yields a :class:`ProfileSession`.

    Re-entrant and exception-safe: a session inside an active one warns and
    records nothing (the outer one goes on and is stopped once); the body's
    exception propagates unchanged, the session is still stopped, and a
    failure to stop or write never masks it."""
    global _session_dir
    from .. import env

    if trace_dir is None and env.is_profile_mode():
        trace_dir = env.trace_dir()
    session = ProfileSession(trace_dir)
    if trace_dir is None:
        yield session
        return
    import torch

    prof = None
    with _session_lock:
        if _session_dir is not None:
            logger.warning("switch_profile(%r): a session into %r is already recording; "
                           "torch.profiler keeps one session a process, so this nested one "
                           "records nothing (the outer one goes on)", trace_dir, _session_dir)
        else:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
                _session_dir = trace_dir
            except Exception as exc:  # a session this module cannot see, a profiler fault
                logger.warning("switch_profile(%r): the profiler did not start (%r); going on "
                               "without a session", trace_dir, exc)
                prof = None
    try:
        yield session
    finally:
        if prof is not None:
            with _session_lock:
                _session_dir = None
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(trace_dir, exist_ok=True)
                    path = os.path.join(
                        trace_dir, f"magi_trace_{os.getpid()}_{next(_session_serial)}.json")
                    prof.export_chrome_trace(path)
                    session.path = path
                except Exception as exc:  # never mask the body's exception
                    logger.warning("switch_profile(%r): stopping or writing the trace failed "
                                   "(%r); the trace may be missing", trace_dir, exc)
