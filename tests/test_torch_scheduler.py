"""The token-budget scheduler against the JAX package's on the CPU: the same
request traces through JAX ``Scheduler`` and the port's, under
``MAGI_ATTENTION_UNIFIED_TICK`` ``off``, ``on`` and ``auto``. The
``StepReport``s must be identical field for field, each request's outputs
within the float32 row of ``DEFAULT_BUDGETS``; the port's schedule must not
depend on the mode, and an ``on`` tick makes at most one engine call.
Plus the admission order, the too-long rejection, eviction and requeue,
decode-pressure preemption, a failed admission that evicted (the JAX
package's ``tests/test_serving/test_scheduler.py`` and
``test_unified_tick.py`` scenarios), and the launch census."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.serving import Request as JaxRequest
from magiattention_tpu.serving import Scheduler as JaxScheduler
from magiattention_tpu.serving import ServingEngine as JaxEngine
from magiattention_tpu.telemetry.numerics import (
    DEFAULT_BUDGETS,
    assert_within_budget,
    divergence_report,
)
from magiattention_tpu_torch.serving import Request, Scheduler, ServingEngine, StepReport
from magiattention_tpu_torch.serving.scheduler import QUEUED
from tests.torch_jax_backend import jax_backend

HQ, HK, D = 4, 2, 16
BUDGET = DEFAULT_BUDGETS["float32"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    jax_backend(monkeypatch)
    # both packages on the same split count (JAX's tick tuner would pick its own)
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "2")
    monkeypatch.delenv("MAGI_ATTENTION_CASCADE", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_PREFILL_CHUNK", raising=False)


def _arrays(rng, rid, prompt_len, gen, priority=0, tokens=None):
    mk = lambda n, h, pos=False: (rng.uniform(0.5, 1.5, (n, h, D)) if pos  # noqa: E731
                                   else rng.standard_normal((n, h, D))).astype(np.float32)
    return dict(rid=rid, prompt_q=mk(prompt_len, HQ), prompt_k=mk(prompt_len, HK),
                prompt_v=mk(prompt_len, HK, True), decode_q=mk(gen, HQ),
                decode_k=mk(gen, HK), decode_v=mk(gen, HK, True),
                tokens=tokens, priority=priority)


def _request(pkg, spec):
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    cls = JaxRequest if pkg == "jax" else Request
    return cls(**{k: conv(v) if isinstance(v, np.ndarray) else v for k, v in spec.items()})


def _drive(pkg, engine_kw, sched_kw, submissions, steps=None):
    """Run one scheduler: ``submissions`` maps a step index to the request
    specs submitted before it; returns the scheduler, the reports and each
    tick's engine-call labels."""
    if pkg == "jax":
        eng = JaxEngine(num_kv_heads=HK, head_dim=D, dtype=jnp.float32, **engine_kw)
        sched = JaxScheduler(eng, **sched_kw)
    else:
        eng = ServingEngine(num_kv_heads=HK, head_dim=D, dtype=torch.float32, device="cpu",
                            **engine_kw)
        sched = Scheduler(eng, **sched_kw)
    reports, programs = [], []
    i = 0
    while i in submissions or not sched.done:
        if steps is not None and i >= steps:
            break
        for spec in submissions.get(i, ()):
            sched.submit(_request(pkg, spec))
        reports.append(sched.step())
        programs.append(list(sched._tick_programs))
        i += 1
    return sched, reports, programs


def _report_fields(rep):
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(StepReport)}


def _twin(engine_kw, sched_kw, submissions, steps=None):
    """The same run through both packages: identical reports, outputs
    within the budget. Returns the port's run."""
    jsched, jreps, _ = _drive("jax", engine_kw, sched_kw, submissions, steps)
    sched, reps, programs = _drive("torch", engine_kw, sched_kw, submissions, steps)
    assert [_report_fields(r) for r in reps] == [_report_fields(r) for r in jreps]
    assert set(sched._finished) == set(jsched._finished)
    for rid, st in sched._finished.items():
        jst = jsched._finished[rid]
        assert (st.status, st.evictions, st.prefix_len, st.tokens_done) == (
            jst.status, jst.evictions, jst.prefix_len, jst.tokens_done), rid
        pairs = list(zip(jst.decode_outs, st.decode_outs))
        if jst.prefill_out_tail is not None:
            pairs.append((jst.prefill_out_tail, st.prefill_out_tail))
        assert len(st.decode_outs) == len(jst.decode_outs)
        for ref, got in pairs:
            assert_within_budget(divergence_report(np.asarray(ref), got.numpy()), BUDGET,
                                 where=f"request {rid}")
    return sched, reps, programs


def _mixed_trace(ps):
    """The JAX package's unified-tick trace: a chunked prompt, a higher
    priority one, a shared-prefix pair through token ids, a zero-gen one."""
    rng = np.random.default_rng(11)
    shared = [int(t) for t in rng.integers(0, 50, 2 * ps)]
    specs = [
        _arrays(rng, 1, 20, 4),
        _arrays(rng, 2, 13, 3, priority=1),
        _arrays(rng, 3, 2 * ps + 6, 5, tokens=tuple(shared + [1, 2, 3, 4, 5, 6])),
        _arrays(rng, 4, 2 * ps + 4, 5, tokens=tuple(shared + [7, 8, 9, 10])),
        _arrays(rng, 5, 3, 0),
    ]
    engine_kw = dict(num_pages=96, max_seqs=8, max_pages_per_seq=24, page_size=ps)
    return engine_kw, dict(token_budget=24, chunk=8), {0: specs}


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_mixed_trace_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
    sched, reps, programs = _twin(*_mixed_trace(16))
    launches = [len(p) for p in programs]
    if mode == "on":
        assert all(n <= 1 for n in launches), launches
        assert all(p[0].startswith("tick[r=") for p in programs if p)
    elif mode == "off":
        assert max(launches) > 1
    else:
        assert all(n <= 2 for n in launches), launches
    assert all(sched.result(r).status == "finished" for r in range(1, 6))


def test_schedule_is_the_same_in_every_mode(monkeypatch):
    """``on`` and ``auto`` reproduce ``off``'s schedule and its outputs
    within the budget (page size 8: more ticks with cascade pairs)."""
    runs = {}
    for mode in ("off", "on", "auto"):
        monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
        runs[mode] = _drive("torch", *_mixed_trace(8))
    base = [_report_fields(r) for r in runs["off"][1]]
    for mode in ("on", "auto"):
        sched, reps, _ = runs[mode]
        assert [_report_fields(r) for r in reps] == base, mode
        for rid, st in runs["off"][0]._finished.items():
            for ref, got in zip(st.decode_outs, sched._finished[rid].decode_outs):
                assert_within_budget(divergence_report(ref.numpy(), got.numpy()), BUDGET)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_priority_admission_order(mode, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
    rng = np.random.default_rng(2)
    specs = [_arrays(rng, 0, 16, 1, priority=0), _arrays(rng, 1, 16, 1, priority=5)]
    sched, reps, _ = _twin(dict(num_pages=4, max_seqs=1, max_pages_per_seq=4, page_size=8),
                           dict(token_budget=64), {0: specs})
    assert reps[0].admitted == (1,)
    assert set(sched._finished) == {0, 1}


def test_too_long_rejected_and_the_rest_finishes():
    rng = np.random.default_rng(3)
    specs = [_arrays(rng, 0, 80, 1), _arrays(rng, 1, 8, 1),
             _arrays(rng, 2, 24, 9)]  # 2: prompt fits, prompt + decode does not
    sched, reps, _ = _twin(dict(num_pages=8, max_seqs=2, max_pages_per_seq=4, page_size=8),
                           dict(token_budget=64), {0: specs})
    assert reps[0].rejected == (0, 2)
    assert sched.result(0).status == sched.result(2).status == "rejected"
    assert len(sched.result(1).decode_outs) == 1


@pytest.mark.parametrize("mode", ["off", "on"])
def test_eviction_requeues_and_replays(mode, monkeypatch):
    """One resident at a time: a higher-priority arrival evicts the decoding
    request, which is requeued and replays from its prompt."""
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
    rng = np.random.default_rng(7)
    r0, r1 = _arrays(rng, 0, 16, 4, priority=0), _arrays(rng, 1, 16, 1, priority=5)
    sched, reps, _ = _twin(dict(num_pages=16, max_seqs=1, max_pages_per_seq=8, page_size=8),
                           dict(token_budget=32), {0: [r0], 2: [r1]})
    st0 = sched.result(0)
    assert st0.evictions == 1 and len(st0.decode_outs) == 4
    assert st0.slo_start > st0.submitted_at
    assert any(1 in r.admitted for r in reps)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_decode_pressure_preempts_and_drains(mode, monkeypatch):
    """Two prompts that fill the pool: the first decode growth finds it
    empty, the youngest lowest-priority member is preempted and replays
    once the other finishes (the headroom watermark defers it, so no
    ping-pong)."""
    monkeypatch.setenv("MAGI_ATTENTION_UNIFIED_TICK", mode)
    rng = np.random.default_rng(9)
    specs = [_arrays(rng, 0, 16, 4), _arrays(rng, 1, 16, 4)]
    sched, reps, _ = _twin(dict(num_pages=4, max_seqs=2, max_pages_per_seq=4, page_size=8),
                           dict(token_budget=64), {0: specs})
    assert sched.result(1).evictions == 1 and sched.result(0).evictions == 0
    assert all(sched.result(r).status == "finished" for r in (0, 1))
    assert sched.engine.allocator.pages_in_use == 0


def test_failed_admission_with_evictions_requeues_victims():
    """An admission attempt that evicts a lower-priority resident and still
    fails must requeue the victim (it would dangle with a released slot)."""
    rng = np.random.default_rng(13)
    engine_kw = dict(num_pages=8, max_seqs=4, max_pages_per_seq=8, page_size=8)
    subs = {0: [_arrays(rng, 0, 24, 6, priority=5), _arrays(rng, 1, 24, 4, priority=0)],
            2: [_arrays(rng, 2, 48, 2, priority=3)]}
    sched, _, _ = _twin(engine_kw, dict(token_budget=64), subs, steps=3)
    st1 = next(st for st in sched._queue if st.rid == 1)
    assert st1.status == QUEUED and st1.slot is None and st1.evictions == 1
    assert 1 not in sched._active
    sched.run()
    assert all(sched.result(r).status == "finished" for r in (0, 1, 2))


def test_launch_census_is_armed(monkeypatch):
    """A launch path that records an engine call the tick census did not
    predict raises."""
    engine_kw, sched_kw, subs = _mixed_trace(16)
    eng = ServingEngine(num_kv_heads=HK, head_dim=D, dtype=torch.float32, device="cpu",
                        **engine_kw)
    sched = Scheduler(eng, **sched_kw)
    for spec in subs[0]:
        sched.submit(_request("torch", spec))
    real = sched._run_prefill_chunk

    def twice(st, budget):
        n = real(st, budget)
        sched._tick_programs.append("prefill[extra]")
        return n

    monkeypatch.setattr(sched, "_run_prefill_chunk", twice)
    with pytest.raises(AssertionError, match="census drift"):
        sched.step()


def test_knobs_apply_atomically():
    eng = ServingEngine(num_pages=8, num_kv_heads=HK, head_dim=D, page_size=8,
                        dtype=torch.float32, device="cpu")
    sched = Scheduler(eng, token_budget=32)
    assert sched.apply_knobs(cascade="OFF", decode_splits=2) == {"cascade": "off",
                                                                 "decode_splits": 2}
    assert eng.cascade_override == "off" and eng.decode_splits_override == 2
    with pytest.raises(ValueError, match="unknown scheduler knob"):
        sched.apply_knobs(token_budget=8, bogus=1)
    with pytest.raises(ValueError):
        sched.apply_knobs(token_budget=8, cascade="sometimes")
    assert sched.knobs()["token_budget"] == 32


def test_requests_must_lie_on_the_engines_device():
    eng = ServingEngine(num_pages=8, num_kv_heads=HK, head_dim=D, page_size=8,
                        dtype=torch.float32, device="cpu")
    spec = _arrays(np.random.default_rng(0), 0, 4, 1)
    req = _request("torch", spec)
    req.decode_q = torch.empty(1, HQ, D, device="meta")
    with pytest.raises(ValueError, match="decode_q is on meta"):
        Scheduler(eng).submit(req)
