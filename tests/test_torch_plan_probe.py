"""``PlanReuseProbe`` riding the port's ``Scheduler`` ticks, against the JAX
package's probe fed the same hook calls (its
``tests/test_serving/test_plan_probe.py`` at its sizes: head_dim 16, 2 kv
heads, 4 q heads, page 8): the probe resolves the masks JAX's resolves,
changes no output, and batched decode ticks within the window resolve one
key. The scheduler under the probe is held against JAX's by
``tests/test_torch_scheduler.py``."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from magiattention_tpu.serving import PlanReuseProbe as JaxProbe
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.serving import PlanReuseProbe, Request, Scheduler, ServingEngine
from tests.torch_jax_backend import jax_backend

D, HK, HQ, PS = 16, 2, 4, 8
GEOM = dict(num_kv_heads=HK, head_dim=D, page_size=PS, num_pages=96, max_seqs=8,
            max_pages_per_seq=16)


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The default group the probe makes when none is initialised, taken
    down after the module so the worker's next tests find none."""
    made = not dist.is_initialized()
    yield
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    jax_backend(monkeypatch)
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "1")
    interface.clear_cache()
    yield
    interface.clear_cache()


def _specs(seed, n, prompt_len, gen):
    rng = np.random.default_rng(seed)
    mk = lambda t, h: rng.standard_normal((t, h, D)).astype(np.float32)  # noqa: E731
    return [dict(rid=i, prompt_q=mk(prompt_len, HQ), prompt_k=mk(prompt_len, HK),
                 prompt_v=mk(prompt_len, HK), decode_q=mk(gen, HQ), decode_k=mk(gen, HK),
                 decode_v=mk(gen, HK)) for i in range(n)]


def _drain(specs, probe=None):
    sched = Scheduler(ServingEngine(dtype=torch.float32, device="cpu", **GEOM), plan_probe=probe)
    for spec in specs:
        sched.submit(Request(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                for k, v in spec.items()}))
    return sched, sched.run(max_steps=50)


def _record_keys(monkeypatch, iface, calls, plan):
    """Record the mask of every key a probe resolves through ``iface`` (the
    arguments before the group), planning it only when ``plan``; a varlen
    key's own flex key is not the probe's call."""
    depth = [0]
    for kind, n_mask in (("magi_attn_flex_key", 5), ("magi_attn_varlen_key", 2)):
        real = getattr(iface, kind)

        def fake(*a, _kind=kind, _n=n_mask, _real=real, **kw):
            if not depth[0]:
                calls.append((_kind, tuple(map(str, a[:_n])), kw.get("causal")))
            depth[0] += 1
            try:
                return _real(*a, **kw) if plan else None
            finally:
                depth[0] -= 1

        monkeypatch.setattr(iface, kind, fake)


def test_probe_resolves_jax_shapes_and_changes_no_output(monkeypatch):
    """The port's probe on a scheduler drain, each hook call also handed to
    JAX's probe: both resolve the same masks (prefill chunks as flex keys,
    decode batches as padded varlen keys), their counts agree, and the
    drain's reports and outputs equal a drain without a probe."""
    from magiattention_tpu.api import interface as jax_interface

    specs = _specs(0, 3, prompt_len=12, gen=3)
    base, base_reports = _drain(specs)
    got, want = [], []
    _record_keys(monkeypatch, interface, got, plan=True)
    _record_keys(monkeypatch, jax_interface, want, plan=False)
    probe, jax_probe = PlanReuseProbe(decode_window=11), JaxProbe(decode_window=11)
    for hook in ("note_prefill", "note_decode", "on_step_end"):
        ours, theirs = getattr(probe, hook), getattr(jax_probe, hook)
        monkeypatch.setattr(probe, hook, lambda *a, _o=ours, _t=theirs: (_o(*a), _t(*a)))
    sched, reports = _drain(specs, probe)
    assert reports == base_reports
    for rid in range(3):
        assert all(torch.equal(a, b) for a, b in zip(sched.result(rid).decode_outs,
                                                    base.result(rid).decode_outs))
    assert got == want and len(got) == probe.stats.total_resolutions
    assert dataclasses.astuple(probe.stats) == dataclasses.astuple(jax_probe.stats)
    assert probe.stats.prefill_resolutions >= 3 and probe.stats.decode_resolutions >= 3


def test_probe_batched_decode_shares_one_key(monkeypatch):
    """Prompts long enough that every context pins at the window: every
    decode tick resolves the same packed mask, the same cached key."""
    keys = []
    real = interface.magi_attn_varlen_key

    def record(*a, **kw):
        keys.append(real(*a, **kw))
        return keys[-1]

    monkeypatch.setattr(interface, "magi_attn_varlen_key", record)
    probe = PlanReuseProbe(decode_window=11)
    _drain(_specs(1, 2, prompt_len=16, gen=4), probe)
    assert len(keys) == probe.stats.decode_resolutions == 4
    assert len(set(keys)) == 1 and interface.get_runtime_mgr(keys[0]) is not None
    assert keys[0].device == "cpu" and keys[0].cp_size == 1


def test_probe_takes_a_callers_group():
    group = dist.group.WORLD if dist.is_initialized() else None
    probe = PlanReuseProbe(decode_window=11, cp_group=group)
    probe.note_prefill(0, 0, 12)
    assert probe.stats.prefill_resolutions == 1 and dist.get_world_size() == 1


def test_probe_rejects_bad_window():
    with pytest.raises(ValueError, match="decode_window"):
        PlanReuseProbe(decode_window=0)
