"""The port's autotuner (``magiattention_tpu_torch/tuning/autotuner.py``) and
its wiring, on the CPU.

- Twins of the JAX package's ``tests/test_tuning/test_autotune_wiring.py``
  that do not depend on TPU rungs: ``off`` restores the static rule, fixed
  tiles bypass the tuner, a repeat call hits the cache, an invalid mode is
  refused, a measured winner round-trips the disk cache, a model-sourced
  entry is upgraded, a pinned head_block degrades ``measure`` to the model,
  crashing candidates are survived and not retried forever,
  ``measure_failed`` is not persisted, a 3-argument ``measure_fn`` is
  refused, the key path consults the cache. Measure mode takes an injected
  ``measure_fn`` (or the real one, timing the plain versions on the CPU).
- The fault repaired first: ``flags_fingerprint`` keys
  ``MAGI_ATTENTION_AUTOTUNE`` and the card's name.
- The default decisions on the smoke's masks and geometries equal the rule
  they replace (density grid, head_block G, one split).
- The slice as a whole: ``flex_flash_attn_func`` under ``model`` and under
  ``measure`` (a timer that prefers the sparse grid) gives JAX's out and lse
  on the same float32 inputs within rtol 2e-4 / atol 2e-5 (the cp tests'
  tolerance); a ``ServingEngine`` prefill of two prompts and two decode
  steps under ``model`` gives JAX's engine's results within the same
  tolerance; a cp=2 keyed key takes rank 0's decision on both ranks though
  rank 1's cache directory holds another."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.ops import flex_flash_attn_func as jax_flex_flash_attn_func
from magiattention_tpu.serving import ServingEngine as JaxEngine
from magiattention_tpu_torch import telemetry, tuning
from magiattention_tpu_torch.api import interface
from magiattention_tpu_torch.models import LlamaConfig, resolve_harness_blocking
from magiattention_tpu_torch.ops import flex_attn as fa
from magiattention_tpu_torch.serving import ServingEngine, resolve_num_splits
from magiattention_tpu_torch.serving import make_paged_kv_cache, resolve_tick_splits
from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal
from magiattention_tpu_torch.tuning import (
    TuningRecord,
    get_tuning_cache,
    make_fingerprint,
    rank_candidates,
    reset_tuning_cache,
    select_block_config,
)
from magiattention_tpu_torch.tuning import autotuner
from tests.torch_jax_backend import jax_backend

RTOL, ATOL = 2e-4, 2e-5  # the cp tests' float32 tolerance
FLAGS = ("MAGI_ATTENTION_AUTOTUNE", "MAGI_ATTENTION_AUTOTUNE_CACHE_DIR",
         "MAGI_ATTENTION_HEAD_BLOCK", "MAGI_ATTENTION_GRID", "MAGI_ATTENTION_BLOCK_Q",
         "MAGI_ATTENTION_BLOCK_K", "MAGI_ATTENTION_DECODE_SPLITS", "MAGI_ATTENTION_KERNEL_BACKEND")
CAUSAL = ([(0, 4096)], [(0, 4096)], [1])
# the smoke's plan-reuse stream: (request, documents, the tier it resolves through)
CP_STREAM = (("A", (3000, 5000, 1500, 6000), "cold"), ("B", (2900, 4700, 1400, 5900), "bucket"),
             ("C", (2900, 4700, 1400, 5900), "exact"), ("D", (2900, 4700, 1400, 6000), "bucket"),
             ("E", (3072, 5120, 1536, 6144), "exact"), ("F", (7000, 7000, 2000), "cold"))


@pytest.fixture(autouse=True)
def _clean_tuner(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    reset_tuning_cache()
    yield
    reset_tuning_cache()


@pytest.fixture
def recording():
    telemetry.set_enabled(True)
    telemetry.reset()
    yield
    telemetry.set_enabled(None)
    telemetry.reset()


def _select(mask=CAUSAL, hq=8, hk=4, **kw):
    return select_block_config(*mask, hq, hk, head_dim=128, device="cpu", **kw)


def _top(mask=CAUSAL, hq=8, hk=4):
    return [c for c in rank_candidates(*mask, hq, hk, head_dim=128) if c.feasible][:3]


def test_mode_off_restores_static_rule(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "off")
    for mask in (CAUSAL, split_slices(varlen_block_causal(4096))):
        static = fa._static_block_config(mask[0], mask[1], 8, 4, head_dim=128)
        assert static == (64, 64, 2)
        assert fa.auto_block_config(mask[0], mask[1], 8, 4, attn_type_map=mask[2]) == static
        assert fa.auto_kernel_config(mask[0], mask[1], 8, 4,
                                     attn_type_map=mask[2]) == (*static, "row_major")
    d = _select(mode="off")
    assert (d.source, d.config, d.grid) == ("static", (64, 64, 2), "row_major")


def test_fixed_tiles_bypass_the_tuner(recording):
    qr, kr, ty = split_slices(varlen_block_causal(4096))
    assert fa.auto_kernel_config(qr, kr, 8, 4, attn_type_map=ty, fixed_block_q=64,
                                 fixed_block_k=64) == (64, 64, 2, "row_major")
    assert fa.auto_block_config(qr, kr, 8, 4, fixed_block_k=64) == (64, 64, 2)
    assert not any(k.startswith("magi_autotune") for k in telemetry.snapshot()["counters"])


def test_model_mode_repeat_call_hits_cache(recording):
    first, again = _select(mode="model"), _select(mode="model")
    assert first.kernel_config == again.kernel_config
    assert (first.cache_layer, again.cache_layer) == ("none", "memory")
    c = telemetry.snapshot()["counters"]
    assert c["magi_autotune_cache_misses_total"] == 1
    assert c["magi_autotune_cache_hits_total{layer=memory}"] == 1
    assert any(k.startswith("magi_autotune_choice{") for k in telemetry.snapshot()["gauges"])


def test_cache_hit_revalidates_feasibility():
    """A bucket-aliased hit whose winner the exact workload cannot launch
    (here a tile the build lacks) re-ranks, and leaves the resident record
    alone."""
    fp = make_fingerprint(*CAUSAL, 8, 4, head_dim=128, device="cpu")
    get_tuning_cache().put(fp, TuningRecord(block_q=128, block_k=128, head_block=2,
                                            source="measured", predicted_ms=1.0,
                                            measured_ms=1.0, candidates=()))
    d = _select(mode="model")
    assert (d.block_q, d.block_k, d.cache_layer) == (64, 64, "none")
    assert get_tuning_cache().get(fp)[0].block_q == 128


def test_invalid_mode_is_rejected(monkeypatch):
    with pytest.raises(ValueError, match="AUTOTUNE"):
        _select(mode="fastest")
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "fast")
    with pytest.raises(ValueError, match="MAGI_ATTENTION_AUTOTUNE"):
        fa.auto_kernel_config(*CAUSAL[:2], 8, 4)


def test_measure_mode_winner_roundtrips_disk_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR", str(tmp_path))
    reset_tuning_cache()
    top = _top()
    assert len(top) == 3
    target = top[1].kernel_config
    calls = []

    def fake_measure(bq, bk, hb, grid):
        calls.append((bq, bk, hb, grid))
        return 0.001 if (bq, bk, hb, grid) == target else 0.010

    d = _select(mode="measure", measure_fn=fake_measure)
    assert calls == [c.kernel_config for c in top]
    assert (d.source, d.kernel_config, d.measured_ms) == ("measured", target, pytest.approx(1.0))
    reset_tuning_cache()
    d2 = _select(mode="measure",
                 measure_fn=lambda *_: pytest.fail("a cache hit must not measure again"))
    assert (d2.cache_layer, d2.source, d2.kernel_config) == ("disk", "measured", target)


def test_measure_mode_upgrades_model_sourced_cache_entry(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR", str(tmp_path))
    reset_tuning_cache()
    assert _select(mode="measure").source == "model"  # nothing to time that call
    target = _top()[2].kernel_config
    up = _select(mode="measure",
                 measure_fn=lambda *c: 0.001 if c == target else 0.010)
    assert (up.source, up.kernel_config) == ("measured", target)
    served = _select(mode="measure", measure_fn=lambda *_: pytest.fail("measured already"))
    assert (served.source, served.cache_layer) == ("measured", "memory")
    assert _select(mode="model").source == "measured"


def _small(seed=0, total=256, hq=4, hk=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((total, hq, d)).astype(np.float32)
    k = rng.standard_normal((total, hk, d)).astype(np.float32)
    v = rng.uniform(0.5, 1.5, (total, hk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("pin", ["argument", "env"])
def test_pinned_head_block_degrades_measure_to_model(pin, monkeypatch, recording):
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "measure")
    q, k, v = (torch.from_numpy(x) for x in _small())
    kw = {}
    if pin == "argument":
        kw["head_block"] = 2
    else:
        monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", "2")
    out, _ = fa.flex_flash_attn_func(q, k, v, [(0, 256)], [(0, 256)], [1], **kw)
    assert out.shape == (256, 4, 64)
    assert telemetry.snapshot()["counters"].get("magi_autotune_measurements_total", 0) == 0


def test_measure_mode_times_the_candidates_on_the_operands(monkeypatch, recording):
    """Unpinned, the real timer (the plain versions and the host clock on
    the CPU) times the model's top 3 and caches the winner."""
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "measure")
    q, k, v = (torch.from_numpy(x) for x in _small())
    fa.flex_flash_attn_func(q, k, v, [(0, 256)], [(0, 256)], [1])
    c = telemetry.snapshot()["counters"]
    assert c["magi_autotune_measurements_total"] == 3
    assert c.get("magi_autotune_measure_failures_total", 0) == 0
    d = select_block_config([(0, 256)], [(0, 256)], [1], 4, 2, head_dim=64,
                            dtype=str(q.dtype), device="cpu")
    assert (d.source, d.cache_layer) == ("measured", "memory")


def test_measure_mode_survives_crashing_candidates(recording):
    ok = _top()[1].kernel_config

    def bomb(*cand):
        if cand != ok:
            raise RuntimeError("launch failed")
        return 0.005

    d = _select(mode="measure", measure_fn=bomb)
    assert (d.source, d.kernel_config) == ("measured", ok)
    assert telemetry.snapshot()["counters"]["magi_autotune_measure_failures_total"] == 2


def test_all_candidates_failing_does_not_retry_forever():
    attempts = []

    def always(*cand):
        attempts.append(cand)
        raise RuntimeError("device OOM")

    d = _select(mode="measure", measure_fn=always)
    assert d.source == "measure_failed" and "failed" in d.reason
    n = len(attempts)
    again = _select(mode="measure", measure_fn=always)
    assert len(attempts) == n == 3
    assert (again.cache_layer, again.kernel_config) == ("memory", d.kernel_config)


def test_measure_failed_is_not_persisted(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR", str(tmp_path))
    reset_tuning_cache()

    def always(*_):
        raise RuntimeError("transient OOM")

    assert _select(mode="measure", measure_fn=always).source == "measure_failed"
    assert not [f for f in os.listdir(tmp_path) if f.startswith("magi-autotune-")]
    reset_tuning_cache()
    assert _select(mode="measure", measure_fn=lambda *_: 0.002).source == "measured"
    assert [f for f in os.listdir(tmp_path) if f.startswith("magi-autotune-")]


def test_infeasible_everywhere_stays_model():
    """A head dim the build has no tile for: nothing to time, a model
    decision (the preference order), served from the cache after."""
    attempts = []
    d = select_block_config(*CAUSAL, 8, 4, head_dim=32, device="cpu", mode="measure",
                            measure_fn=lambda *a: attempts.append(a) or 0.001)
    assert attempts == [] and d.source == "model" and "no feasible candidate" in d.reason
    assert d.kernel_config == (64, 64, 2, "row_major")
    again = select_block_config(*CAUSAL, 8, 4, head_dim=32, device="cpu", mode="measure",
                                measure_fn=lambda *a: attempts.append(a) or 0.001)
    assert attempts == [] and again.cache_layer == "memory"


def test_measure_without_a_timer_takes_the_model():
    d = _select(mode="measure")
    assert d.source == "model" and "measure requested" in d.reason


def test_three_argument_measure_fn_is_refused():
    with pytest.raises(TypeError, match="grid"):
        _select(mode="measure", measure_fn=lambda bq, bk, hb: 0.001)


def test_autotune_mode_and_card_are_part_of_flags_fingerprint(monkeypatch):
    """The fault repaired first: a key built under one mode must not serve
    another (JAX keys ``autotune_mode()``); the card's name stands where JAX
    keys its TPU generation."""
    prints = set()
    for mode in ("model", "off", "measure"):
        monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", mode)
        fp = interface.flags_fingerprint()
        assert mode in fp and "cpu" in fp
        prints.add(fp)
    assert len(prints) == 3


def test_key_path_consults_the_tuning_cache(recording, monkeypatch):
    args = (*CAUSAL, 4096, 4096, 2, 8, 4, 128, "torch.bfloat16")
    tuned = tuning.resolve_block_config(*args, device="cpu")
    assert tuned == (64, 64, 2)
    assert tuning.resolve_block_config(*args, device="cpu") == tuned
    c = telemetry.snapshot()["counters"]
    assert c["magi_autotune_cache_misses_total"] == 1
    assert c["magi_autotune_cache_hits_total{layer=memory}"] == 1
    assert interface.resolve_blocking(*args, device="cpu") == tuned
    # tiny shards: no tile fits, the static rule
    assert tuning.resolve_block_config([(0, 96)], [(0, 96)], [1], 96, 96, 4, 8, 4, 128,
                                       "float32", device="cpu") is None
    assert interface.resolve_blocking([(0, 96)], [(0, 96)], [1], 96, 96, 4, 8, 4, 128,
                                      "float32", device="cpu") == (64, 64, 2)
    # measure takes the model here; a pinned tile or off steps the tuner aside
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "measure")
    assert tuning.resolve_block_config(*args, device="cpu") == tuned
    monkeypatch.setenv("MAGI_ATTENTION_HEAD_BLOCK", "4")
    assert tuning.resolve_block_config(*args, device="cpu") == (64, 64, 4)
    monkeypatch.setenv("MAGI_ATTENTION_BLOCK_Q", "64")
    assert tuning.resolve_block_config(*args, device="cpu") is None
    monkeypatch.delenv("MAGI_ATTENTION_BLOCK_Q")
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "off")
    assert tuning.resolve_block_config(*args, device="cpu") is None


def test_split_tuners_give_one_split_on_the_serving_geometries(recording):
    kw = dict(head_dim=128, dtype="bfloat16", device="cpu")
    for batch, mpp in ((8, 64), (1, 256), (16, 64), (64, 48)):
        assert tuning.select_decode_splits(batch, mpp, 128, 32, 8, **kw).head_block == 1
    for rows, entries in ((8, 1), (64, 16), (512, 64), (2048, 64)):
        assert tuning.select_tick_splits(rows, entries, 128, 32, 8, **kw).head_block == 1
    # a long lone history leaves SMs idle at one split: the model splits it
    long = tuning.select_decode_splits(1, 8192, 128, 32, 8, **kw)
    assert long.head_block > 1 and long.source == "model"
    # memoised: a repeat call is a dict lookup, no cache lookup recorded
    before = dict(telemetry.snapshot()["counters"])
    again = tuning.select_decode_splits(1, 8192, 128, 32, 8, **kw)
    assert again is long and telemetry.snapshot()["counters"] == before
    reset_tuning_cache()
    assert tuning.select_decode_splits(1, 8192, 128, 32, 8, **kw) is not long


def test_split_resolution_order_and_clamp(monkeypatch):
    cache = make_paged_kv_cache(64, 16, 2, 32, max_seqs=4, max_pages_per_seq=12, device="cpu")
    assert resolve_num_splits(None, cache, 4, 8) == 1
    monkeypatch.setattr(autotuner, "MERGE_ROUND_S", 0.0)  # free merges: the most splits
    reset_tuning_cache()
    assert resolve_num_splits(None, cache, 1, 4, mpp=7) == 7
    assert resolve_num_splits(None, cache, 1, 4) == 12
    monkeypatch.setenv("MAGI_ATTENTION_DECODE_SPLITS", "5")
    assert resolve_num_splits(None, cache, 4, 8) == 4  # the largest divisor of 12 <= 5
    assert resolve_tick_splits(None, cache, 16, 8, 4) == 4
    assert resolve_num_splits(3, cache, 4, 8) == 3


def _todays_rule(qr, kr, ty, hq, hk):
    grid = "sparse" if tuning.mask_density(qr, kr, ty) < tuning.SPARSE_DENSITY_THRESHOLD \
        else "row_major"
    return (64, 64, hq // hk, grid)


def _docs(lens):
    b = np.cumsum([0, *lens]).tolist()
    qr = list(zip(b[:-1], b[1:]))
    return qr, qr, [1] * len(lens)


SMOKE_CHOICES = {  # the masks and widths of chip_smoke.py's paths
    "serving_prefill_32x8": (CAUSAL, 32, 8, 128),
    "serving_mha_32x32": (([(0, 3000)], [(0, 3000)], [1]), 32, 32, 128),
    "chunked_prefill": (([(0, 512)], [(0, 2900)], [1]), 32, 8, 128),
    "training_16x8": (_docs([4096, 2048, 2048]), 16, 8, 128),
    "hetero_16x8": (split_slices(varlen_block_causal(16384)), 16, 8, 128),
    "hetero_8x8": (split_slices(varlen_block_causal(16384)), 8, 8, 128),
    "sink_window_64x8": (([(0, 127), (127, 8192), (8192, 8319), (8319, 16384)],
                          [(0, 127), (0, 8192), (8192, 8319), (8192, 16384)], [1, 3, 1, 3]),
                         64, 8, 64),
}


@pytest.mark.parametrize("name", sorted(SMOKE_CHOICES))
def test_default_decisions_pin_todays_rule(name):
    (qr, kr, ty), hq, hk, d = SMOKE_CHOICES[name]
    assert fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, head_dim=d,
                                 device="cpu") == _todays_rule(qr, kr, ty, hq, hk)
    t = max(e for _, e in kr)
    row = (64, 64, hq // hk)
    assert fa.auto_block_config(qr, kr, hq, hk, attn_type_map=ty, head_dim=d) == row
    assert interface.resolve_blocking(qr, kr, ty, t, t, 2, hq, hk, d, "torch.bfloat16",
                                      device="cpu") == row
    cfg = LlamaConfig(n_heads=hq, n_kv_heads=hk, dim=hq * d, head_dim=d)
    assert resolve_harness_blocking(cfg, qr, kr, ty, t, 1, None, None, device="cpu") == row


def test_flex_flash_attn_func_matches_jax_under_model_and_measure(monkeypatch):
    """The slice on the CPU: the port's defaults (the model picks the sparse
    grid on this heterogeneous mask) and a measured choice (a timer that
    ranks the sparse grid at head_block 2G first) against JAX's defaults."""
    jax_backend(monkeypatch)
    total, hq, hk, d = 768, 4, 2, 64
    qr, kr, ty = _docs([64, 128, 64, 192, 128, 64, 64, 64])
    q, k, v = _small(3, total, hq, hk, d)
    jo, jl = jax_flex_flash_attn_func(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qr, kr, ty)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, l = fa.flex_flash_attn_func(tq, tk, tv, qr, kr, ty)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)

    timed = []

    def make(*a, **kw):
        def measure(bq, bk, hb, grid):
            timed.append((hb, grid))
            return 0.001 if (hb, grid) == (4, "sparse") else 0.002 if grid == "sparse" else 0.003
        return measure

    monkeypatch.setattr(fa, "_make_measure_fn", make)
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "measure")
    reset_tuning_cache()
    o, l = fa.flex_flash_attn_func(tq, tk, tv, qr, kr, ty)
    d_ = select_block_config(qr, kr, ty, hq, hk, head_dim=d, dtype=str(tq.dtype), device="cpu")
    assert len(timed) == 3 and (d_.source, d_.head_block, d_.grid) == ("measured", 4, "sparse")
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_serving_engine_under_model_matches_jax(monkeypatch):
    """Two prompts and two decode steps through both engines, every kernel
    choice and split count left to the tuners."""
    jax_backend(monkeypatch)
    hq, hk, d, ps = 4, 2, 32, 16
    kw = dict(num_pages=32, num_kv_heads=hk, head_dim=d, page_size=ps, max_seqs=4,
              max_pages_per_seq=8)
    jeng = JaxEngine(dtype=jnp.float32, **kw)
    eng = ServingEngine(dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(11)
    slots = []
    for t in (40, 40):
        slot = eng.admit(t).slot
        assert jeng.admit(t).slot == slot
        slots.append(slot)
        q = rng.standard_normal((t, hq, d)).astype(np.float32)
        k = rng.standard_normal((t, hk, d)).astype(np.float32)
        v = rng.uniform(0.5, 1.5, (t, hk, d)).astype(np.float32)
        jo, jl = jeng.prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slot)
        o, l = eng.prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), slot)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for _ in range(2):
        q = rng.standard_normal((2, hq, d)).astype(np.float32)
        k = rng.standard_normal((2, hk, d)).astype(np.float32)
        v = rng.uniform(0.5, 1.5, (2, hk, d)).astype(np.float32)
        jo, jl = jeng.decode_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slots)
        o, l = eng.decode_step(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               slots)
        assert eng.last_decode_info["num_splits"] == 1
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_cp2_key_takes_rank0s_decision(tmp_path):
    from magiattention_tpu_torch.testing.dist import RankPool
    from tests import torch_dist_workers as workers

    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    with RankPool(2) as pool:
        got = pool.run(workers.tuned_key_blocking, dirs, 1024, (8, 4), 64, 128)
    assert [r["own"] for r in got] == [(64, 64, 2), (64, 64, 1)]  # rank 1's planted record
    assert [r["key_blocking"] for r in got] == [(64, 64, 2), (64, 64, 2)]
    assert all(r["same_key"] for r in got)


def test_group_memos_stay_in_lockstep_across_overlapping_groups():
    """Ranks 0 and 1 key on the world and on {0, 1}, rank 2 on the world
    only, through memo tables small enough to evict: the tables are a
    group's each, so every group's ranks hit and miss together (a rank
    that missed alone would wait in a broadcast, and the pool time out),
    and a repeat mask takes no decision."""
    from magiattention_tpu_torch.testing.dist import RankPool
    from tests import torch_dist_workers as workers

    with RankPool(3, timeout_s=120) as pool:
        got = pool.run(workers.overlapping_group_blocking, 6, 4)
        reuse = pool.run(workers.bucketed_key_blocking, [list(d) for _, d, _ in CP_STREAM],
                         (16, 8), 128, 512)
    assert got[0]["first"] == got[1]["first"]
    assert got[0]["first"][::2] == got[2]["first"] == [(64, 64, 2)] * 6
    assert [r["decided"] for r in got] == [12, 0, 0]  # rank 0 decides, 6 masks x 2 groups
    assert [r["decided_again"] for r in got] == [0, 0, 0]
    assert all(r["again"] == r["first"][-len(r["again"]):] for r in got)
    # the plan-reuse stream: rank 0 ranks each cold bucket's canonical mask
    # once; bucket hits, exact hits and the nested canonical keys take none
    assert reuse[0]["decisions"] == [1 if tier == "cold" else 0 for _, _, tier in CP_STREAM]
    assert [r["decisions"] for r in reuse[1:]] == [[0] * len(CP_STREAM)] * 2
    assert all(r["blockings"] == reuse[0]["blockings"] for r in reuse)


def test_repeat_flex_call_takes_its_choice_from_the_memo(monkeypatch):
    """A repeat ``flex_flash_attn_func`` call (the same slices, extents,
    pins and flags) makes no fingerprint; a flag the choice reads, or a
    cache reset, makes it choose again."""
    calls = []
    inner = fa.auto_kernel_config
    monkeypatch.setattr(fa, "auto_kernel_config",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    q, k, v = (torch.from_numpy(x) for x in _small())
    mask = ([(0, 128), (128, 256)], [(0, 128), (0, 256)], [1, 1])
    first = fa.flex_flash_attn_func(q, k, v, *mask)
    again = fa.flex_flash_attn_func(q, k, v, *mask)
    assert len(calls) == 1 and all(torch.equal(a, b) for a, b in zip(first, again))
    fa.flex_flash_attn_func(q, k, v, *mask, head_block=1)
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE", "off")
    fa.flex_flash_attn_func(q, k, v, *mask)
    assert len(calls) == 3
    reset_tuning_cache()
    fa.flex_flash_attn_func(q, k, v, *mask)
    assert len(calls) == 4
