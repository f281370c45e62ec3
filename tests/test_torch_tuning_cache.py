"""The port's tuning cache (``magiattention_tpu_torch/tuning/cache.py``):
twins of the JAX package's ``tests/test_tuning/test_cache.py`` (the memory
layer, the disk round trip across instances, a fingerprint mismatch or a
torn file as a miss, an unwritable directory that never fails planning, the
singleton following ``MAGI_ATTENTION_AUTOTUNE_CACHE_DIR``, the winner's grid
through the disk), run on both packages; and the ``cache_io_error`` chaos
site: a load or store fault is a miss (or a skipped store) plus one
``magi_tuning_cache_io_errors{op=}``."""

import json
import os

import pytest

from magiattention_tpu import tuning as jtuning
from magiattention_tpu_torch import telemetry, tuning
from magiattention_tpu_torch.resilience import reset_chaos

PACKAGES = {"jax": jtuning, "torch": tuning}


def _fp(pkg, total=16384):
    if pkg is tuning:
        return pkg.make_fingerprint([(0, total)], [(0, total)], [1], 8, 8, device="cpu")
    return pkg.make_fingerprint([(0, total)], [(0, total)], [1], 8, 8)


def _rec(pkg, source="model", grid="row_major"):
    return pkg.TuningRecord(
        block_q=64, block_k=64, head_block=8, source=source, predicted_ms=3.1,
        measured_ms=2.7 if source == "measured" else None,
        candidates=({"block_q": 64, "block_k": 64, "cost_seconds": 0.003},), grid=grid,
    )


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_memory_layer_roundtrip(pkg):
    cache = pkg.TuningCache(None)
    fp = _fp(pkg)
    assert cache.get(fp) == (None, "miss")
    cache.put(fp, _rec(pkg))
    rec, layer = cache.get(fp)
    assert layer == "memory"
    assert (rec.block_q, rec.block_k, rec.head_block) == (64, 64, 8)


def test_disk_roundtrip_across_instances(pkg, tmp_path):
    d = str(tmp_path)
    fp = _fp(pkg)
    pkg.TuningCache(d).put(fp, _rec(pkg, "measured"))
    files = [f for f in os.listdir(d) if f.startswith("magi-autotune-")]
    assert len(files) == 1 and files[0].endswith(".json")
    rec, layer = pkg.TuningCache(d).get(fp)
    assert (layer, rec.source, rec.measured_ms) == ("disk", "measured", 2.7)
    cache = pkg.TuningCache(d)
    cache.get(fp)
    assert cache.get(fp)[1] == "memory"


def test_disk_fingerprint_mismatch_is_a_miss(pkg, tmp_path):
    d = str(tmp_path)
    fp = _fp(pkg)
    cache = pkg.TuningCache(d)
    cache.put(fp, _rec(pkg))
    path = cache._path(fp.stable_hash())
    with open(path) as f:
        payload = json.load(f)
    payload["fingerprint"]["num_heads_q"] = 999
    with open(path, "w") as f:
        json.dump(payload, f)
    assert pkg.TuningCache(d).get(fp) == (None, "miss")


def test_corrupt_disk_file_is_a_miss(pkg, tmp_path):
    d = str(tmp_path)
    fp = _fp(pkg)
    cache = pkg.TuningCache(d)
    cache.put(fp, _rec(pkg))
    with open(cache._path(fp.stable_hash()), "w") as f:
        f.write("{torn json")
    assert pkg.TuningCache(d).get(fp) == (None, "miss")


def test_unwritable_dir_never_fails_planning(pkg, tmp_path):
    d = tmp_path / "nope"
    d.mkdir()
    os.chmod(d, 0o500)
    try:
        cache = pkg.TuningCache(str(d / "sub"))
        cache.put(_fp(pkg), _rec(pkg))  # must not raise
        assert cache.get(_fp(pkg))[1] == "memory"
    finally:
        os.chmod(d, 0o700)


def test_singleton_follows_env_dir(pkg, tmp_path, monkeypatch):
    pkg.reset_tuning_cache()
    monkeypatch.delenv("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR", raising=False)
    c1 = pkg.get_tuning_cache()
    assert c1.cache_dir is None and pkg.get_tuning_cache() is c1
    monkeypatch.setenv("MAGI_ATTENTION_AUTOTUNE_CACHE_DIR", str(tmp_path))
    c2 = pkg.get_tuning_cache()
    assert c2 is not c1 and c2.cache_dir == str(tmp_path)
    pkg.reset_tuning_cache()


def test_record_grid_roundtrips_and_defaults(pkg):
    rec = _rec(pkg, grid="sparse")
    assert pkg.TuningRecord.from_dict(rec.as_dict()).grid == "sparse"
    legacy = {k: v for k, v in rec.as_dict().items() if k != "grid"}
    assert pkg.TuningRecord.from_dict(legacy).grid == "row_major"


@pytest.mark.parametrize("op", ["load", "store"])
def test_cache_io_error_site_is_a_counted_miss(op, tmp_path, monkeypatch):
    """``MAGI_ATTENTION_CHAOS=cache_io_error:op=<op>`` fires at the disk
    layer's load or store: a load fault is a miss, a store fault keeps the
    winner in memory only; each counts one
    ``magi_tuning_cache_io_errors{op=}``, the other op none."""
    d = str(tmp_path)
    fp = _fp(tuning)
    if op == "load":
        tuning.TuningCache(d).put(fp, _rec(tuning))
    monkeypatch.setenv("MAGI_ATTENTION_CHAOS", f"cache_io_error:op={op}")
    reset_chaos()
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        cache = tuning.TuningCache(d)
        if op == "load":
            assert cache.get(fp) == (None, "miss")
        else:
            cache.put(fp, _rec(tuning))
            assert cache.get(fp)[1] == "memory"
            assert not [f for f in os.listdir(d) if f.endswith(".json")]
        counters = telemetry.snapshot()["counters"]
        assert counters == {f"magi_tuning_cache_io_errors{{op={op}}}": 1.0}
    finally:
        telemetry.set_enabled(None)
        telemetry.reset()
        monkeypatch.delenv("MAGI_ATTENTION_CHAOS")
        reset_chaos()
