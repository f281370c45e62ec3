"""``telemetry/baseline.py`` of the port (history, expectation windows, the
gate), held to the JAX package's on the same synthetic histories: the same
``GateResult`` verdicts and bounds, the same rung and density flags; the
JAX tests' cases; the tolerance's own environment read agreeing with
``env.perf_gate_tolerance``; a module that imports nothing of the package;
and default files that are not the JAX package's TPU records."""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest

from magiattention_tpu.telemetry import baseline as jax_baseline
from magiattention_tpu_torch import env
from magiattention_tpu_torch.telemetry import baseline


def _history(seed: int) -> list[dict]:
    """A seeded synthetic history: six runs of four metrics, rungs that
    change twice, densities that drift once past the tolerance."""
    rng = np.random.default_rng(seed)
    rungs = ["64x64x2:row_major", "64x64x2:row_major", "64x64x4:sparse"]
    hist = []
    for i in range(6):
        metrics = {f"flex_{n}_tflops": float(rng.uniform(100, 400)) for n in "abcd"}
        if i == 4:
            del metrics["flex_d_tflops"]
        hist.append(baseline.make_history_entry(
            source=f"run{i}", metrics=metrics, recorded_unix=1000 + i,
            autotune_rung=rungs[min(i // 2, 2)], varlen_rung=rungs[(i + 1) % 3],
            mask_density={"flex_a_tflops": 0.07 if i < 3 else 0.09,
                          "flex_b_tflops": 0.5 + 1e-4 * i},
            roofline_efficiency={"flex_a_tflops": float(rng.uniform(0.2, 0.5))},
        ))
    return hist


def _fields(results) -> list[tuple]:
    return [(r.metric, r.status, r.value, r.low, r.high, r.failed) for r in results]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tolerance", [0.0, 0.05, 0.10, 0.5])
def test_gate_matches_jax_on_a_synthetic_history(seed, tolerance):
    hist = _history(seed)
    for window_last in (None, 1, 3):
        windows = baseline.seed_expectations(hist, window_last=window_last)
        assert windows == jax_baseline.seed_expectations(hist, window_last=window_last)
        for newest in (baseline.newest_metrics(hist), baseline.newest_metrics(hist[:-1])):
            got = baseline.check_gate(newest, windows, tolerance)
            want = jax_baseline.check_gate(newest, windows, tolerance)
            assert _fields(got) == _fields(want)
            assert {r.status for r in got} <= {"ok", "regression", "improvement",
                                                "no-expectation", "missing"}
    assert baseline.rung_changes(hist) == jax_baseline.rung_changes(hist)
    assert len(baseline.rung_changes(hist)) >= 2
    assert baseline.density_changes(hist) == jax_baseline.density_changes(hist)
    assert baseline.newest_metric_value(hist, "flex_d_tflops") == \
        jax_baseline.newest_metric_value(hist, "flex_d_tflops")


def test_history_entries_match_jax_and_carry_the_card():
    kw = dict(source="s", metrics={"m": 1.0, "jax_flash_best_tuned_blocks": [1, 2], "t": "x"},
              recorded_unix=7, device="NVIDIA H100 80GB HBM3", vs_baseline=2.0,
              autotune_rung="r", varlen_rung="v", mask_density={"m": 0.5},
              roofline_efficiency={"m": 0.4}, peak_hbm_bytes=123, compile_s=0.0)
    got = baseline.make_history_entry(**kw, power_limit="700.00 W")
    assert got.pop("power_limit") == "700.00 W"
    assert got == jax_baseline.make_history_entry(**kw)
    assert got["metrics"] == {"m": 1.0}


def test_history_append_load_roundtrip(tmp_path):
    path = str(tmp_path / "h.jsonl")
    e1 = baseline.make_history_entry(source="run1", metrics={"m": 10.0}, autotune_rung="r",
                                     device="card", power_limit="700.00 W", recorded_unix=123)
    e2 = baseline.make_history_entry(source="run2", metrics={"m": 11.0})
    baseline.append_history(path, e1)
    baseline.append_history(path, e2)
    assert baseline.load_history(path) == [e1, e2]


def test_history_skips_corrupt_lines(tmp_path):
    path = str(tmp_path / "h.jsonl")
    with open(path, "w") as f:
        f.write('{"metrics": {"m": 1.0}, "source": "a"}\n{truncated garbage\n\n["not a dict"]\n'
                '{"no_metrics_key": 1}\n{"metrics": {"m": 2.0}, "source": "b"}\n')
    assert [e["metrics"]["m"] for e in baseline.load_history(path)] == [1.0, 2.0]
    assert baseline.load_history(path) == jax_baseline.load_history(path)
    assert baseline.load_history(str(tmp_path / "nope.jsonl")) == []


@pytest.mark.parametrize("compile_s", [None, 0.0, 1.23])
def test_make_history_entry_compile_seconds(compile_s):
    e = baseline.make_history_entry(source="s", metrics={"m": 1.0}, compile_s=compile_s)
    assert e.get("compile_s") == compile_s  # 0.0 is a measurement: recorded


def test_newest_metrics_is_the_last_entry_only():
    hist = [{"metrics": {"a": 1.0, "b": 5.0}}, {"metrics": {"a": 2.0}}]
    assert baseline.newest_metrics(hist) == {"a": 2.0}
    assert baseline.newest_metrics([]) == {}


def test_rung_changes_flagged_between_consecutive_runs():
    hist = [{"source": "r5", "metrics": {}, "autotune_rung": "1024x1024x1"},
            {"source": "r6", "metrics": {}},
            {"source": "r7", "metrics": {}, "autotune_rung": "512x2048x1"},
            {"source": "r8", "metrics": {}, "autotune_rung": "512x2048x1"}]
    [flag] = baseline.rung_changes(hist)
    assert "1024x1024x1 -> 512x2048x1" in flag and "r5" in flag and "r7" in flag


def test_seed_expectations_windows_and_filter():
    hist = [{"metrics": {"flex_a": 10.0, "other": 1.0}}, {"metrics": {"flex_a": 12.0}}]
    assert baseline.seed_expectations(hist, metrics_filter=lambda n: n.startswith("flex_")) == \
        {"flex_a": {"low": 10.0, "high": 12.0}}
    w1 = baseline.seed_expectations(hist, window_last=1)
    assert w1 == {"flex_a": {"low": 12.0, "high": 12.0}, "other": {"low": 1.0, "high": 1.0}}
    with pytest.raises(ValueError):
        baseline.seed_expectations(hist, window_last=0)


def test_gate_checks_newest_entry_not_stale_history(tmp_path):
    path = str(tmp_path / "h.jsonl")
    baseline.append_history(path, baseline.make_history_entry(
        source="old", metrics={"a": 100.0, "b": 90.0}))
    baseline.append_history(path, baseline.make_history_entry(source="new", metrics={"a": 99.0}))
    by = {r.metric: r for r in baseline.check_gate(
        baseline.newest_metrics(baseline.load_history(path)),
        {"a": {"low": 100.0, "high": 100.0}, "b": {"low": 90.0, "high": 90.0}}, 0.1)}
    assert by["a"].status == "ok" and by["b"].status == "missing"
    assert "did not measure it" in by["b"].message


def test_expectations_file_roundtrip(tmp_path):
    path = str(tmp_path / "exp.json")
    baseline.write_expectations(path, {"m": {"low": 1.0, "high": 2.0}}, provenance="test")
    assert baseline.load_expectations(path) == {"m": {"low": 1.0, "high": 2.0}}
    assert jax_baseline.load_expectations(path) == baseline.load_expectations(path)
    with open(path) as f:
        assert "_provenance" in json.load(f)


@pytest.mark.parametrize("value,status", [(91.0, "ok"), (89.9, "regression"),
                                          (140.0, "improvement")])
def test_gate_verdicts_at_the_tolerance(value, status):
    [r] = baseline.check_gate({"m": value}, {"m": {"low": 100.0, "high": 100.0}}, tolerance=0.10)
    assert r.status == status and r.failed == (status == "regression")
    assert {"regression": "regression", "improvement": "re-seed", "ok": "within"}[status] \
        in r.message


def test_gate_handles_unseeded_and_unmeasured_metrics():
    by = {r.metric: r for r in baseline.check_gate(
        {"measured_only": 5.0}, {"expected_only": {"low": 1.0, "high": 2.0}}, 0.1)}
    assert by["measured_only"].status == "no-expectation"
    assert by["expected_only"].status == "missing"
    assert not any(r.failed for r in by.values())


@pytest.mark.parametrize("value", [None, "0.5", "0.02"])
def test_default_tolerance_agrees_with_env(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("MAGI_ATTENTION_PERF_GATE_TOLERANCE", raising=False)
    else:
        monkeypatch.setenv("MAGI_ATTENTION_PERF_GATE_TOLERANCE", value)
    assert baseline.default_tolerance() == env.perf_gate_tolerance() == \
        jax_baseline.default_tolerance() == (0.10 if value is None else float(value))
    [r] = baseline.check_gate({"m": 60.0}, {"m": {"low": 100.0, "high": 100.0}})
    assert r.status == ("ok" if value == "0.5" else "regression")


def test_gate_report_contains_verdict():
    exp = {"m": {"low": 100.0, "high": 100.0}}
    rep = baseline.gate_report(baseline.check_gate({"m": 50.0}, exp, 0.1), ["rung flipped"])
    assert "FAIL" in rep and "rung flipped" in rep
    assert "PASS" in baseline.gate_report(baseline.check_gate({"m": 100.0}, exp, 0.1), [])


def test_density_changes_flags_workload_story_and_skips_malformed():
    hist = [{"source": "a", "metrics": {}, "mask_density": {"m": 0.1}},
            {"source": "b", "metrics": {}, "mask_density": {"m": "junk"}},
            {"source": "c", "metrics": {}, "mask_density": {"m": 0.1 + 1e-6}},
            {"source": "d", "metrics": {}, "mask_density": {"m": 0.2}}]
    [flag] = baseline.density_changes(hist)
    assert "0.100001 -> 0.2" in flag and "workload story" in flag
    assert baseline.density_changes(hist) == jax_baseline.density_changes(hist)


def test_module_imports_nothing_of_the_package():
    """A gate script loads it by file path on any host: no relative imports,
    no torch."""
    with open(baseline.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.level == 0 and node.module not in ("torch",)
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] in {"dataclasses", "json", "os"} for a in node.names)


def test_default_files_are_the_ports_own():
    """The JAX package's history and expectations hold TPU numbers: the
    port's defaults name other files."""
    assert baseline.HISTORY_FILENAME != jax_baseline.HISTORY_FILENAME
    assert baseline.EXPECTATIONS_RELPATH != jax_baseline.EXPECTATIONS_RELPATH
    assert "torch" in baseline.HISTORY_FILENAME.lower()


def test_gate_result_is_the_jax_shape():
    assert [f.name for f in dataclasses.fields(baseline.GateResult)] == \
        [f.name for f in dataclasses.fields(jax_baseline.GateResult)]
    assert os.path.basename(baseline.EXPECTATIONS_RELPATH) == "perf_expectations.json"
