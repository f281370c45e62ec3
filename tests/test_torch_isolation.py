"""The port stands alone: no module of ``magiattention_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and an entry point that
needs the card raises when there is none instead of falling back."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import magiattention_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import magiattention_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "magiattention_tpu.")))
bad += ["magiattention_tpu"] if "magiattention_tpu" in sys.modules else []
print(len(names), bad)
"""


def _no_card_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine has
    return env


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_no_card_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().rsplit("\n", 1)[-1].split(" ", 1)
    assert int(count) >= 30, res.stdout
    assert bad == "[]", f"the port pulled in {bad}"


def test_every_module_is_mirrored_by_a_jax_twin():
    """Same relative paths as the JAX package, one subpackage at a time."""
    jax_root = os.path.join(REPO, "magiattention_tpu")
    prefix = "magiattention_tpu_torch."
    names = [m.name for m in pkgutil.walk_packages(magiattention_tpu_torch.__path__, prefix)]
    assert "magiattention_tpu_torch.serving.engine" in names
    assert "magiattention_tpu_torch.models.llama" in names
    for new in ("meta.plan_fingerprint", "ops.range_merge", "utils.packing",
                "telemetry.numerics", "common.axes", "common.protocols", "ops.block_sparse",
                "ops.index_attn", "extensions.dsa", "extensions.sink_attention",
                "testing.precision", "testing.flag_generator", "testing.gt_dispatcher",
                "serving.scheduler", "serving.unified_tick", "serving.cp_decode",
                "serving.distributed", "serving.plan_probe", "resilience.chaos",
                "resilience.guards", "telemetry.logger", "telemetry.registry",
                "telemetry.events", "telemetry.collectors", "telemetry.compile",
                "telemetry.trace", "telemetry.aggregate", "telemetry.exposition",
                "telemetry.memory", "telemetry.timeline", "telemetry.roofline",
                "telemetry.occupancy", "utils.cost", "tuning.fingerprint", "tuning.cache",
                "tuning.cost_model", "tuning.autotuner", "analysis.plan_sanity",
                "analysis.trace_audit", "analysis.spmd_audit", "analysis.lifecycle",
                "analysis.lint", "analysis.__main__", "fleet.workload", "fleet.autopilot",
                "fleet.sim", "fleet.capacity", "models.llama_pp", "parallel.baselines",
                "parallel.baselines.ring", "parallel.baselines.ulysses",
                "parallel.baselines.usp", "parallel.baselines.loongtrain",
                "parallel.baselines.hybrid_dcp", "parallel.baselines.nsa"):
        assert prefix + new in names, new
    for name in names:
        rel = name[len(prefix):].replace(".", os.sep)
        # the port's own: state to and from numpy; the process spawner of the
        # multi-rank tests (the JAX package's ranks are one process's mesh);
        # and the analysis CLI (the JAX package's is exps/run_static_analysis.py)
        if rel in ("convert", os.path.join("testing", "dist"),
                   os.path.join("analysis", "__main__")):
            continue
        assert os.path.exists(os.path.join(jax_root, rel + ".py")) or os.path.isdir(
            os.path.join(jax_root, rel)), rel


_HOST_PROBE = """
import sys
import numpy as np
from magiattention_tpu_torch import csrc
from magiattention_tpu_torch.ops import block_sparse_attn_func, build_block_meta
meta = build_block_meta([(0, 256)], [(0, 256)], [1], 256, 256, block_q=64, block_k=64)
import torch
out, _ = block_sparse_attn_func(*(torch.ones(256, 2, 32) for _ in range(3)),
                                np.ones((2, 2), bool), causal=True)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "magiattention_tpu.")))
print(csrc.HOST_SOURCE, sorted(csrc._host_libs), meta.total_area, bad)
"""


def test_host_library_builds_from_the_ports_own_source(tmp_path):
    """The native planner library is built from the port's copy of the
    source, into the port's build directory, in a process that never
    imports JAX or the JAX package."""
    res = subprocess.run([sys.executable, "-c", _HOST_PROBE], cwd=REPO, env=_no_card_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    src, libs, area, bad = res.stdout.strip().rsplit("\n", 1)[-1].split(" ", 3)
    port_csrc = os.path.join(REPO, "magiattention_tpu_torch", "csrc")
    assert src == os.path.join(port_csrc, "entry_table.cpp")
    assert os.path.join(port_csrc, "build", "libentry_table-") in libs
    assert int(area) == 256 * 257 // 2 and bad == "[]"


def test_engine_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    from magiattention_tpu_torch.serving import ServingEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(num_pages=8, num_kv_heads=2, head_dim=64)


def test_scheduler_over_the_default_engine_raises_without_a_card():
    """The scheduler serves on the engine's device, the card by default:
    without one the engine it needs cannot be made, and a request on
    another device than its engine's is refused."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    from magiattention_tpu_torch.serving import Scheduler, ServingEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(ServingEngine(num_pages=8, num_kv_heads=2, head_dim=64))


def test_tiered_engine_raises_without_a_card():
    """The disaggregated engine's tiers default to the cards in turn: with
    none it raises instead of taking the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    from magiattention_tpu_torch.serving import TieredEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredEngine(num_pages=8, num_kv_heads=2, head_dim=64,
                     mesh_spec={"prefill": 1, "decode_dp": 2, "decode_tp": 2})


@pytest.mark.parametrize("entry", ["magi_attn_flex_key", "magi_attn_varlen_key",
                                   "magi_attn_cross_key", "magi_attn_flex_dispatch",
                                   "magi_attn_varlen_dispatch", "init_dist_attn_runtime_key",
                                   "init_dist_attn_runtime_mgr"])
def test_keyed_cp_entry_points_raise_without_a_card(entry):
    """Without ``device="cpu"`` the keyed context-parallel API runs on the
    card, and without one it raises before planning, never running on the
    CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    from magiattention_tpu_torch import api

    x = torch.zeros(256, 4, 64)
    heads = dict(num_heads=(4, 2), head_dim=64)
    args, kw = {
        "magi_attn_flex_key": (([(0, 256)], [(0, 256)], [1], 256, 256, None),
                               dict(chunk_size=64, **heads)),
        "magi_attn_varlen_key": (([0, 128, 256], 256, None), dict(chunk_size=64, **heads)),
        "magi_attn_cross_key": (([(0, 256)], [(0, 512)], [0], 256, 512, None),
                                dict(chunk_size_q=64, chunk_size_k=128, **heads)),
        "magi_attn_flex_dispatch": ((x, [(0, 256)], [(0, 256)], [1], 256, 256, None),
                                    dict(chunk_size=64, **heads)),
        "magi_attn_varlen_dispatch": ((x, [0, 128, 256], 256, None), dict(chunk_size=64, **heads)),
        "init_dist_attn_runtime_key": (([(0, 256)], [(0, 256)], [1], 256, 256, 4, 2, 64, 64, None),
                                       {}),
        "init_dist_attn_runtime_mgr": (([(0, 256)], [(0, 256)], [1], 256, 256, 4, 2, 64, 64, None),
                                       {}),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(api, entry)(*args, **kw)


def test_qo_comm_key_raises_without_a_card(monkeypatch):
    """Under ``MAGI_ATTENTION_QO_COMM`` too, the keyed API runs on the card
    by default and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot be observed here")
    from magiattention_tpu_torch import api

    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.magi_attn_flex_key([(0, 256)], [(0, 256)], [1], 256, 256, None, num_heads=(4, 2),
                               head_dim=64, chunk_size=64)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    from magiattention_tpu_torch import csrc

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(csrc.os.path, "exists", lambda path: False)
    with pytest.raises(csrc.KernelBuildError, match="nvcc not found"):
        csrc.build()


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    cwd = REPO
    env = _no_card_env()
    if alone:  # a directory holding chip_smoke.py and nothing else of the repo
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
        env.pop("PYTHONPATH")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
