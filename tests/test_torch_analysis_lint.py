"""The port's AST linter (``analysis/lint.py``): a positive and a negative
for each rule it checks (MAGI002, MAGI003, MAGI005), the inline pragma,
the allowlist's stale-entry report and its justification rule, and the
port linting clean through its allowlist."""

import json
import os

import pytest

from magiattention_tpu_torch.analysis import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOT = "magiattention_tpu_torch/ops/planted.py"


def _rules(src, path=HOT):
    return [v.rule for v in lint.lint_source(src, path)]


@pytest.mark.parametrize("src,path,rule,hit", [
    ("import os\nx = os.environ.get('X')\n", HOT, "MAGI002", True),
    ("import os\nx = os.getenv('X')\n", HOT, "MAGI002", True),
    ("from os import environ\n", HOT, "MAGI002", True),
    ("import os\nx = os.environ.get('X')\n", "magiattention_tpu_torch/env.py", "MAGI002", False),
    ("import os\nx = os.path.join('a', 'b')\n", HOT, "MAGI002", False),
    ("import torch\ndef f(x: torch.Tensor):\n    return x.sum().item()\n", HOT, "MAGI003", True),
    ("import torch\ndef f(x: torch.Tensor):\n    return int(x[0])\n", HOT, "MAGI003", True),
    ("def f(cache, s):\n    return int(cache.seq_lens[s])\n", HOT, "MAGI003", True),
    ("import torch\ndef f():\n    torch.cuda.synchronize()\n", HOT, "MAGI003", True),
    ("def f(m):\n    return bool((m > 0).any())\n", HOT, "MAGI003", True),
    ("def f(y):\n    return y.cpu()\n", HOT, "MAGI003", True),
    ("import torch\ndef f(x: torch.Tensor):\n    return int(x.shape[0])\n", HOT, "MAGI003", False),
    ("import numpy as np\ndef f(a):\n    return np.asarray(a).tolist()\n", HOT, "MAGI003", False),
    ("def f(n):\n    return int(n) + float(n)\n", HOT, "MAGI003", False),
    ("import torch\ndef f(x: torch.Tensor):\n    return x.sum().item()\n",
     "magiattention_tpu_torch/testing/planted.py", "MAGI003", False),
    ("import torch.distributed as dist\ndef f(x, g):\n    r = dist.get_rank(g)\n"
     "    if r == 0:\n        dist.all_reduce(x, group=g)\n", HOT, "MAGI005", True),
    ("from magiattention_tpu_torch.comm.group_collective import exchange, group_rank\n"
     "def f(x, g):\n    while group_rank(g) < 1:\n        x = exchange(x, 1, 1, g)\n",
     HOT, "MAGI005", True),
    ("import torch.distributed as dist\ndef f(x, g):\n"
     "    y = GroupCast.apply(x, 0, g) if dist.get_rank(g) else x\n", HOT, "MAGI005", True),
    # the autotuner's pattern: the rank picks who decides, the broadcast
    # stays outside the branch
    ("import torch.distributed as dist\ndef f(box, g, decide):\n"
     "    config = decide() if dist.get_rank(g) == 0 else None\n"
     "    dist.broadcast(box, src=0, group=g)\n", HOT, "MAGI005", False),
    ("import torch.distributed as dist\ndef f(x, g):\n    r = dist.get_rank(g)\n    r = 0\n"
     "    if r == 0:\n        dist.all_reduce(x, group=g)\n", HOT, "MAGI005", False),
])
def test_each_rule_fires_on_its_positive_only(src, path, rule, hit):
    assert (rule in _rules(src, path)) == hit


def test_the_pragma_suppresses_its_rule_only():
    src = "import torch\ndef f(x: torch.Tensor):\n    return x.sum().item()  # magi-allow: {}\n"
    assert _rules(src.format("MAGI003")) == []
    assert _rules(src.format("MAGI002")) == ["MAGI003"]
    assert _rules(src.format("MAGI002, MAGI003")) == []


def test_an_allowlist_entry_suppresses_by_scope_and_stale_ones_are_reported():
    found = lint.lint_source("import os\ndef g():\n    return os.environ['X']\n", HOT)
    hit = {"rule": "MAGI002", "path": HOT, "symbol": "g", "justification": "planted"}
    stale = {"rule": "MAGI002", "path": HOT, "symbol": "gone", "justification": "planted"}
    remaining, stale_found = lint.apply_allowlist(found, [hit, stale])
    assert remaining == [] and stale_found == [stale]
    remaining, _ = lint.apply_allowlist(found, [dict(hit, symbol="*")])
    assert remaining == []


@pytest.mark.parametrize("entry,msg", [
    ({"rule": "MAGI003", "path": HOT, "symbol": "f"}, "missing fields"),
    ({"rule": "MAGI003", "path": HOT, "symbol": "f", "justification": "  "}, "justification"),
])
def test_an_allowlist_entry_needs_a_justification(tmp_path, entry, msg):
    path = tmp_path / "allowlist.json"
    path.write_text(json.dumps([entry]))
    with pytest.raises(ValueError, match=msg):
        lint.load_allowlist(str(path))


def test_the_port_lints_clean_through_its_allowlist():
    assert lint.lint_errors(REPO) == []
    entries = lint.load_allowlist()
    assert {e["rule"] for e in entries} <= set(lint.CHECKED_RULES)
    assert set(lint.RULES) == {"MAGI001", "MAGI002", "MAGI003", "MAGI004", "MAGI005"}


def test_the_cli_self_test_passes_for_lint_and_plan(capsys):
    from magiattention_tpu_torch.analysis.__main__ import main

    assert main(["--only", "lint", "--only", "plan", "--self-test"]) == 0
    assert "analysis: clean" in capsys.readouterr().out
