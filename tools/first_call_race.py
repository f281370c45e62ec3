"""A rank's first CPU kernels under load: the cause of the census bitwise
miss (``tests/test_torch_telemetry_cp.py::
test_census_off_and_on_are_bitwise_the_same``) and its repair.

``python3 tools/first_call_race.py exp [RUNS] [HOGS]``: RUNS fresh processes
(2 intra-op threads, as ``testing.dist.RankPool`` ranks run) each take a
batched matmul, then ``torch.exp`` on its result twice, while HOGS busy
processes load the CPU; counts the processes whose first exp differs from
their second, then the same with the first MKL calls made on the main
thread first (``testing.dist._init_cpu_math``) and with one thread.

``python3 tools/first_call_race.py census [RUNS] [HOGS]``: RUNS fresh 2-rank
pools each run the census test's task (``tests/torch_dist_workers.py::
census_cp``: the keyed forward with the census off, then on) under HOGS
busy processes; counts the runs whose off and on outputs differ. Prints
one JSON object."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys, torch, numpy as np
mode = sys.argv[1]
torch.set_num_threads(1 if mode == "one_thread" else 2)
if mode == "main_thread_first":
    from magiattention_tpu_torch.testing.dist import _init_cpu_math
    _init_cpu_math()
rng = np.random.default_rng(0)
q = torch.from_numpy(rng.standard_normal((4, 256, 32)).astype(np.float32))
k = torch.from_numpy(rng.standard_normal((2, 256, 32)).astype(np.float32)).repeat_interleave(2, 0)
z = torch.einsum("hqd,hkd->hqk", q, k) * 0.17
z = z - z.amax(-1, keepdim=True)
print(int((torch.exp(z) != torch.exp(z)).sum()))
"""


def _hogs(n: int):
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(n)]


def exp_race(runs: int, hogs: int) -> dict:
    procs = _hogs(hogs)
    env = {**os.environ, "PYTHONPATH": REPO}
    try:
        res = {}
        for mode in ("two_threads", "main_thread_first", "one_thread"):
            moved = 0
            for _ in range(runs):
                out = subprocess.run([sys.executable, "-c", _PROBE, mode], capture_output=True,
                                     text=True, env=env, check=True).stdout
                moved += int(out.strip().splitlines()[-1]) > 0
            res[mode] = {"processes": runs, "first_exp_moved": moved}
        return res
    finally:
        for p in procs:
            p.kill()


def census(runs: int, hogs: int) -> dict:
    import numpy as np

    sys.path.insert(0, REPO)
    from magiattention_tpu_torch.testing.dist import RankPool
    from tests import torch_dist_workers as workers
    from tests.test_torch_telemetry_cp import CASE, _inputs

    procs = _hogs(hogs)
    try:
        moved = 0
        for _ in range(runs):
            pool = RankPool(2)
            try:
                got = pool.run(workers.census_cp, CASE, _inputs())
            finally:
                pool.close()
            moved += any(not np.array_equal(r["off"][n], r["census"][n])
                         for r in got for n in ("out", "lse"))
        return {"pools": runs, "off_and_on_differ": moved}
    finally:
        for p in procs:
            p.kill()


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in ("exp", "census"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    hogs = int(sys.argv[3]) if len(sys.argv) > 3 else 6
    fn = exp_race if sys.argv[1] == "exp" else census
    print(json.dumps({sys.argv[1]: fn(runs, hogs), "hogs": hogs}))
