"""The kernel build's cross-process lock (``csrc.build``), on the CPU with
the compile step stubbed: two processes that reach the build of one kernel
at once (as the ranks of a context-parallel run do) must not both compile
nor clobber each other's library. The stub "nvcc" records each run and
holds the output path open for a while before writing it."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({log!r}, "a") as f:
        f.write(f"start {{os.getpid()}}\\n")
    time.sleep(1.0)
    with open(out, "w") as f:
        f.write(f"library of {{os.getpid()}}\\n")
    with open({log!r}, "a") as f:
        f.write(f"end {{os.getpid()}}\\n")
""")

BUILDER = textwrap.dedent("""\
    import sys
    from magiattention_tpu_torch import csrc
    csrc.BUILD_DIR = sys.argv[1]
    csrc._nvcc = lambda: sys.argv[2]
    print(csrc.build(["flex_fwd"])["flex_fwd"]["path"])
""")


def test_concurrent_builds_compile_once(tmp_path):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(build_dir), str(nvcc)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1, paths  # both processes load the same library
    lines = log.read_text().split()
    assert lines.count("start") == 1 and lines.count("end") == 1, lines  # one compile
    lib = paths.pop()
    assert open(lib).read().startswith("library of ")  # whole, from one writer
    assert not [f for f in os.listdir(build_dir) if f.endswith(".tmp")]
