"""The port's examples print what their ``repro`` counterparts print, walls
aside: ``examples/torch_quickstart.py`` (Table I, the paired-end build, the
index lifecycle) and ``examples/torch_dedup_corpus.py`` in one process, and
``examples/torch_sa_build.py`` (the paper's experiment, with ``--baseline`` and
``--verify``) in one process and under ``torchrun`` on four CPU ranks
against ``examples/sa_build.py`` on as many fake devices: the number of
ranks stands where repro prints its devices."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
WALL = re.compile(r"[0-9.]+s  \([0-9]+ suffixes/s\)|baseline: [0-9.]+s")


def _run(cmd, devices=1):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [WALL.sub("WALL", line) for line in proc.stdout.splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "dedup_corpus"])
def test_example_prints_repros_lines(name):
    got = _run([sys.executable, os.path.join(EXAMPLES, f"torch_{name}.py"),
                "--device", "cpu"])
    want = _run([sys.executable, os.path.join(EXAMPLES, f"{name}.py")])
    assert got == want and len(got) >= 5


@pytest.mark.parametrize("ranks", [1, 4])
def test_sa_build_example_on_ranks_prints_repros_lines(ranks):
    args = ["--reads", "300", "--read-len", "24", "--baseline", "--verify"]
    script = os.path.join(EXAMPLES, "torch_sa_build.py")
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(ranks)] if ranks > 1 else [sys.executable])
    got = _run([*launcher, script, "--device", "cpu", *args])
    want = _run([sys.executable, os.path.join(EXAMPLES, "sa_build.py"), *args],
                devices=ranks)
    assert got[0] == f"ranks: {ranks}" and want[0] == f"devices: {ranks}"
    assert got[1:] == want[1:]
    assert "oracle match: True" in got and any("dropped=0" in ln for ln in got)
