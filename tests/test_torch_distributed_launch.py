"""``repro_torch.launch.sa_build`` under ``torchrun`` on four CPU ranks
prints what ``repro.launch.sa_build`` prints on four fake devices, walls
aside, in each of its three modes."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--reads", "300", "--read-len", "48"]
MODES = ("scheme", "terasort", "doubling")
WALL = re.compile(r" time=[0-9.]+s \([0-9]+ suffixes/s\)")


def _lines(out: str):
    return [WALL.sub("", line) for line in out.splitlines()]


@pytest.fixture(scope="module")
def repro_lines():
    """repro's printout of each mode on four devices, from one process."""
    code = (
        "import sys\n"
        "from repro.launch import sa_build\n"
        f"for mode in {MODES!r}:\n"
        f"    sys.argv = ['sa_build', *{ARGS!r}, '--mode', mode]\n"
        "    print('=== ' + mode, flush=True)\n"
        "    sa_build.main()\n")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for block in proc.stdout.split("=== ")[1:]:
        mode, _, text = block.partition("\n")
        out[mode] = _lines(text)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_torchrun_prints_repros_lines(repro_lines, mode):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.sa_build",
         "--device", "cpu", *ARGS, "--mode", mode],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "process group: 4 ranks over gloo" in proc.stderr
    got = _lines(proc.stdout)
    assert got == repro_lines[mode]  # rank 0's lines once: the others print nothing
    stats = got[-1]
    assert "'dropped': 0" in stats
    if mode == "scheme":
        assert re.search(r"'per_device_counts': \[\d+, \d+, \d+, \d+\]", stats)
