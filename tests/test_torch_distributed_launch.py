"""``repro_torch.launch.sa_build`` under ``torchrun`` on four CPU ranks
prints what ``repro.launch.sa_build`` prints on four fake devices, walls
aside, in each of its three modes, and out of core: journaled into an index
directory that the query launcher then serves, and streamed from a fresh
corpus file."""
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


# the out-of-core builds: --superblocks, --index-dir with --resume, and a
# fresh --corpus-file streamed from the chunked store
OOC = {
    "index-resume": ["--reads", "200", "--read-len", "24", "--superblocks", "3",
                     "--index-dir", "{dir}/ix", "--resume"],
    "corpus-file": ["--reads", "200", "--read-len", "24", "--superblocks", "3",
                    "--corpus-file", "{dir}/reads.sachunk", "--store-backend",
                    "chunked", "--cache-budget", "4000"],
}
STAT_WALL = re.compile(r"'t_\w+_s': [0-9.e-]+")


def _ooc_lines(out: str, where: str):
    return [STAT_WALL.sub("", WALL.sub("", line)).replace(where, "DIR")
            for line in out.splitlines()]


@pytest.fixture(scope="module")
def repro_ooc(tmp_path_factory):
    """repro's printout of each out-of-core command on four devices."""
    where = str(tmp_path_factory.mktemp("repro_ooc"))
    code = (
        "import sys\n"
        "from repro.launch import sa_build\n"
        f"for name, args in {OOC!r}.items():\n"
        f"    sys.argv = ['sa_build'] + [a.format(dir={where!r}) for a in args]\n"
        "    print('=== ' + name, flush=True)\n"
        "    sa_build.main()\n")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for block in proc.stdout.split("=== ")[1:]:
        name, _, text = block.partition("\n")
        out[name] = _ooc_lines(text, where)
    return out


def _serve(module, ix, *extra):
    from test_torch_launch import _serve_lines

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", module, "--index-dir", ix, *extra,
                           "--pattern", "1,2,3", "--pattern", "4,4", "--pattern", "2"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _serve_lines(proc.stdout.splitlines())


@pytest.mark.parametrize("name", list(OOC))
def test_torchrun_out_of_core_prints_repros_lines(repro_ooc, tmp_path, name):
    """Four CPU ranks build out of core: rank 0 alone writes the index
    directory or the corpus file and prints repro's lines, walls and paths
    aside.  Then the query launcher serves the port's directory as repro's
    serves it."""
    where = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.sa_build",
         "--device", "cpu", *[a.format(dir=where) for a in OOC[name]]],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = _ooc_lines(proc.stdout.replace("repro_torch.launch", "repro.launch"), where)
    assert got == repro_ooc[name]
    assert got[0].startswith(("out-of-core: ", "wrote DIR/reads.sachunk"))
    assert "'dropped': 0" in got[-1] and "'superblocks': 3" in got[-1]
    assert sorted(os.listdir(where)) == (["ix"] if name == "index-resume"
                                         else ["reads.sachunk"])
    if name == "index-resume":
        assert "resume: 0 of 3 blocks recovered from the journal" in got
        ix = os.path.join(where, "ix")
        assert sorted(os.listdir(ix)) == ["corpus.sachunk", "lcp.npy", "manifest.json",
                                          "suffix_array.npy"]
        served = _serve("repro_torch.launch.serve", ix, "--device", "cpu")
        assert served == _serve("repro.launch.serve", ix) and len(served) >= 4
