"""The port's launcher against ``repro.launch.sa_build`` at the same seed."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch import sa_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    count = next(ln.split("suffixes=")[1].split()[0] for ln in lines
                 if "suffixes=" in ln)
    units = [ln for ln in lines if ln.startswith("  ")]
    stats = next(ln for ln in lines if ln.startswith("stats: "))
    return count, units, stats


@pytest.mark.parametrize("flags", [
    ["--reads", "50", "--read-len", "20"],
    ["--text", "400", "--seed", "3"],
], ids=["reads", "text"])
def test_launcher_matches_repro(flags):
    got = _run("repro_torch.launch.sa_build", "--device", "cpu", *flags)
    want = _run("repro.launch.sa_build", *flags)
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--mode", "doubling"],
    ["--mode", "terasort"],
    ["--superblocks", "2"],
    ["--max-records-per-run", "1000"],
    ["--index-dir", "ix"],
    ["--corpus-file", "corpus.sachunk"],
    ["--resume"],
    ["--store-backend", "chunked"],
], ids=lambda f: f[0])
def test_unported_flags_exit_nonzero(flags, capsys):
    with pytest.raises(SystemExit) as e:
        sa_build.parse_args(flags)
    assert e.value.code != 0
    assert "ROADMAP.md item" in capsys.readouterr().err


def test_launcher_config_uses_kernels_on_the_card_only():
    assert sa_build.make_config("base", "cuda").use_pallas
    assert not sa_build.make_config("base", "cpu").use_pallas
    assert sa_build.make_config("bits", "cpu").packing == "bits"
