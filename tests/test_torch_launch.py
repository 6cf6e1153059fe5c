"""The port's launcher against ``repro.launch.sa_build`` at the same seed."""
import ast
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
    plan = [ln for ln in lines if ln.startswith("out-of-core: ")]
    stats = ast.literal_eval(next(ln for ln in lines if ln.startswith("stats: "))[7:])
    walls = {k: stats.pop(k) for k in ("t_stage_s", "t_build_s", "t_merge_s")
             if k in stats}
    return count, units, plan, stats, sorted(walls)


@pytest.mark.parametrize("flags", [
    ["--reads", "50", "--read-len", "20"],
    ["--text", "400", "--seed", "3"],
    ["--reads", "60", "--read-len", "20", "--superblocks", "3"],
    ["--text", "500", "--seed", "3", "--max-records-per-run", "150"],
    ["--reads", "40", "--read-len", "16", "--max-records-per-run", "300",
     "--merge-backend", "device", "--merge-tile", "8", "--pipeline-depth", "0"],
], ids=["reads", "text", "reads-superblocks", "text-budget", "reads-device-merge"])
def test_launcher_matches_repro(flags):
    """The same printout apart from the wall times, the ``out-of-core:``
    plan line included."""
    got = _run("repro_torch.launch.sa_build", "--device", "cpu", *flags)
    want = _run("repro.launch.sa_build", *flags)
    assert got == want
    assert bool(got[2]) == any(f.startswith(("--superblocks", "--max-records"))
                               for f in flags)


@pytest.mark.parametrize("flags,item", [
    (["--mode", "doubling"], "11"),
    (["--mode", "terasort"], "11"),
    (["--superblocks", "2", "--merge-algorithm", "kway"], "9b"),
    (["--max-records-per-run", "1000", "--store-retries", "2"], "9b"),
    (["--index-dir", "ix"], "8"),
    (["--corpus-file", "corpus.sachunk"], "8"),
    (["--resume"], "9b"),
    (["--store-backend", "chunked"], "8"),
    (["--merge-algorithm", "rerank"], "9b"),
    (["--cache-budget", "65536"], "8"),
], ids=["--mode0", "--mode1", "--superblocks", "--max-records-per-run",
        "--index-dir", "--corpus-file", "--resume", "--store-backend",
        "--merge-algorithm", "--cache-budget"])
def test_unported_flags_exit_nonzero(flags, item, capsys):
    """Flags of paths not ported yet exit naming their ROADMAP.md item; the
    out-of-core flags are ported, so those cases pair them with one that
    is not."""
    with pytest.raises(SystemExit) as e:
        sa_build.parse_args(flags)
    assert e.value.code != 0
    assert f"ROADMAP.md item {item})" in capsys.readouterr().err


def test_out_of_core_flags_parse_into_the_superblock_config():
    args = sa_build.parse_args(["--superblocks", "3", "--max-records-per-run", "9",
                                "--merge-backend", "device", "--merge-tile", "5",
                                "--pipeline-depth", "0"])
    sb = sa_build.make_superblock_config(args)
    assert (sb.num_superblocks, sb.max_records_per_run, sb.merge_backend,
            sb.merge_tile, sb.pipeline_depth) == (3, 9, "device", 5, 0)
    assert not sb.emit_lcp


def test_launcher_config_uses_kernels_on_the_card_only():
    assert sa_build.make_config("base", "cuda").use_pallas
    assert not sa_build.make_config("base", "cpu").use_pallas
    assert sa_build.make_config("bits", "cpu").packing == "bits"
