"""The port's launcher against ``repro.launch.sa_build`` at the same seed."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch import sa_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stdout(module, *args, cwd=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def _run(module, *args, cwd=None):
    return _parsed(_stdout(module, *args, cwd=cwd))


def _parsed(lines):
    """A launcher printout's suffix count, unit lines, plan line, stats
    without the walls, and the walls' names."""
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
    ["--superblocks", "2", "--merge-algorithm", "kway"],
    ["--corpus-file", "corpus.sachunk", "--store-retries", "2"],
    ["--store-backend", "chunked", "--merge-algorithm", "kway"],
    ["--merge-algorithm", "rerank"],
    ["--reads", "60", "--read-len", "20", "--superblocks", "3",
     "--merge-algorithm", "rerank", "--store-retries", "2"],
], ids=["reads", "text", "reads-superblocks", "text-budget", "reads-device-merge",
        "--superblocks", "--corpus-file", "--store-backend", "--merge-algorithm",
        "reads-rerank-retries"])
def test_launcher_matches_repro(flags, tmp_path):
    """The same printout apart from the wall times, the ``out-of-core:``
    plan line included (run in a fresh directory: ``--corpus-file`` names a
    file there, written by the first run and read by the second)."""
    got = _run("repro_torch.launch.sa_build", "--device", "cpu", *flags, cwd=tmp_path)
    want = _run("repro.launch.sa_build", *flags, cwd=tmp_path)
    assert got == want
    assert bool(got[2]) == any(f.startswith(("--superblocks", "--max-records"))
                               for f in flags)


RESUME_ERROR = "--resume requires --index-dir (the journal lives there)"
INDEX_DIR_ERROR = "--index-dir requires --mode scheme"


@pytest.mark.parametrize("flags,error", [
    (["--mode", "doubling"], None),
    (["--mode", "terasort"], None),
    (["--max-records-per-run", "1000", "--store-retries", "2", "--resume"], RESUME_ERROR),
    (["--index-dir", "ix", "--resume", "--mode", "terasort"], INDEX_DIR_ERROR),
    (["--resume"], RESUME_ERROR),
    (["--cache-budget", "65536", "--mode", "doubling"], None),
], ids=["--mode0", "--mode1", "--max-records-per-run", "--index-dir", "--resume",
        "--cache-budget"])
def test_unported_flags_exit_nonzero(flags, error, capsys):
    """Every flag of ``repro.launch.sa_build`` is ported: the flag sets that
    repro's launcher refuses exit non-zero with repro's error (``--index-dir``
    is checked before ``--resume``, in repro's order), and the terasort and
    doubling modes (``error`` None) parse."""
    if error is None:
        args = sa_build.parse_args(flags)
        assert args.mode == flags[flags.index("--mode") + 1]
        return
    with pytest.raises(SystemExit) as e:
        sa_build.parse_args(flags)
    assert e.value.code != 0
    assert capsys.readouterr().err.strip().endswith(error)


def test_resume_without_index_dir_exits_as_repro(capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "repro.launch.sa_build", "--reads", "20",
                           "--resume"], capture_output=True, text=True, env=env,
                          timeout=600)
    with pytest.raises(SystemExit) as e:
        sa_build.parse_args(["--reads", "20", "--resume"])
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert (e.value.code, err.split(": error: ")[1]) == (
        proc.returncode, proc.stderr.strip().splitlines()[-1].split(": error: ")[1])
    assert proc.returncode == 2 and err.endswith(RESUME_ERROR)


def test_resume_flag_matches_repro(tmp_path):
    """``--index-dir D --resume``: a journaled build with repro's printout,
    its ``resume:`` line included, and repro's index files."""
    got = {}
    for module, extra in (("repro.launch.sa_build", []),
                          ("repro_torch.launch.sa_build", ["--device", "cpu"])):
        ix = str(tmp_path / module.split(".")[0])
        flags = ["--reads", "40", "--read-len", "18", "--superblocks", "3",
                 "--index-dir", ix, "--resume", *extra]
        lines = _stdout(module, *flags)
        got[module] = ([ln for ln in lines if ln.startswith("resume: ")], _parsed(lines), ix)
    (lines, stats, gix), (wlines, wstats, wix) = (got["repro_torch.launch.sa_build"],
                                                  got["repro.launch.sa_build"])
    assert lines == wlines == ["resume: 0 of 3 blocks recovered from the journal"]
    assert stats[3].pop("index_dir") == gix and wstats[3].pop("index_dir") == wix
    assert stats == wstats and stats[3]["journaled"]
    import filecmp

    for name in ("suffix_array.npy", "lcp.npy"):
        assert filecmp.cmp(os.path.join(gix, name), os.path.join(wix, name),
                           shallow=False)


def test_resume_after_a_kill(tmp_path, monkeypatch, capsys):
    """A launcher build killed in its merge, run again with the same flags,
    recovers every block from the journal and writes repro's index."""
    import repro_torch.core.superblock as sbmod

    ix = str(tmp_path / "ix")
    flags = ["--device", "cpu", "--reads", "40", "--read-len", "18",
             "--superblocks", "3", "--index-dir", ix, "--resume"]
    orig = sbmod.pipeline_point

    def kill(label):
        orig(label)
        if label == "merge:rank":
            raise KeyboardInterrupt(label)

    monkeypatch.setattr(sbmod, "pipeline_point", kill)
    with pytest.raises(KeyboardInterrupt):
        sa_build.main(flags)
    assert os.path.exists(os.path.join(ix, "build.journal"))
    monkeypatch.setattr(sbmod, "pipeline_point", orig)
    capsys.readouterr()
    sa_build.main(flags)
    assert "resume: 3 of 3 blocks recovered from the journal" in capsys.readouterr().out
    wix = str(tmp_path / "want")
    _stdout("repro.launch.sa_build", "--reads", "40", "--read-len", "18",
            "--superblocks", "3", "--index-dir", wix)
    import filecmp

    for name in ("suffix_array.npy", "lcp.npy"):
        assert filecmp.cmp(os.path.join(ix, name), os.path.join(wix, name),
                           shallow=False)
    assert not os.path.exists(os.path.join(ix, "build.journal"))


def test_out_of_core_flags_parse_into_the_superblock_config():
    args = sa_build.parse_args(["--superblocks", "3", "--max-records-per-run", "9",
                                "--merge-backend", "device", "--merge-tile", "5",
                                "--pipeline-depth", "0", "--merge-algorithm", "kway",
                                "--store-retries", "4"])
    sb = sa_build.make_superblock_config(args)
    assert (sb.num_superblocks, sb.max_records_per_run, sb.merge_backend,
            sb.merge_tile, sb.pipeline_depth, sb.merge_algorithm,
            sb.store_retries) == (3, 9, "device", 5, 0, "kway", 4)
    assert not sb.emit_lcp and not sb.resume
    args = sa_build.parse_args(["--index-dir", "ix", "--resume"])
    sb = sa_build.make_superblock_config(args)
    assert sb.resume and sb.spill_dir == "ix" and sb.write_manifest


def test_launcher_config_uses_kernels_on_the_card_only():
    assert sa_build.make_config("base", "cuda").use_pallas
    assert not sa_build.make_config("base", "cpu").use_pallas
    assert sa_build.make_config("bits", "cpu").packing == "bits"


def _streaming_lines(lines, index_dir=None):
    """The launcher's lines beyond ``_run``'s: the corpus-file, streaming
    and index lines (the index path and the serving module named there
    replaced), and the stats' index path."""
    out = []
    for ln in lines:
        if ln.startswith(("wrote ", "streaming: ", "index: ")):
            if index_dir:
                ln = ln.replace(index_dir, "IX").replace("repro_torch.", "repro.")
            out.append(ln.split(": ", 1)[1] if ln.startswith("wrote ") else ln)
    return out


@pytest.mark.parametrize("flags", [
    ["--reads", "60", "--read-len", "20", "--superblocks", "3",
     "--store-backend", "chunked", "--cache-budget", "8000"],
    ["--text", "600", "--seed", "3", "--max-records-per-run", "200",
     "--store-backend", "chunked", "--cache-budget", "4096", "--chunk-records", "40"],
], ids=["reads-streaming", "text-streaming"])
def test_streaming_flags_match_repro(flags):
    got = _run("repro_torch.launch.sa_build", "--device", "cpu", *flags)
    want = _run("repro.launch.sa_build", *flags)
    assert got == want
    assert got[3]["store_backend"] == "chunked"
    assert got[3]["peak_resident_bytes"] <= int(flags[flags.index("--cache-budget") + 1])


def test_index_dir_and_corpus_file_match_repro(tmp_path):
    """``--corpus-file`` (written on first use, then read) and
    ``--index-dir``: the same printout and the same index files as repro."""
    outs = {}
    for module, extra in (("repro.launch.sa_build", []),
                          ("repro_torch.launch.sa_build", ["--device", "cpu"])):
        tag = module.split(".")[0]
        corpus_file = str(tmp_path / f"{tag}.sachunk")
        ix = str(tmp_path / f"{tag}-ix")
        flags = ["--reads", "40", "--read-len", "18", "--superblocks", "2",
                 "--corpus-file", corpus_file, "--index-dir", ix, *extra]
        first = _stdout(module, *flags)
        second = _stdout(module, *flags)  # the corpus file exists now
        assert any(ln.startswith("wrote ") for ln in first)
        assert not any(ln.startswith("wrote ") for ln in second)
        outs[tag] = (_streaming_lines(first, ix), _streaming_lines(second, ix),
                     ix, corpus_file)
    (g1, g2, gix, gcf), (w1, w2, wix, wcf) = outs["repro_torch"], outs["repro"]
    assert g1 == w1 and g2 == w2
    import filecmp

    assert filecmp.cmp(gcf, wcf, shallow=False)
    for name in ("suffix_array.npy", "lcp.npy"):
        assert filecmp.cmp(os.path.join(gix, name), os.path.join(wix, name),
                           shallow=False)


def _serve_lines(lines):
    """The serve printout without its wall times."""
    out = []
    for ln in lines:
        if ln.startswith("opened "):
            ln = ln.rsplit(" (", 1)[0]
        elif ln.startswith(("served ", "  per-query latency")):
            continue
        out.append(ln)
    return out


@pytest.mark.parametrize("flags", [
    ["--queries", "200", "--batch", "32"],
    ["--queries", "150", "--batch", "16", "--store-backend", "memory",
     "--verify", "eager", "--seed", "4", "--hot-fraction", "0.5"],
    ["--pattern", "1,2,3", "--pattern", "4,4", "--pattern", "2"],
    ["--shards", "2", "--pattern", "1,2,3", "--pattern", "2,2", "--pattern", "4"],
    ["--shards", "2", "--queries", "100", "--batch", "16"],
    ["--shards", "3", "--queries", "120", "--batch", "32", "--store-backend",
     "memory"],
], ids=["load", "load-memory-eager", "patterns", "patterns-shards2",
        "load-shards2", "load-memory-shards3"])
def test_serve_matches_repro(tmp_path, flags):
    """``repro_torch.launch.serve`` over an index directory written by
    repro: the same printout as ``repro.launch.serve`` apart from walls."""
    ix = str(tmp_path / "ix")
    _stdout("repro.launch.sa_build", "--reads", "50", "--read-len", "20",
            "--index-dir", ix)
    got = _serve_lines(_stdout("repro_torch.launch.serve", "--device", "cpu",
                               "--index-dir", ix, *flags))
    want = _serve_lines(_stdout("repro.launch.serve", "--index-dir", ix, *flags))
    assert got == want and len(got) >= 3


def test_serve_refuses_more_than_one_shard(tmp_path, capsys):
    """No shard count is refused: shards are logical slices of one suffix
    array (``repro.serve.sa_engine.ShardedSAEngine``), so ``--shards 2``
    parses and serves on the CPU, and the engine has two shards."""
    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.launch import serve
    from repro_torch.serve.sa_engine import SuffixArrayIndex

    assert serve.parse_args(["--index-dir", "ix", "--shards", "2"]).shards == 2
    ix = str(tmp_path / "ix")
    reads = synth_dna_reads(30, 16, seed=3)
    SuffixArrayIndex.build(reads, index_dir=ix, device="cpu").close()
    serve.main(["--device", "cpu", "--index-dir", ix, "--shards", "2",
                "--queries", "40", "--batch", "8"])
    out = capsys.readouterr().out
    assert "served 40 queries" in out
    assert "  shards=2 " in out
