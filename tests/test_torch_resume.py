"""The port's build journal and resume (``repro_torch.core.journal`` and the
journaled regime of ``repro_torch.core.superblock``) against ``repro``'s, on
the CPU, at ``tests/test_crash_resume.py``'s corpus and configuration
(48 x 12 reads, ``chars_per_word=2``, ``key_words=2``, S = 4, LCP,
``pipeline_depth=1``, the sanitizer on).

A port build killed at every pipeline point, on the memory and the chunked
store, resumes to ``repro``'s uninterrupted build: the same suffix array,
LCP array and ``Footprint``.  Its stats (wall times aside) equal those of
``repro`` resuming a copy of the same killed state, so ``journal_hits`` is
``repro``'s for the same kill.  The journal is an on-disk format: the
port's records equal ``repro``'s for the same build but the run file
names, the two writers give the same bytes, and a build killed under
either package resumes in the other.
"""
import dataclasses
import filecmp
import json
import os
import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.journal as ref_journal
import repro.core.superblock as ref_sbmod
import repro_torch.core.journal as port_journal
import repro_torch.core.superblock as port_sbmod
from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSB
from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core import store as port_store
from repro_torch.core.integrity import CorruptionError
from repro_torch.core.journal import JOURNAL_NAME, BuildJournal, verify_spilled_run

KW = dict(vocab_size=4, chars_per_word=2, key_words=2)
S = 4
BACKENDS = ("memory", "chunked")
# every label the pipelined out-of-core build announces
PIPELINE_POINTS = (
    "spill:drain", "stage:collect", "build:block", "sink:append",
    "merge:refill", "merge:rank", "merge:collect", "merge:emit",
)
# past the spill drain and the forced journal flush: every block record is
# durable, so a resume rebuilds no block
POST_DRAIN_POINTS = ("merge:refill", "merge:rank", "merge:collect",
                     "merge:emit", "sink:append")
PACKAGES = {
    "repro": (ref_sbmod, RefConfig, RefSB, {}),
    "port": (port_sbmod, SAConfig, SuperblockConfig, {"device": "cpu"}),
}


def _corpus():
    rng = np.random.default_rng(7)
    return rng.integers(1, 5, size=(48, 12)).astype(np.int32)


def _sb(pkg, spill_dir, backend, **kw):
    """``tests/test_crash_resume.py``'s journaled configuration, in either
    package's ``SuperblockConfig``."""
    kw.setdefault("sanitize", True)
    kw.setdefault("pipeline_depth", 1)
    return PACKAGES[pkg][2](
        num_superblocks=S, store_backend=backend, spill_dir=str(spill_dir),
        resume=True, cache_budget_bytes=_corpus().size * 4 // 2,
        emit_lcp=True, **kw)


def _build(pkg, corpus, sb):
    mod, cfg, _, extra = PACKAGES[pkg]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.build_suffix_array_superblock(corpus, cfg=cfg(**KW), sb=sb, **extra)


class _Kill(Exception):
    pass


def _probe(mp, pkg, on_label):
    """Patch the package's superblock-module binding of ``pipeline_point``
    (imported there by name) to call ``on_label`` after each point."""
    mod = PACKAGES[pkg][0]
    orig = mod.pipeline_point

    def probe(lbl):
        orig(lbl)
        on_label(lbl)

    mp.setattr(mod, "pipeline_point", probe)


def _run_with_kill(pkg, corpus, sb, label, at):
    """Build, raising ``_Kill`` at the ``at``-th occurrence of ``label``."""
    seen = {"n": 0}

    def on_label(lbl):
        if lbl == label:
            seen["n"] += 1
            if seen["n"] == at:
                raise _Kill(label)

    with pytest.MonkeyPatch.context() as mp:
        _probe(mp, pkg, on_label)
        with pytest.raises(_Kill):
            _build(pkg, corpus, sb)


def _count_labels(pkg, corpus, sb):
    counts = {}

    def on_label(lbl):
        counts[lbl] = counts.get(lbl, 0) + 1

    with pytest.MonkeyPatch.context() as mp:
        _probe(mp, pkg, on_label)
        res = _build(pkg, corpus, sb)
    return counts, res


def _kept(res):
    """What a build must reproduce: SA, LCP, Footprint, stats but walls."""
    return (np.asarray(res.suffix_array).copy(),
            None if res.lcp is None else np.asarray(res.lcp).copy(),
            dataclasses.asdict(res.footprint),
            {k: v for k, v in res.stats.items() if not k.startswith("t_")})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """``repro``'s uninterrupted journaled, sanitized build on each store,
    with the count of each pipeline point it announced (built once)."""
    out = {}
    for backend in BACKENDS:
        d = tmp_path_factory.mktemp(f"ref_{backend}")
        counts, res = _count_labels("repro", _corpus(), _sb("repro", d, backend))
        out[backend] = (counts, _kept(res))
    return out


def _assert_equals_uninterrupted(res, want, resumed):
    sa, lcp, fp, stats = _kept(res)
    np.testing.assert_array_equal(sa, want[0])
    np.testing.assert_array_equal(lcp, want[1])
    assert fp == want[2]
    # an adopted block is neither rebuilt nor spilled again
    moved = ("journal_hits", "spilled_runs", "spilled_bytes") if resumed else ()
    assert ({k: v for k, v in stats.items() if k not in moved}
            == {k: v for k, v in want[3].items() if k not in moved})


# ---------------------------------------------------------------------------
# the kill-and-resume sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_uninterrupted_journaled_build_matches_repro(ref, tmp_path, backend):
    """The port's journaled, sanitized build announces every pipeline point
    as often as ``repro``'s does and gives its SA, LCP, Footprint and stats;
    success retires the journal."""
    counts, res = _count_labels("port", _corpus(), _sb("port", tmp_path, backend))
    want_counts, want = ref[backend]
    assert counts == want_counts
    assert set(counts) == set(PIPELINE_POINTS)
    _assert_equals_uninterrupted(res, want, resumed=False)
    assert res.stats["journaled"] and res.stats["sanitized"]
    assert res.stats["journal_hits"] == 0
    assert not os.path.exists(tmp_path / JOURNAL_NAME)


@pytest.mark.parametrize("label", PIPELINE_POINTS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_kill_and_resume_at_every_pipeline_point(ref, tmp_path, backend, label):
    """Kill the port's build at the label's last occurrence (the most
    completed work at risk), resume it, and resume a copy of the killed
    state with ``repro``: the port's result is ``repro``'s uninterrupted
    build, its stats are ``repro``'s resumed build's (the same
    ``journal_hits``), and a post-drain kill recovers every block."""
    corpus = _corpus()
    counts, want = ref[backend]
    d = tmp_path / "port"
    sb = _sb("port", d, backend)
    _run_with_kill("port", corpus, sb, label, at=counts[label])
    jpath = d / JOURNAL_NAME
    assert jpath.exists(), f"{label}: no journal left to resume"
    shutil.copytree(d, tmp_path / "repro")
    res = _build("port", corpus, sb)
    other = _build("repro", corpus, _sb("repro", tmp_path / "repro", backend))
    _assert_equals_uninterrupted(res, want, resumed=True)
    assert _kept(res)[3] == _kept(other)[3]
    assert res.stats["journaled"]
    if label in POST_DRAIN_POINTS:
        assert res.stats["journal_hits"] == res.stats["superblocks"] == S
    if backend == "chunked":
        assert res.footprint.peak_resident_bytes <= sb.cache_budget_bytes
    assert not jpath.exists()  # success retires the journal
    assert not (d / "scratch").exists()


def test_resume_skips_completed_blocks(ref, tmp_path):
    """Killed after the spill drain: every block record is durable, and the
    resumed build rebuilds none of them (``build:block`` never fires)."""
    corpus = _corpus()
    sb = _sb("port", tmp_path, "chunked")
    _run_with_kill("port", corpus, sb, "merge:rank", at=1)
    counts, res = _count_labels("port", corpus, sb)
    assert "build:block" not in counts and "stage:collect" not in counts
    assert res.stats["journal_hits"] == res.stats["superblocks"] == S
    _assert_equals_uninterrupted(res, ref["chunked"][1], resumed=True)


def test_double_kill_then_resume(ref, tmp_path):
    """Two crashes at different points still resume to the exact build:
    the journal's records accumulate across attempts."""
    corpus = _corpus()
    sb = _sb("port", tmp_path, "chunked")
    _run_with_kill("port", corpus, sb, "build:block", at=2)
    _run_with_kill("port", corpus, sb, "merge:emit", at=1)
    res = _build("port", corpus, sb)
    assert res.stats["journal_hits"] == res.stats["superblocks"]
    _assert_equals_uninterrupted(res, ref["chunked"][1], resumed=True)


def test_resume_refuses_mismatched_fingerprint(tmp_path):
    """A journal of a different corpus is never resumed against."""
    corpus = _corpus()
    sb = _sb("port", tmp_path, "chunked")
    _run_with_kill("port", corpus, sb, "merge:rank", at=1)
    other = corpus.copy()
    other[0, 0] = 3 if other[0, 0] != 3 else 2
    with pytest.raises(ValueError, match="fingerprint"):
        _build("port", other, sb)
    # repro refuses the port's journal of the first corpus the same way
    with pytest.raises(ValueError, match="fingerprint"):
        _build("repro", other, _sb("repro", tmp_path, "chunked"))


def test_resume_detects_corrupt_spilled_run(tmp_path):
    """A journaled run whose bytes no longer match its journaled crc is a
    ``CorruptionError`` naming the run, never a silent rebuild."""
    corpus = _corpus()
    sb = _sb("port", tmp_path, "chunked")
    _run_with_kill("port", corpus, sb, "merge:rank", at=1)
    rec = next(r for r in BuildJournal.load(str(tmp_path / JOURNAL_NAME))
               if r.get("t") == "block")
    run_path = tmp_path / "scratch" / rec["run"]
    with open(run_path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CorruptionError, match="spilled run"):
        _build("port", corpus, sb)


def test_resume_detects_corrupt_journal_record(tmp_path):
    corpus = _corpus()
    sb = _sb("port", tmp_path, "chunked")
    _run_with_kill("port", corpus, sb, "merge:rank", at=1)
    jpath = tmp_path / JOURNAL_NAME
    lines = jpath.read_bytes().split(b"\n")
    lines[1] = lines[1].replace(b'"t":"block"', b'"t":"clock"')
    jpath.write_bytes(b"\n".join(lines))
    with pytest.raises(CorruptionError, match="build journal record 1"):
        _build("port", corpus, sb)


def test_resume_refuses_a_journal_not_opened_by_begin(tmp_path):
    """A valid journal whose first record is not ``begin`` is corrupt."""
    corpus = _corpus()
    sb = _sb("port", tmp_path, "memory")
    _run_with_kill("port", corpus, sb, "merge:rank", at=1)
    jpath = str(tmp_path / JOURNAL_NAME)
    records = BuildJournal.load(jpath)
    os.unlink(jpath)
    j = BuildJournal(jpath).open()
    for rec in records[1:]:
        j.append(rec)
    j.close()
    with pytest.raises(CorruptionError, match="first record is not 'begin'"):
        _build("port", corpus, sb)


def test_journaled_success_retires_journal_and_scratch(tmp_path):
    sb = _sb("port", tmp_path, "chunked")
    _build("port", _corpus(), sb)
    assert not (tmp_path / JOURNAL_NAME).exists()
    assert not (tmp_path / "scratch").exists()


def test_journaled_resume_composes_with_retry_layer(ref, tmp_path):
    """A flaky but retried journaled build killed mid-merge resumes with the
    same flaky medium to the uninterrupted build."""
    corpus = _corpus()
    sb = _sb("port", tmp_path, "memory", store_retries=3, store_backoff_s=0.0)
    cfg = SAConfig(**KW)
    flaky = port_store.FlakyBackend(port_store.InMemoryBackend(corpus, cfg, device="cpu"),
                                    fail_every=5, failures_per_call=1)
    _run_with_kill("port", flaky, sb, "merge:rank", at=1)
    res = _build("port", flaky, sb)
    flaky.close()
    assert flaky.injected > 0 and res.stats["store_retry_attempts"] > 0
    assert res.stats["journal_hits"] == res.stats["superblocks"]
    sa, lcp, fp, _ = _kept(res)
    np.testing.assert_array_equal(sa, ref["memory"][1][0])
    np.testing.assert_array_equal(lcp, ref["memory"][1][1])
    assert fp == ref["memory"][1][2]


# ---------------------------------------------------------------------------
# the journal as an on-disk format
# ---------------------------------------------------------------------------


RECORDS = [
    {"t": "begin", "v": 1, "fp": {"items": 48, "row_len": 12, "text_mode": False,
                                   "head_crc": 123456789}},
    {"t": "block", "i": 0, "run": "run_ab12cd34_0.npy", "run_crc": 4294967295,
     "rows": 169, "stats": {"num_suffixes": np.int64(169), "rounds": 2,
                            "per_device_counts": np.array([169, 0]),
                            "ok": np.bool_(True), "ratio": np.float32(0.5),
                            "label": "héllo", "none": None}},
    {"t": "emit", "rows": 17},
    {"t": "done", "rows": 624},
]


@pytest.mark.parametrize("durable", [True, False], ids=["durable", "batched"])
def test_journal_writers_give_the_same_bytes(tmp_path, durable):
    """The same records, numpy scalars and arrays among them, give the same
    file from either package's writer, and either package loads it."""
    paths = {}
    for name, mod in (("repro", ref_journal), ("port", port_journal)):
        paths[name] = str(tmp_path / f"{name}.journal")
        j = mod.BuildJournal(paths[name]).open()
        for rec in RECORDS:
            j.append(rec, durable=durable)
        j.close()
        assert j.appended == len(RECORDS)
    assert filecmp.cmp(paths["port"], paths["repro"], shallow=False)
    assert (port_journal.BuildJournal.load(paths["repro"])
            == ref_journal.BuildJournal.load(paths["port"]))
    assert port_journal.JOURNAL_NAME == ref_journal.JOURNAL_NAME


def _write(path, records):
    j = BuildJournal(str(path)).open()
    for rec in records:
        j.append(rec)
    j.close()
    return path.read_bytes()


@pytest.mark.parametrize("cut", [1, 7, -1], ids=["one-byte", "mid-line", "newline"])
def test_journal_drops_a_torn_tail(tmp_path, cut):
    """A crash mid-append leaves a torn last line: it is dropped, as repro
    drops it, and the records before it load."""
    path = tmp_path / "j"
    raw = _write(path, RECORDS)
    last = raw.rstrip(b"\n").rfind(b"\n") + 1
    torn = raw[: last + cut] if cut > 0 else raw[:-1]
    path.write_bytes(torn)
    want = RECORDS[:-1] if cut > 0 else RECORDS
    got = BuildJournal.load(str(path))
    assert got == ref_journal.BuildJournal.load(str(path))
    assert [r["t"] for r in got] == [r["t"] for r in want]
    assert got[1]["stats"]["per_device_counts"] == [169, 0]


def test_journal_raises_on_interior_corruption(tmp_path):
    path = tmp_path / "j"
    lines = _write(path, RECORDS).split(b"\n")
    lines[2] = lines[2].replace(b'"rows":17', b'"rows":18')
    path.write_bytes(b"\n".join(lines))
    with pytest.raises(CorruptionError, match="build journal record 2"):
        BuildJournal.load(str(path))
    lines[2] = b"not json"
    path.write_bytes(b"\n".join(lines))
    with pytest.raises(CorruptionError, match="build journal record 2"):
        BuildJournal.load(str(path))
    assert BuildJournal.load(str(tmp_path / "missing")) == []


def test_journal_finalize_removes_the_file(tmp_path):
    path = tmp_path / "j"
    j = BuildJournal(str(path)).open()
    j.append(RECORDS[0])
    j.finalize()
    assert not path.exists()


def test_verify_spilled_run(tmp_path):
    from repro_torch.core.integrity import crc32_array

    run = np.arange(50, dtype=np.int64) * 7
    path = str(tmp_path / "run_0.npy")
    np.save(path, run)
    np.testing.assert_array_equal(verify_spilled_run(path, crc32_array(run), "r"), run)
    with pytest.raises(CorruptionError, match="spilled run x.*crc"):
        verify_spilled_run(path, crc32_array(run) ^ 1, "spilled run x")
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY")
    with pytest.raises(CorruptionError, match="unreadable"):
        verify_spilled_run(path, 0, "spilled run x")


def _records(spill_dir):
    """A finished build's journal (kept by the patched ``finalize``), its
    block records without their run file names and record crcs."""
    out = []
    for line in (spill_dir / JOURNAL_NAME).read_text().splitlines():
        rec = json.loads(line)
        if rec["t"] == "block":
            assert rec.pop("run").startswith("run_")
            rec.pop("crc")  # covers the run name
        out.append(rec)
    return out


@pytest.mark.parametrize("corpus,backend", [
    ("reads", "memory"), ("reads", "chunked"), ("text", "memory"),
])
def test_journal_records_match_repro(tmp_path, monkeypatch, corpus, backend):
    """The port's journal of a build is ``repro``'s for the same build, but
    the run file names: the fingerprint, every block's crc, rows, stats and
    footprint contributions, every emit watermark and the done record."""
    from repro_torch.data.corpus import synth_token_corpus

    data = _corpus() if corpus == "reads" else synth_token_corpus(600, 4, seed=5)[0]
    for mod in (ref_journal, port_journal):
        monkeypatch.setattr(mod.BuildJournal, "finalize", mod.BuildJournal.close)
    got = {}
    for pkg in PACKAGES:
        _build(pkg, data, _sb(pkg, tmp_path / pkg, backend))
        got[pkg] = _records(tmp_path / pkg)
    assert got["port"] == got["repro"]
    kinds = [r["t"] for r in got["port"]]
    assert kinds[: S + 1] == ["begin"] + ["block"] * S and kinds[-1] == "done"
    assert {type(v) for r in got["port"] if r["t"] == "block"
            for v in r["stats"].values()} <= {int, list}


@pytest.mark.parametrize("killed,resumed", [("repro", "port"), ("port", "repro")],
                         ids=["repro-to-port", "port-to-repro"])
def test_a_killed_build_resumes_in_the_other_package(ref, tmp_path, killed, resumed):
    """A build killed under one package resumes under the other, adopting
    every journaled block, to the uninterrupted build."""
    corpus = _corpus()
    _run_with_kill(killed, corpus, _sb(killed, tmp_path, "chunked"), "merge:rank", at=1)
    res = _build(resumed, corpus, _sb(resumed, tmp_path, "chunked"))
    assert res.stats["journal_hits"] == S
    _assert_equals_uninterrupted(res, ref["chunked"][1], resumed=True)
