"""The port's query engine and ``SuffixArrayIndex`` vs ``repro.serve.sa_engine``
on the CPU: the same ranges, counts, positions and alignments, the same
LLCP/RLCP arrays and every ``engine_stats()`` / ``stats()`` key, bit for bit,
over random and repetitive text, variable-length reads and the boundary
patterns of ``tests/test_sa_engine.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSB
from repro.core.lcp import lcp_from_sa as ref_lcp_from_sa
from repro.core.store import CorpusStore as RefStore
from repro.serve import sa_engine as ref_engine
from repro_torch import SAConfig, ShardedSAEngine, SuffixArrayIndex, SuperblockConfig
from repro_torch.core.lcp import lcp_from_sa
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.core.store import CorpusStore, InMemoryBackend
from repro_torch.data.corpus import synth_dna_reads
from repro_torch.kernels import launch_counts


def _corpus(name):
    """(corpus, lengths, sa, vocab) of each ``tests/test_sa_engine.py`` kind."""
    rng = np.random.default_rng(5)
    if name == "random text":
        text = rng.integers(1, 4, 300).astype(np.int32)
        return text, None, naive_sa_text(text), 3
    if name == "repetitive text":
        text = np.tile(rng.integers(1, 3, 8).astype(np.int32), 40)
        return text, None, naive_sa_text(text), 2
    lens = rng.integers(1, 8, 16)
    reads = np.zeros((16, 7), np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.integers(1, 4, n)
    return reads, lens, naive_sa_reads(reads, lengths=lens), 3


def _patterns(corpus, seed=9, count=30):
    rng = np.random.default_rng(seed)
    flat = corpus.reshape(-1)
    pats = [flat[s : s + m].astype(np.int64)
            for s, m in zip(rng.integers(0, flat.size - 10, count),
                            rng.integers(1, 10, count), strict=True)]
    pats += [
        np.zeros(0, np.int64),                       # empty -> everything
        np.array([9], np.int64),                     # absent (over-vocab)
        np.array([0], np.int64),                     # collides with padding
        np.array([-2, 1], np.int64),
        np.concatenate([flat, [1]]).astype(np.int64),  # longer than corpus
        pats[0].copy(),                              # repeated in the batch
    ]
    return pats


def _engines(name, shards, with_lcp, use_pallas=False):
    corpus, _, sa, vocab = _corpus(name)
    rs = RefStore(corpus, RefConfig(vocab_size=vocab))
    ps = CorpusStore(corpus, SAConfig(vocab_size=vocab), device="cpu")
    ref = ref_engine.ShardedSAEngine(
        rs, sa, lcp=ref_lcp_from_sa(rs, sa) if with_lcp else None,
        num_shards=shards, use_pallas=use_pallas)
    port = ShardedSAEngine(ps, sa, lcp=lcp_from_sa(ps, sa) if with_lcp else None,
                           num_shards=shards, use_pallas=use_pallas)
    return corpus, ref, port


def _same_answers(corpus, ref, port, pats):
    np.testing.assert_array_equal(port.ranges(pats), ref.ranges(pats))
    np.testing.assert_array_equal(port.count(pats), ref.count(pats))
    for a, b in zip(port.locate(pats), ref.locate(pats), strict=True):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    if corpus.ndim == 2:
        assert port.align(pats) == ref.align(pats)
    assert port.engine_stats() == ref.engine_stats()


@pytest.mark.parametrize("with_lcp", [True, False], ids=["lcp", "no-lcp"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("name", ["random text", "repetitive text", "variable reads"])
def test_engine_matches_repro(name, shards, with_lcp):
    corpus, ref, port = _engines(name, shards, with_lcp)
    if with_lcp:
        np.testing.assert_array_equal(port._llcp.numpy(), ref._llcp)
        np.testing.assert_array_equal(port._rlcp.numpy(), ref._rlcp)
    np.testing.assert_array_equal(port.splitters.numpy(), ref.splitters)
    pats = _patterns(corpus)
    _same_answers(corpus, ref, port, pats)
    _same_answers(corpus, ref, port, pats[::-1])  # cache-served repeats


@pytest.mark.parametrize("name,shards", [("random text", 2), ("variable reads", 1)])
def test_engine_with_kernel_compare_matches_repro(name, shards):
    """``use_pallas``: the port's ``pattern_cmp`` dispatch (its plain version
    on CPU tensors) against the JAX kernel in interpret mode."""
    corpus, ref, port = _engines(name, shards, True, use_pallas=True)
    before = launch_counts()
    _same_answers(corpus, ref, port, _patterns(corpus, seed=2, count=6))
    assert launch_counts() == before


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 300])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_llcp_rlcp_equal_the_recursion(n, shards):
    """The level-by-level LLCP/RLCP == the JAX engine's recursion."""
    rng = np.random.default_rng(n * 10 + shards)
    text = rng.integers(1, 3, n).astype(np.int32)
    sa = np.arange(n, dtype=np.int64)
    lcp = rng.integers(0, 50, n).astype(np.int64)
    ref = ref_engine.ShardedSAEngine(RefStore(text, RefConfig(vocab_size=2)), sa,
                                     lcp=lcp, num_shards=shards)
    port = ShardedSAEngine(CorpusStore(text, SAConfig(vocab_size=2), device="cpu"),
                           sa, lcp=lcp, num_shards=shards)
    assert port.num_shards == ref.num_shards
    np.testing.assert_array_equal(port.bounds, ref.bounds)
    np.testing.assert_array_equal(port._llcp.numpy(), ref._llcp)
    np.testing.assert_array_equal(port._rlcp.numpy(), ref._rlcp)


def test_engine_result_cache_hits():
    """The mirror of ``tests/test_sa_engine.py::test_engine_result_cache_hits``."""
    rng = np.random.default_rng(3)
    text = rng.integers(1, 4, 200).astype(np.int32)
    sa = naive_sa_text(text)

    def engine():
        store = CorpusStore(text, SAConfig(vocab_size=3), device="cpu")
        return ShardedSAEngine(store, sa, lcp=lcp_from_sa(store, sa), num_shards=2)

    eng = engine()
    pats = [text[i : i + 4].astype(np.int64) for i in (0, 50, 100)]
    first = eng.count(pats)
    rounds = eng.stats["search_rounds"]
    again = eng.count(pats)
    np.testing.assert_array_equal(first, again)
    assert eng.stats["search_rounds"] == rounds  # pure cache service
    assert eng.cache.hits >= len(pats)
    cold = engine()
    cold.cache.budget = 0  # a zero-budget cache never serves hits
    cold.count(pats)
    cold.count(pats)
    assert cold.cache.hits == 0


@pytest.mark.parametrize("case", ["quickstart reads", "text 300"])
def test_index_matches_repro(case):
    if case == "quickstart reads":
        corpus = synth_dna_reads(64, 48, seed=1, paired_end=True)
        kw = dict(vocab_size=4)
    else:
        corpus = np.random.default_rng(5).integers(1, 4, 300).astype(np.int32)
        kw = dict(vocab_size=3, chars_per_word=2)
    port = SuffixArrayIndex.build(corpus, cfg=SAConfig(**kw), device="cpu",
                                  num_shards=2)
    ref = ref_engine.SuffixArrayIndex.build(corpus, cfg=RefConfig(**kw), num_shards=2)
    np.testing.assert_array_equal(port.sa, ref.sa)
    assert isinstance(port.lcp, np.ndarray)
    np.testing.assert_array_equal(port.lcp, np.asarray(ref.lcp))
    assert port.build_stats == ref.build_stats
    assert port.stats() == ref.stats()
    pats = _patterns(corpus, seed=4)
    np.testing.assert_array_equal(port.count(pats), ref.count(pats))
    assert port.count(pats[0]) == ref.count(pats[0])
    for a, b in zip(port.locate(pats), ref.locate(pats), strict=True):
        np.testing.assert_array_equal(a, b)
    if corpus.ndim == 2:
        assert port.align(pats) == ref.align(pats)
        assert port.align(list(pats[1])) == ref.align(list(pats[1]))
    else:
        with pytest.raises(ValueError, match="reads-mode"):
            port.align(pats[0])
    assert port.stats() == ref.stats()
    with port as idx:
        assert idx.stats()["backend"] == "InMemoryBackend"


def test_index_over_a_backend_matches_repro():
    corpus = np.random.default_rng(8).integers(1, 5, size=(20, 9)).astype(np.int32)
    cfg = SAConfig(vocab_size=4)
    backend = InMemoryBackend(corpus, cfg, device="cpu")
    port = SuffixArrayIndex.build(backend, cfg=cfg, device="cpu")
    assert port.store.backend is backend
    ref = ref_engine.SuffixArrayIndex.build(corpus, cfg=RefConfig(vocab_size=4))
    np.testing.assert_array_equal(port.lcp, np.asarray(ref.lcp))
    pats = _patterns(corpus, seed=1, count=8)
    assert port.align(pats) == ref.align(pats)


def test_index_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SuffixArrayIndex.build(np.ones((3, 4), np.int32), cfg=SAConfig(vocab_size=4))


@pytest.mark.parametrize("call,item", [
    ("open", 8), ("save", 8), ("index_dir", 8), ("path corpus", 8),
    ("sanitize", 9), ("superblocks", 9), ("resume", 9), ("store_retries", 9),
])
def test_unported_paths_raise(call, item, tmp_path, monkeypatch):
    """Every path here raised naming its ROADMAP item until it was ported.
    Item 8 (persistence) is ported: its calls now do what ``repro``'s do on
    the same input: opening a directory with no manifest and building from
    a missing corpus file raise ``FileNotFoundError``; ``save`` and
    ``build(index_dir=...)`` write a directory that reopens with the same
    answers.  So is item 9b: the k-way merge over several superblocks,
    store retries, the sanitizer (``REPRO_SANITIZE``, which also wraps the
    serving backend) and resume (journaled in the index directory): their
    indexes equal ``repro``'s."""
    reads = np.random.default_rng(0).integers(1, 5, size=(12, 6)).astype(np.int32)
    cfg = SAConfig(vocab_size=4)
    build = lambda corpus=reads, **kw: SuffixArrayIndex.build(  # noqa: E731
        corpus, cfg=cfg, device="cpu", **kw)
    if item == 8:
        pats = [reads[2, 1:4], reads[5, :3], np.array([4, 4], np.int64)]
        want = ref_engine.SuffixArrayIndex.build(reads, cfg=RefConfig(vocab_size=4))
        if call in ("open", "path corpus"):
            with pytest.raises(FileNotFoundError):
                ref_engine.SuffixArrayIndex.build(
                    str(tmp_path / "corpus.sachunk"), cfg=RefConfig(vocab_size=4))
            with pytest.raises(FileNotFoundError):
                if call == "open":
                    SuffixArrayIndex.open(str(tmp_path), device="cpu")
                else:
                    build(corpus=str(tmp_path / "corpus.sachunk"))
            return
        ix = str(tmp_path / "ix")
        if call == "save":
            build().save(ix)
        else:
            build(index_dir=ix).close()
        with SuffixArrayIndex.open(ix, device="cpu") as idx:
            assert idx.align(pats) == want.align(pats)
        return
    sb = {"superblocks": dict(num_superblocks=3, merge_algorithm="kway"),
          "store_retries": dict(store_retries=2), "sanitize": {},
          "resume": dict(num_superblocks=3, resume=True)}[call]
    dirs = {"got": {}, "want": {}}
    if call == "resume":
        dirs = {k: dict(index_dir=str(tmp_path / k)) for k in dirs}
    if call == "sanitize":
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    want = ref_engine.SuffixArrayIndex.build(reads, cfg=RefConfig(vocab_size=4),
                                             sb=RefSB(**sb), **dirs["want"])
    got = build(sb=SuperblockConfig(**sb), **dirs["got"])
    np.testing.assert_array_equal(got.sa, np.asarray(want.sa))
    np.testing.assert_array_equal(got.lcp, np.asarray(want.lcp))
    walls = [k for k in want.build_stats if k.startswith("t_")] + ["index_dir"]
    assert ({k: v for k, v in got.build_stats.items() if k not in walls}
            == {k: v for k, v in want.build_stats.items() if k not in walls})
    pats = [reads[2, 1:4], reads[5, :3], np.array([4, 4], np.int64)]
    assert got.align(pats) == want.align(pats)
    assert got.stats()["backend"] == want.stats()["backend"]
    if call == "sanitize":
        assert got.stats()["backend"] == "SanitizingBackend"
        assert got.store.backend.checks == want.store.backend.checks > 0
    if call == "resume":
        assert got.build_stats["journaled"] and got.build_stats["journal_hits"] == 0
    got.close()


def test_superblock_config_carries_across():
    """A JAX run's ``SuperblockConfig`` drives the port's build unchanged."""
    from repro_torch.config import superblock_config_from_reference

    sb = superblock_config_from_reference(dataclasses.asdict(RefSB(request_capacity=5)))
    reads = np.random.default_rng(2).integers(1, 5, size=(10, 6)).astype(np.int32)
    port = SuffixArrayIndex.build(reads, cfg=SAConfig(vocab_size=4), sb=sb, device="cpu")
    assert port.store.request_capacity == 5
    assert port.build_stats["emit_lcp"]
