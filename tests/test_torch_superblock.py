"""The pieces of the port's out-of-core build against ``repro``'s, on the CPU:
the superblock plan, the merge's store calls, the exact comparisons against
the store, the text-mode risk split and the device refiner.  Both packages
get the same numpy inputs; answers and every traffic counter must match."""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSuperblockConfig
from repro.core import pipeline as ref_pipeline
from repro.core import store as ref_store
from repro.core import superblock as ref_sb
from repro.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core import pipeline, store, superblock

K4 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4: deep ties
COUNTERS = ("requests", "request_bytes", "response_bytes", "retries", "rounds",
            "peak_windows", "frontier_bytes", "peak_resident_bytes")
SHAPES = [(10,), (1,), (7,), (100,), (9, 5), (40, 12)]
KNOBS = [
    dict(), dict(num_superblocks=1), dict(num_superblocks=3),
    dict(num_superblocks=6), dict(num_superblocks=64),
    dict(max_records_per_run=4), dict(max_records_per_run=30),
    dict(max_records_per_run=1000), dict(max_records_per_run=1),
    dict(num_superblocks=3, max_records_per_run=4),
]


def _text(seed=2, n=300):
    return np.random.default_rng(seed).integers(1, 5, size=(n,)).astype(np.int32)


def _reads(seed=0, r=30, l=10):
    return np.random.default_rng(seed).integers(1, 5, size=(r, l)).astype(np.int32)


def _var_reads(seed=2):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, size=(20,)).astype(np.int32)
    reads = np.zeros((20, 9), np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.integers(1, 5, size=(int(n),))
    return reads, lens


def _stores(corpus, cap):
    return (ref_store.CorpusStore(corpus, RefConfig(**K4), request_capacity=cap),
            store.CorpusStore(corpus, SAConfig(**K4), request_capacity=cap,
                              device="cpu"))


def _same_counters(a, b):
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), name
    assert a.backend.cache_hits == b.backend.cache_hits
    assert a.backend.cache_misses == b.backend.cache_misses
    assert a.backend.hit_rate == b.backend.hit_rate
    assert a.backend.corpus_bytes == b.backend.corpus_bytes


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _all_suffixes(corpus):
    if corpus.ndim == 1:
        return naive_sa_text(corpus)
    return naive_sa_reads(corpus)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_plan_superblocks_matches_repro(shape, knobs):
    """Every field, and the same warnings, for the knobs of
    ``test_num_superblocks_matches_plan`` plus a budget under an explicit
    split (the "ignored" warning)."""
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = ref_sb.plan_superblocks(shape, RefConfig(**K4),
                                       RefSuperblockConfig(**knobs))
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = superblock.plan_superblocks(shape, SAConfig(**K4),
                                          SuperblockConfig(**knobs))
    assert got.__dict__ == want.__dict__
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]


def test_corpus_shape_of_array_and_backend():
    reads = _reads()
    backend = store.InMemoryBackend(reads, SAConfig(**K4), device="cpu")
    assert superblock.corpus_shape_of(reads) == (30, 10)
    assert superblock.corpus_shape_of(backend) == (30, 10)
    assert superblock.corpus_shape_of(_text()) == (300,)
    # a chunked corpus file reports its header's geometry, as in repro; a
    # missing file raises as repro's does
    import tempfile

    from repro.core.superblock import corpus_shape_of as ref_shape_of
    from repro_torch.data.chunk_store import write_chunked_corpus

    with tempfile.TemporaryDirectory() as d:
        for corpus in (reads, _text()):
            path = os.path.join(d, f"c{corpus.ndim}.sachunk")
            write_chunked_corpus(corpus, path, chunk_items=7)
            assert superblock.corpus_shape_of(path) == corpus.shape == ref_shape_of(path)
        missing = os.path.join(d, "corpus.sachunk")
        with pytest.raises(FileNotFoundError):
            ref_shape_of(missing)
        with pytest.raises(FileNotFoundError):
            superblock.corpus_shape_of(missing)


# ---------------------------------------------------------------------------
# the merge's store calls
# ---------------------------------------------------------------------------


def _merge_inputs(mode):
    rng = np.random.default_rng(3)
    if mode == "text":
        corpus = _text(seed=4, n=200)
        gidx = rng.integers(0, corpus.size, 40).astype(np.int64)
    else:
        corpus, _ = _var_reads()
        sb = int(np.ceil(np.log2(corpus.shape[1] + 1)))
        gidx = ((rng.integers(0, corpus.shape[0], 40) << sb)
                | rng.integers(0, corpus.shape[1] + 1, 40)).astype(np.int64)
    return corpus, gidx


@pytest.mark.parametrize("cap", [3, 4096])
@pytest.mark.parametrize("mode", ["text", "reads"])
def test_fetch_keys_and_frontier_match_repro(mode, cap):
    corpus, gidx = _merge_inputs(mode)
    want_st, got_st = _stores(corpus, cap)
    for depth in (0, 1, 3):
        wk, we = want_st.fetch_keys(gidx, depth)
        gk, ge = got_st.fetch_keys(_t(gidx), depth)
        np.testing.assert_array_equal(gk.numpy(), wk)
        np.testing.assert_array_equal(ge.numpy(), we)
    for delta in (1000, -300, 64, -764):
        want_st.add_frontier(delta)
        got_st.add_frontier(delta)
    # the executor's split fetch: gather on one side, account on the other
    wk, we = want_st.gather_keys(gidx[:17], 2)
    gk, ge = got_st.gather_keys(_t(gidx[:17]), 2)
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(ge.numpy(), we)
    _same_counters(want_st, got_st)  # gather_keys counts nothing
    want_st.note_fetched(17)
    got_st.note_fetched(17)
    empty = np.zeros(0, np.int64)
    want_st.fetch_keys(empty, 0)
    got_st.fetch_keys(_t(empty), 0)
    _same_counters(want_st, got_st)


def test_rank_windows_matches_repro():
    rng = np.random.default_rng(4)
    want_st, got_st = _stores(np.ones(16, np.int32), 4096)
    keys = rng.integers(0, 5, size=(300, 3)).astype(np.int32)  # many ties
    keys[::5] = rng.integers(-(2**31), 2**31 - 1, size=(60, 3))
    gidx = rng.permutation(300).astype(np.int64) * (1 << 33)  # two index words
    want = want_st.rank_windows(keys, gidx)
    got = got_st.rank_windows(_t(keys), _t(gidx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [3, 4096])
def test_mget_window_host_matches_repro(cap):
    """Whole groups served in order up to the capacity, an oversized leading
    group alone; unserved actives count as retries."""
    corpus, gidx = _merge_inputs("reads")
    rng = np.random.default_rng(6)
    group = np.sort(rng.integers(0, 12, gidx.size)).astype(np.int64)
    group = np.maximum.accumulate(
        np.where(np.concatenate([[True], group[1:] != group[:-1]]),
                 np.arange(gidx.size), 0))
    depth = rng.integers(0, 3, gidx.size).astype(np.int64)
    want_st, got_st = _stores(corpus, cap)
    for active in (rng.random(gidx.size) < 0.7, np.zeros(gidx.size, bool),
                   np.ones(gidx.size, bool)):
        ww, wo = want_st.mget_window_host(gidx, depth, active, group)
        gw, go = got_st.mget_window_host(_t(gidx), _t(depth), _t(active), _t(group))
        np.testing.assert_array_equal(gw.numpy(), ww)
        np.testing.assert_array_equal(go.numpy(), wo)
    _same_counters(want_st, got_st)
    if cap == 3:
        assert got_st.retries > 0


# ---------------------------------------------------------------------------
# exact comparisons against the store
# ---------------------------------------------------------------------------


REFINE_CASES = {
    "text": (_text(seed=7, n=160), None),
    "atat": (np.tile(np.array([1, 2], np.int32), 60), None),
    "reads": (_reads(), None),
    "variable": _var_reads(),
}


@pytest.mark.parametrize("cap", [3, 4096])
@pytest.mark.parametrize("name", sorted(REFINE_CASES))
def test_refine_sort_matches_repro(name, cap):
    corpus, lengths = REFINE_CASES[name]
    full = (naive_sa_text(corpus) if corpus.ndim == 1
            else naive_sa_reads(corpus, lengths))
    sub = np.random.default_rng(8).choice(full, size=min(60, full.size),
                                          replace=False)
    want_st, got_st = _stores(corpus, cap)
    want = ref_sb._refine_sort(want_st, sub)
    got = superblock._refine_sort(got_st, _t(sub)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full[np.isin(full, sub)])
    _same_counters(want_st, got_st)


def test_less_than_pivot_window_cached_across_chunks():
    """The pivot's windows are fetched once per depth, not once per capacity
    chunk (``tests/test_superblock.py``'s case on the port)."""
    text = np.ones(20, np.int32)
    gidx = torch.arange(1, 9, dtype=torch.int64)
    one_chunk = store.CorpusStore(text, SAConfig(**K4), request_capacity=64,
                                  device="cpu")
    chunked = store.CorpusStore(text, SAConfig(**K4), request_capacity=4,
                                device="cpu")
    assert superblock._less_than(one_chunk, gidx, 0).all()
    assert superblock._less_than(chunked, gidx, 0).all()
    assert one_chunk.requests == chunked.requests == 41
    assert chunked.request_bytes == one_chunk.request_bytes == 41 * 4


@pytest.mark.parametrize("cap", [3, 4096])
@pytest.mark.parametrize("name", ["text", "atat", "variable"])
def test_less_than_matches_repro(name, cap):
    corpus, lengths = REFINE_CASES[name]
    full = (naive_sa_text(corpus) if corpus.ndim == 1
            else naive_sa_reads(corpus, lengths))
    rng = np.random.default_rng(9)
    sub = rng.choice(full, size=40, replace=False)
    want_st, got_st = _stores(corpus, cap)
    for pivot in rng.choice(full, size=3, replace=False):
        want = ref_sb._less_than(want_st, sub, int(pivot))
        got = superblock._less_than(got_st, _t(sub), int(pivot))
        np.testing.assert_array_equal(got.numpy(), want)
    _same_counters(want_st, got_st)


@pytest.mark.parametrize("cap,samples", [(16, 2), (7, 1), (500, 32)])
@pytest.mark.parametrize("name", ["text", "atat"])
def test_sorted_runs_match_repro(name, cap, samples):
    """Splitter partition into pieces of at most ``cap`` records, each
    refined exactly: the same pieces and the same store traffic."""
    corpus, _ = REFINE_CASES[name]
    full = naive_sa_text(corpus)
    sub = np.random.default_rng(10).choice(full, size=90, replace=False)
    want_st, got_st = _stores(corpus, 5)
    want = ref_sb._sorted_runs(want_st, sub, cap, samples,
                               lambda g: ref_sb._refine_sort(want_st, g))
    got = superblock._sorted_runs(got_st, _t(sub), cap, samples,
                                  lambda g: superblock._refine_sort(got_st, g))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.shape[0] <= cap
    np.testing.assert_array_equal(torch.cat(got).numpy(), full[np.isin(full, sub)])
    _same_counters(want_st, got_st)


@pytest.mark.parametrize("stats", [
    [dict(rounds=2, unresolved=0)] * 3,
    [dict(rounds=9, unresolved=0), dict(rounds=1, unresolved=3),
     dict(rounds=4, unresolved=0)],
    [dict(rounds=100, unresolved=0)] * 3,
], ids=["shallow", "unresolved-block", "all-at-risk"])
def test_split_boundary_risk_matches_repro(stats):
    text = _text(seed=11, n=240)
    sb = SuperblockConfig(num_superblocks=3)
    plan = superblock.plan_superblocks(text.shape, SAConfig(**K4), sb)
    rng = np.random.default_rng(12)
    sas = [rng.permutation(np.arange(lo, hi)).astype(np.int64)
           for lo, hi in plan.blocks]
    want_runs, want_risk = ref_sb._split_boundary_risk(plan, sas, stats, 4)
    got_runs, got_risk = superblock._split_boundary_risk(
        plan, [_t(s) for s in sas], stats, 4)
    np.testing.assert_array_equal(got_risk.numpy(), want_risk)
    assert len(got_runs) == len(want_runs)
    for g, w in zip(got_runs, want_runs, strict=True):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# the device refiner (merge_backend="device")
# ---------------------------------------------------------------------------


def _subset(full, size, seed):
    return np.random.default_rng(seed).choice(full, size=size, replace=False)


@pytest.mark.parametrize("name", ["reads", "atat", "variable"])
def test_refine_indices_matches_repro(name):
    """``tests/test_refiner.py``'s corpora and subsets: the oracle's order
    of the subset, as repro's refiner gives it."""
    corpus, lengths = {
        "reads": (_reads(), None),
        "atat": (np.tile(np.array([1, 2], np.int32), 60), None),
        "variable": _var_reads(),
    }[name]
    full = (naive_sa_text(corpus) if corpus.ndim == 1
            else naive_sa_reads(corpus, lengths))
    sub = _subset(full, min(60, full.size), 1)
    want = ref_pipeline.refine_indices(corpus, sub, cfg=RefConfig(**K4),
                                       lengths=lengths)
    got = pipeline.refine_indices(corpus, sub, cfg=SAConfig(**K4),
                                  lengths=lengths, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full[np.isin(full, sub)])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
def test_device_refiner_counters_match_repro(use_pallas):
    """Batches padded to a power of two as the JAX refiner pads them: the
    same requests, bytes, rounds and peak over several calls."""
    reads = _reads(seed=3, r=24, l=8)
    full = naive_sa_reads(reads)
    want_r = ref_pipeline.DeviceRefiner(reads, RefConfig(**K4, use_pallas=use_pallas))
    got_r = pipeline.DeviceRefiner(reads, SAConfig(**K4, use_pallas=use_pallas),
                                   device="cpu")
    for size, seed in ((2, 0), (3, 1), (30, 2), (17, 3), (1, 4)):
        sub = _subset(full, size, seed)
        np.testing.assert_array_equal(got_r.refine(_t(sub)).numpy(),
                                      want_r.refine(sub))
    for name in ("requests", "request_bytes", "response_bytes", "rounds",
                 "peak_records", "calls"):
        assert getattr(got_r, name) == getattr(want_r, name), name
