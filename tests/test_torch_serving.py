"""The port's serving store, LCP and host-serial search vs ``repro``: the same
key words, windows and traffic counters, the same LCP arrays and the same
search answers, bit for bit, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.core import lcp as ref_lcp
from repro.core import search as ref_search
from repro.core import store as ref_store
from repro_torch.config import SAConfig
from repro_torch.core import lcp, search, store
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.kernels.cases import PACK_CFGS, PACK_IDS


def _text(seed=5, n=300, vocab=3):
    return np.random.default_rng(seed).integers(1, vocab + 1, n).astype(np.int32)


def _atat():
    return np.tile(np.array([1, 2, 1, 2], np.int32), 40)


def _var_reads(seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, size=(30,))
    reads = np.zeros((30, 11), np.int32)
    for i, n in enumerate(lens):
        reads[i, : min(n, 11)] = rng.integers(1, 3, size=(min(n, 11),))
    return reads, np.minimum(lens, 11)


def _stores(corpus, cap=4096, **kw):
    kw = {"vocab_size": 3, **kw}
    return (ref_store.CorpusStore(corpus, RefConfig(**kw), request_capacity=cap),
            store.CorpusStore(corpus, SAConfig(**kw), request_capacity=cap,
                              device="cpu"))


COUNTERS = ("requests", "request_bytes", "response_bytes", "rounds",
            "peak_windows", "peak_resident_bytes")


def _same_counters(a, b):
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), name
    assert a.backend.cache_hits == b.backend.cache_hits
    assert a.backend.resident_bytes == b.backend.resident_bytes


@pytest.mark.parametrize("kw", PACK_CFGS, ids=PACK_IDS)
def test_pack_keys_and_lex_less_rows_match_repro(kw):
    cfg = SAConfig(**kw)
    rng = np.random.default_rng(cfg.prefix_len)
    win = rng.integers(0, kw["vocab_size"] + 1, size=(200, cfg.prefix_len))
    win[:20] = 0
    win[20:40, cfg.prefix_len // 2 :] = 0
    got = store.pack_keys(torch.from_numpy(win), cfg).numpy()
    want = ref_store.pack_keys_np(win, RefConfig(**kw))
    np.testing.assert_array_equal(got, want)
    a, b = want, want[rng.permutation(200)]
    for mine, ref in zip(store.lex_less_rows(torch.from_numpy(a), torch.from_numpy(b)),
                         ref_store.lex_less_rows(a, b), strict=True):
        np.testing.assert_array_equal(mine.numpy(), ref)


@pytest.mark.parametrize("cap", [3, 4096])
@pytest.mark.parametrize("mode", ["text", "reads"])
def test_fetch_windows_matches_repro(mode, cap):
    if mode == "text":
        corpus = _text()
        gidx = np.random.default_rng(2).integers(0, corpus.size, 50)
    else:
        corpus, _ = _var_reads()
        sb = int(np.ceil(np.log2(corpus.shape[1] + 1)))
        rng = np.random.default_rng(2)
        gidx = (rng.integers(0, corpus.shape[0], 50) << sb) | rng.integers(
            0, corpus.shape[1] + 1, 50)
    rs, ps = _stores(corpus, cap=cap, chars_per_word=2)
    assert ps.max_window_depth == rs.max_window_depth
    for depth in range(ps.max_window_depth + 1):
        got = ps.fetch_windows(torch.from_numpy(gidx), depth)
        np.testing.assert_array_equal(got.numpy(), rs.fetch_windows(gidx, depth))
        _same_counters(rs, ps)
    per_row = np.arange(gidx.size) % (ps.max_window_depth + 1)
    np.testing.assert_array_equal(ps.fetch_windows(gidx, per_row).numpy(),
                                  rs.fetch_windows(gidx, per_row))
    ps.fetch_windows(gidx[:0], 0)
    rs.fetch_windows(gidx[:0], 0)
    _same_counters(rs, ps)
    np.testing.assert_array_equal(ps.stage_items(2, 9), rs.stage_items(2, 9))
    assert (ps.staged_items, ps.staged_bytes) == (rs.staged_items, rs.staged_bytes)


@pytest.mark.parametrize("batch", [1, 7, 1 << 16])
@pytest.mark.parametrize("case", ["random text", "ATAT text", "variable reads"])
def test_lcp_matches_repro(case, batch):
    if case == "variable reads":
        corpus, lens = _var_reads()
        sa = naive_sa_reads(corpus, lens)
    else:
        corpus = _text() if case == "random text" else _atat()
        sa = naive_sa_text(corpus)
    rs, ps = _stores(corpus, cap=5)
    got = lcp.lcp_from_sa(ps, sa, batch=batch)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref_lcp.lcp_from_sa(rs, sa, batch=batch))
    _same_counters(rs, ps)
    np.testing.assert_array_equal(
        lcp.pairwise_lcp(ps, sa[::2][:-1], sa[1::2][: sa[::2].size - 1]).numpy(),
        ref_lcp.pairwise_lcp(rs, sa[::2][:-1], sa[1::2][: sa[::2].size - 1]))
    _same_counters(rs, ps)


@pytest.mark.parametrize("mode", ["text", "reads"])
def test_search_matches_repro(mode):
    if mode == "text":
        corpus = _text(seed=8, n=200)
        sa = naive_sa_text(corpus)
        flat = corpus
    else:
        corpus, lens = _var_reads(seed=4)
        sa = naive_sa_reads(corpus, lens)
        flat = corpus.reshape(-1)
    rs, ps = _stores(corpus, chars_per_word=2)
    rng = np.random.default_rng(6)
    pats = [flat[s : s + m].astype(np.int64)
            for s, m in zip(rng.integers(0, flat.size - 9, 20), rng.integers(1, 9, 20),
                            strict=True)]
    pats += [np.zeros(0, np.int64), np.array([9], np.int64), np.array([0], np.int64),
             np.array([1, 2, 7, 1], np.int64), np.array([2, -1], np.int64),
             np.ones(40, np.int64)]
    for p in pats:
        live = p[(p >= 1) & (p <= 3)] if p.size else p
        got = search.suffix_pattern_cmp(ps, sa, live).numpy()
        np.testing.assert_array_equal(got, ref_search.suffix_pattern_cmp(rs, sa, live))
        assert search.search_store(ps, sa, p) == ref_search.search_store(rs, sa, p)
        assert search.count_store(ps, sa, p) == ref_search.count_store(rs, sa, p)
        np.testing.assert_array_equal(search.locate_store(ps, sa, p),
                                      ref_search.locate_store(rs, sa, p))
    _same_counters(rs, ps)


def test_store_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        store.CorpusStore(_text(), SAConfig(vocab_size=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        store.InMemoryBackend(_text(), SAConfig(vocab_size=3))
