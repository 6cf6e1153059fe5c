"""The port's runtime sanitizer (``repro_torch.core.sanitize``) against
``repro.core.sanitize``, on the CPU: seeded accounting leaks, broken LRU
budgets, corrupted windows on every gather route (``gather``,
``gather_host``, ``window``) and out-of-order merge emissions are detected;
clean runs pass with the JAX sanitizer's check counts; a sanitized build
equals ``repro``'s sanitized build (SA, LCP, Footprint, stats but walls,
the sanitizer's own counters) and the unsanitized build's output.
"""
# salint: disable-file=SAL002
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.sanitize as ref_san
import repro.core.superblock as ref_sbmod
import repro_torch.core.superblock as port_sbmod
from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSB
from repro.core import store as ref_store
from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core.oracle import naive_sa_text
from repro_torch.core.sanitize import (
    SanitizeError,
    SanitizingBackend,
    SanitizingSink,
    check_footprint,
    sanitize_enabled,
    unwrap_backend,
)
from repro_torch.core.store import ChunkedFileBackend, CorpusStore, InMemoryBackend
from repro_torch.data.chunk_store import write_chunked_corpus

KW = dict(vocab_size=4, chars_per_word=2, key_words=2)
CFG = SAConfig(**KW)
REF_CFG = RefConfig(**KW)


def _text(n=400, seed=3):
    return np.random.default_rng(seed).integers(1, 5, size=(n,)).astype(np.int32)


def _chunked_backend(tmp_path, n=400, chunk_items=64, seed=3):
    text = _text(n, seed)
    path = str(tmp_path / "corpus.sachunk")
    write_chunked_corpus(text, path, chunk_items=chunk_items)
    return text, ChunkedFileBackend(path, CFG, device="cpu")


def _both_chunked(tmp_path, sample=4):
    """The same chunked corpus file behind the port's and repro's
    sanitizers."""
    text, backend = _chunked_backend(tmp_path)
    ref = ref_store.ChunkedFileBackend(str(tmp_path / "corpus.sachunk"), REF_CFG)
    return (text, SanitizingBackend(backend, sample=sample),
            ref_san.SanitizingBackend(ref, sample=sample))


def _counters(wrapped):
    inner = unwrap_backend(wrapped)
    return (wrapped.checks, wrapped.oracle_windows_checked,
            wrapped.observed_peak_bytes, inner.cache_hits, inner.cache_misses,
            inner.resident_bytes)


# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------


def test_sanitize_enabled_sources(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize_enabled()
    assert not sanitize_enabled(SuperblockConfig())
    assert sanitize_enabled(SuperblockConfig(sanitize=True))
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize_enabled()
    assert sanitize_enabled(SuperblockConfig())  # env wins even with sb off


def test_unwrap_backend(tmp_path):
    _, backend = _chunked_backend(tmp_path)
    try:
        wrapped = SanitizingBackend(SanitizingBackend(backend))
        assert unwrap_backend(wrapped) is backend
        assert unwrap_backend(backend) is backend
        assert wrapped.per_round and wrapped.host_windows
        assert not SanitizingBackend(InMemoryBackend(_text(), CFG, device="cpu")).host_windows
    finally:
        backend.close()


# ---------------------------------------------------------------------------
# backend proxy: clean pass-through + seeded-defect detection
# ---------------------------------------------------------------------------


def test_clean_backend_passes_and_matches_repro(tmp_path):
    """Every route gives the in-memory windows, and the checks, the oracle
    windows and the cache counters are repro's sanitizer's over the same
    calls."""
    text, wrapped, ref = _both_chunked(tmp_path)
    mem = InMemoryBackend(text, CFG, device="cpu")
    try:
        gidx = np.arange(0, 400, 7, dtype=np.int64)
        for depth in (0, 1, 3):
            d = np.full(gidx.shape, depth, np.int64)
            want = mem.gather(torch.from_numpy(gidx), torch.from_numpy(d)).numpy()
            got = wrapped.gather(torch.from_numpy(gidx), torch.from_numpy(d))
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(wrapped.gather_host(gidx, d), want)
            for g in gidx[:5].tolist():
                np.testing.assert_array_equal(wrapped.window(g, depth), want[gidx == g][0])
            # repro's backend has one route: gather, once a call of the port's
            np.testing.assert_array_equal(ref.gather(gidx, d), want)
            np.testing.assert_array_equal(ref.gather(gidx, d), want)
            for g in gidx[:5].tolist():
                ref.gather(np.array([g], np.int64), np.array([depth], np.int64))
        assert wrapped.checks > 0 and wrapped.oracle_windows_checked > 0
        assert _counters(wrapped) == _counters(ref)
        # geometry and counters delegate transparently
        assert wrapped.n == unwrap_backend(wrapped).n
        assert wrapped.shape == unwrap_backend(wrapped).shape
        assert wrapped.cache_hits == unwrap_backend(wrapped).cache_hits
    finally:
        wrapped.close()
        ref.close()


@pytest.mark.parametrize("store_backend", ["memory", "chunked"])
def test_store_fetches_through_the_sanitizer_match_repro(tmp_path, store_backend):
    """A ``CorpusStore`` calls the sanitizer one capacity chunk a call, as
    repro's store calls its backend: the same windows, store counters,
    checks and cache counters."""
    text, wrapped, ref = _both_chunked(tmp_path)
    if store_backend == "memory":
        wrapped = SanitizingBackend(InMemoryBackend(text, CFG, device="cpu"))
        ref = ref_san.SanitizingBackend(ref_store.InMemoryBackend(text, REF_CFG))
    port = CorpusStore(None, CFG, backend=wrapped, request_capacity=16)
    want = ref_store.CorpusStore(None, REF_CFG, backend=ref, request_capacity=16)
    gidx = np.random.default_rng(1).integers(0, 400, size=100).astype(np.int64)
    for depth in (0, 2):
        got_k, got_e = port.fetch_keys(torch.from_numpy(gidx), depth)
        want_k, want_e = want.fetch_keys(gidx, depth)
        np.testing.assert_array_equal(got_k.numpy(), want_k)
        np.testing.assert_array_equal(got_e.numpy(), want_e)
    for g in gidx[:7].tolist():
        assert port.fetch_key(g, 1)[0] == tuple(want.fetch_keys(np.array([g]), 1)[0][0])
    assert _counters(wrapped) == _counters(ref)
    assert ((port.requests, port.rounds, port.request_bytes, port.response_bytes,
             port.peak_resident_bytes)
            == (want.requests, want.rounds, want.request_bytes, want.response_bytes,
                want.peak_resident_bytes))
    wrapped.close()


def test_detects_accounting_leak(tmp_path):
    _, backend = _chunked_backend(tmp_path)
    wrapped = SanitizingBackend(backend)
    try:
        gidx = torch.arange(10)
        wrapped.gather(gidx, torch.zeros(10, dtype=torch.int64))  # clean: passes
        backend._resident += 4096  # seeded leak: claim more than is live
        with pytest.raises(SanitizeError, match="accounting leak"):
            wrapped.gather(gidx, torch.zeros(10, dtype=torch.int64))
    finally:
        backend.close()


def test_detects_budget_violation(tmp_path):
    _, backend = _chunked_backend(tmp_path)
    wrapped = SanitizingBackend(backend)
    try:
        gidx = np.arange(10, dtype=np.int64)
        wrapped.gather_host(gidx, np.zeros(10, np.int64))
        # a budget below what is resident: a correct LRU is never here
        backend.cache_budget_bytes = backend.resident_bytes - 1
        with pytest.raises(SanitizeError, match="budget invariant"):
            wrapped.gather_host(gidx, np.zeros(10, np.int64))
    finally:
        backend.close()


def _corrupt(backend):
    """Corrupt the windows a backend serves, in place, leaving its
    accounting balanced: only the uncached oracle read can catch this."""
    if isinstance(backend, InMemoryBackend):
        backend.padded[:] = (backend.padded % 4) + 1
    else:
        chunk = backend._cache[0]
        chunk[:] = (chunk % 4) + 1


def _route(wrapped, route, gidx):
    if route == "gather":
        return wrapped.gather(torch.from_numpy(gidx), torch.zeros(gidx.size,
                                                                  dtype=torch.int64))
    if route == "gather_host":
        return wrapped.gather_host(gidx, np.zeros(gidx.size, np.int64))
    return [wrapped.window(int(g), 0) for g in gidx]


@pytest.mark.parametrize("backend_kind,route", [
    ("chunked", "gather"), ("chunked", "gather_host"), ("chunked", "window"),
    ("memory", "gather"), ("memory", "window"),
])
def test_detects_corrupted_window_on_every_route(tmp_path, backend_kind, route):
    """A corrupted cache chunk (chunked store) or device corpus (in-memory
    store) is caught on each gather route the store and the k-way cursor
    take."""
    text, backend = _chunked_backend(tmp_path)
    if backend_kind == "memory":
        backend.close()
        backend = InMemoryBackend(text, CFG, device="cpu")
    wrapped = SanitizingBackend(backend, sample=64)
    try:
        gidx = np.arange(0, 64, dtype=np.int64)
        _route(wrapped, route, gidx)  # clean: populates chunk 0
        _corrupt(backend)
        with pytest.raises(SanitizeError, match="uncached"):
            _route(wrapped, route, gidx)
    finally:
        backend.close()


def test_read_items_must_not_touch_cache(tmp_path):
    _, backend = _chunked_backend(tmp_path)
    wrapped = SanitizingBackend(backend)
    try:
        out = wrapped.read_items(5, 25)  # clean staging: no cache effect
        assert out.shape == (20,)
        orig = backend.read_items

        def bad_read(lo, hi):
            backend._chunk(0)  # a faulty backend warming its cache in staging
            return orig(lo, hi)

        backend.read_items = bad_read
        with pytest.raises(SanitizeError, match="residency"):
            wrapped.read_items(5, 25)
    finally:
        backend.close()


# ---------------------------------------------------------------------------
# merge-order sink
# ---------------------------------------------------------------------------


class _ListSink:
    def __init__(self):
        self.pieces = []

    def append(self, piece):
        self.pieces.append(np.asarray(piece))


def _text_store_backend():
    text = np.random.default_rng(5).integers(1, 5, size=(120,)).astype(np.int32)
    return text, InMemoryBackend(text, CFG, device="cpu")


def _piece(sa, kind):
    return torch.from_numpy(np.ascontiguousarray(sa)) if kind == "tensor" else sa


PIECES = ["array", "tensor"]


@pytest.mark.parametrize("kind", PIECES)
def test_sink_accepts_true_order_and_delegates(kind):
    """The true order in ragged pieces passes (seams checked too), with
    repro's sink's pair count and the same backend counters."""
    text, backend = _text_store_backend()
    ref_backend = ref_store.InMemoryBackend(text, REF_CFG)
    sa = naive_sa_text(text)
    sink = SanitizingSink(_ListSink(), backend, CFG, sample=8)
    want = ref_san.SanitizingSink(_ListSink(), ref_backend, REF_CFG, sample=8)
    for lo, hi in ((0, 13), (13, 50), (50, 90), (90, len(sa))):
        sink.append(_piece(sa[lo:hi], kind))
        want.append(sa[lo:hi])
    assert sink.pairs_checked == want.pairs_checked > 0
    assert backend.cache_hits == ref_backend.cache_hits
    assert sum(p.size for p in sink.pieces) == len(sa)  # delegated attr


@pytest.mark.parametrize("kind", PIECES)
def test_sink_detects_out_of_order_within_piece(kind):
    text, backend = _text_store_backend()
    sa = naive_sa_text(text).copy()
    sa[10], sa[11] = sa[11], sa[10]  # seeded inversion
    sink = SanitizingSink(_ListSink(), backend, CFG, sample=len(sa))
    with pytest.raises(SanitizeError, match="out-of-order"):
        sink.append(_piece(sa, kind))


@pytest.mark.parametrize("kind", PIECES)
def test_sink_detects_out_of_order_at_seam(kind):
    text, backend = _text_store_backend()
    sa = naive_sa_text(text)
    sink = SanitizingSink(_ListSink(), backend, CFG, sample=2)
    sink.append(_piece(sa[40:], kind))  # second half first: the seam fires
    with pytest.raises(SanitizeError, match="out-of-order"):
        sink.append(_piece(sa[:40], kind))


@pytest.mark.parametrize("kind", PIECES)
def test_sink_detects_duplicate_emission(kind):
    text, backend = _text_store_backend()
    sa = naive_sa_text(text)
    sink = SanitizingSink(_ListSink(), backend, CFG)
    sink.append(_piece(sa[:5], kind))
    with pytest.raises(SanitizeError, match="duplicate"):
        sink.append(_piece(np.concatenate([[sa[4]], sa[5:10]]), kind))


def test_sink_ties_break_by_index():
    """Equal suffixes (two equal reads) order by global index; the reverse
    order is caught."""
    reads = np.array([[1, 2, 3], [1, 2, 3]], np.int32)
    backend = InMemoryBackend(reads, CFG, device="cpu")
    a, b = 0, 1 << backend.stride_bits  # the two reads' first suffixes
    SanitizingSink(_ListSink(), backend, CFG).append(np.array([a, b]))
    with pytest.raises(SanitizeError, match="non-index order"):
        SanitizingSink(_ListSink(), backend, CFG).append(np.array([b, a]))


# ---------------------------------------------------------------------------
# footprint cross-check
# ---------------------------------------------------------------------------


def test_check_footprint_clean_and_seeded(tmp_path):
    _, backend = _chunked_backend(tmp_path)
    try:
        store = CorpusStore(None, CFG, backend=backend)
        store.fetch_windows(torch.arange(20), 0)
        check_footprint(store)  # a clean store passes
        store.frontier_bytes = -8  # seeded under-release
        with pytest.raises(SanitizeError, match="frontier"):
            check_footprint(store)
        store.frontier_bytes = 0
        backend._resident += 64  # seeded backend leak
        with pytest.raises(SanitizeError, match="accounting leak"):
            check_footprint(store)
    finally:
        backend.close()


def test_check_footprint_detects_a_missed_peak(tmp_path):
    """A peak below the current residency means a fetch went unnoted."""
    _, backend = _chunked_backend(tmp_path)
    try:
        store = CorpusStore(None, CFG, backend=backend)
        store.fetch_windows(torch.arange(20), 0)
        store._note_resident = lambda: None  # seeded: the peak is never noted
        store.peak_resident_bytes = 0
        with pytest.raises(SanitizeError, match="peak_resident_bytes"):
            check_footprint(store)
    finally:
        backend.close()


# ---------------------------------------------------------------------------
# end to end: a sanitized build is repro's sanitized build
# ---------------------------------------------------------------------------


def _recording(monkeypatch, mod, cls):
    """Patch ``mod.SanitizingBackend``/``SanitizingSink`` to record their
    instances, so a build's sanitizer counters can be read."""
    made = []

    class Recorded(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(mod, cls.__name__, Recorded)
    return made


@pytest.mark.parametrize("algorithm", ["merge_path", "kway", "rerank"])
def test_sanitized_build_matches_repro(tmp_path, monkeypatch, algorithm):
    """``tests/test_sanitize.py``'s build (a 500-token text, S = 3, the
    chunked store, 64-token chunks) with the LCP: the port's sanitized
    build equals repro's (SA, LCP, Footprint, stats but walls, checks,
    oracle windows, pairs) and the unsanitized build's SA, LCP and
    Footprint; only the flag and the cache counters that the audit reads
    move, as in repro."""
    text = _text(500, seed=11)
    kw = dict(num_superblocks=3, store_backend="chunked", merge_algorithm=algorithm,
              chunk_records=64, emit_lcp=True)
    rec = {name: (_recording(monkeypatch, port_sbmod, getattr(port_sbmod, name)),
                  _recording(monkeypatch, ref_sbmod, getattr(ref_sbmod, name)))
           for name in ("SanitizingBackend", "SanitizingSink")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_sbmod.build_suffix_array_superblock(
            text, cfg=REF_CFG, sb=RefSB(spill_dir=str(tmp_path / "r"), sanitize=True, **kw))
    base = port_sbmod.build_suffix_array_superblock(
        text, cfg=CFG, sb=SuperblockConfig(spill_dir=str(tmp_path / "a"), **kw),
        device="cpu")
    san = port_sbmod.build_suffix_array_superblock(
        text, cfg=CFG, sb=SuperblockConfig(spill_dir=str(tmp_path / "b"), sanitize=True,
                                           **kw), device="cpu")
    for res in (base, want):
        np.testing.assert_array_equal(np.asarray(san.suffix_array),
                                      np.asarray(res.suffix_array))
        np.testing.assert_array_equal(np.asarray(san.lcp), np.asarray(res.lcp))
        assert dataclasses.asdict(san.footprint) == dataclasses.asdict(res.footprint)
    np.testing.assert_array_equal(np.asarray(san.suffix_array), naive_sa_text(text))
    walls = lambda st: {k: v for k, v in st.items() if not k.startswith("t_")}  # noqa: E731
    assert walls(san.stats) == walls(want.stats)
    moved = {"sanitized", "store_cache_hits", "store_cache_misses", "store_cache_hit_rate"}
    assert ({k: v for k, v in walls(san.stats).items() if k not in moved}
            == {k: v for k, v in walls(base.stats).items() if k not in moved})
    assert san.stats["sanitized"] and not base.stats["sanitized"]
    (port_b, ref_b), (port_s, ref_s) = rec["SanitizingBackend"], rec["SanitizingSink"]
    assert len(port_b) == len(ref_b) == 1 and len(port_s) == len(ref_s) == 1
    assert (port_b[0].checks, port_b[0].oracle_windows_checked,
            port_b[0].observed_peak_bytes) == (ref_b[0].checks,
                                               ref_b[0].oracle_windows_checked,
                                               ref_b[0].observed_peak_bytes)
    assert port_b[0].checks > 0
    assert port_s[0].pairs_checked == ref_s[0].pairs_checked > 0


@pytest.mark.parametrize("store_backend", ["memory", "chunked"])
def test_sanitizer_from_the_environment(tmp_path, monkeypatch, store_backend):
    """``REPRO_SANITIZE=1`` sanitizes a reads build on either store, as
    repro's, with the same output and stats."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    reads = np.random.default_rng(2).integers(1, 5, size=(30, 10)).astype(np.int32)
    kw = dict(num_superblocks=3, store_backend=store_backend, emit_lcp=True,
              cache_budget_bytes=reads.size * 4 // 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_sbmod.build_suffix_array_superblock(
            reads, cfg=REF_CFG, sb=RefSB(**kw))
    got = port_sbmod.build_suffix_array_superblock(
        reads, cfg=CFG, sb=SuperblockConfig(**kw), device="cpu")
    np.testing.assert_array_equal(np.asarray(got.suffix_array), want.suffix_array)
    np.testing.assert_array_equal(np.asarray(got.lcp), want.lcp)
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(want.footprint)
    assert ({k: v for k, v in got.stats.items() if not k.startswith("t_")}
            == {k: v for k, v in want.stats.items() if not k.startswith("t_")})
    assert got.stats["sanitized"]
