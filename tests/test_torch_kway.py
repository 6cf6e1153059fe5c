"""The port's k-way and re-rank superblock merges, its ``WindowCursor`` and
its proxy store backends (throttled, retrying, flaky) against ``repro``, on
the CPU, with the same numpy inputs and exact equality: the suffix array,
the LCP array, every ``Footprint`` field and every ``stats`` key but the
wall times ``t_*_s``; the ``benchmarks/baselines/BENCH_merge.json``
``kway_*``/``rerank_*`` counters; the cursor's cache, frontier and compare
results; the proxies' call, fault and retry counters."""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSB
from repro.core import store as ref_store
from repro.core.superblock import build_suffix_array_superblock as ref_build
from repro.data.chunk_store import write_chunked_corpus
from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core import store as port_store
from repro_torch.core.integrity import CorruptionError, TransientError, TransientStoreError
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.core.sanitize import unwrap_backend
from repro_torch.core.superblock import build_suffix_array_superblock
from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
from test_torch_merge import BASE, CASES, K4, _assert_same, _oracle, _walls_apart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGS = ("kway", "rerank")


def _build_both(corpus, lengths=None, cfg=K4, ref_corpus=None, **sb):
    """``repro``'s build of ``ref_corpus`` (``corpus`` when None) and the
    port's of ``corpus`` on the CPU."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_build(corpus if ref_corpus is None else ref_corpus,
                         lengths=lengths, cfg=RefConfig(**cfg), sb=RefSB(**sb))
        got = build_suffix_array_superblock(
            corpus, lengths=lengths, cfg=SAConfig(**cfg),
            sb=SuperblockConfig(**sb), device="cpu")
    return want, got


# ---------------------------------------------------------------------------
# BENCH_merge.json's kway_* and rerank_* counters (benchmarks/scaling.py)
# ---------------------------------------------------------------------------


BENCH_CORPORA = {  # name: (corpus, superblocks), as run_merge makes them
    "reads_random": (lambda: synth_dna_reads(96, 16, seed=3), 4),
    "reads_repetitive": (lambda: np.tile(np.array([1, 2] * 6, np.int32), (48, 1)), 3),
    "text_random": (lambda: synth_token_corpus(768, 4, seed=3)[0], 4),
}


def _bench_rows():
    with open(os.path.join(REPO, "benchmarks", "baselines", "BENCH_merge.json")) as f:
        rows = json.load(f)["sections"]["merge"]["rows"]
    return {row["corpus"]: row for row in rows}


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("name", sorted(BENCH_CORPORA))
def test_bench_merge_counters_match_repro_and_baseline(name, alg):
    make, s = BENCH_CORPORA[name]
    corpus = make()
    want, got = _build_both(corpus, cfg=BASE, num_superblocks=s, merge_algorithm=alg)
    _assert_same(want, got, _oracle(corpus))
    row = _bench_rows()[name]
    assert got.stats["merge_fetch_rounds"] == row[f"{alg}_roundtrips"]
    assert got.stats["merge_fetch_requests"] == row[f"{alg}_requests"]
    assert got.stats["merge_fetch_bytes"] == row[f"{alg}_bytes"]
    assert got.footprint.peak_resident_bytes == row[f"{alg}_peak_resident_bytes"]
    assert got.stats["num_suffixes"] == row["suffixes"]


# ---------------------------------------------------------------------------
# the switches of the merge (tests/test_torch_merge.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_out_of_core_build_matches_repro(name, alg):
    corpus, lengths, cfg, sb = CASES[name]
    sb = {"num_superblocks": 3, **sb, "merge_algorithm": alg}
    want, got = _build_both(corpus, lengths, cfg={**K4, **cfg}, **sb)
    _assert_same(want, got, _oracle(corpus, lengths))
    assert got.stats["merge_algorithm"] == alg
    if alg == "kway":
        assert got.stats["merge_cursor_peak_windows"] > 0


def test_kway_warms_the_cursor_from_the_risk_rerank():
    """Text mode: the host re-rank of the block-tail risk set offers its
    windows to the merge cursor; the cursor's peak and the store traffic
    equal ``repro``'s (the device refiner offers nothing)."""
    text = np.tile(np.array([1, 2, 2, 1, 3], np.int32), 60)
    for backend in ("host", "device"):
        want, got = _build_both(text, num_superblocks=4, merge_algorithm="kway",
                                merge_backend=backend, emit_lcp=True)
        _assert_same(want, got, naive_sa_text(text))


def test_kway_pieces_cut_to_the_record_bound():
    """A record bound below a bucket recurses through splitter pools
    (``_merge_runs``): more pieces than blocks, none above the bound."""
    reads = np.random.default_rng(9).integers(1, 5, size=(60, 10)).astype(np.int32)
    want, got = _build_both(reads, num_superblocks=6, merge_algorithm="kway",
                            samples_per_block=2, request_capacity=5)
    _assert_same(want, got, naive_sa_reads(reads))
    assert got.stats["merge_pieces"] > 1
    assert got.stats["max_piece"] <= got.stats["capacity_records"]


# ---------------------------------------------------------------------------
# streaming: the chunked backend under a budget
# ---------------------------------------------------------------------------


STREAM = {
    "reads": np.random.default_rng(7).integers(1, 5, size=(128, 16)).astype(np.int32),
    "text": np.random.default_rng(7).integers(1, 5, size=(768,)).astype(np.int32),
}


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("kind", sorted(STREAM))
def test_streaming_merge_matches_repro_within_budget(kind, alg):
    """``store_backend="chunked"`` at a quarter of the corpus bytes
    (``tests/test_merge_path.py``, ``tests/test_superblock.py``): the
    in-memory build's SA, ``repro``'s counters, and the resident peak
    (LRU cache plus cursor frontier) within the budget."""
    corpus = STREAM[kind]
    budget = corpus.size * 4 // 4
    want, got = _build_both(corpus, num_superblocks=4, merge_algorithm=alg,
                            store_backend="chunked", cache_budget_bytes=budget)
    _assert_same(want, got, _oracle(corpus))
    assert got.stats["store_backend"] == "chunked"
    assert 0 < got.footprint.peak_resident_bytes <= budget
    assert got.stats["spilled_runs"] > 0


# ---------------------------------------------------------------------------
# WindowCursor against repro's (tests/test_store_backends.py's cases)
# ---------------------------------------------------------------------------


CUR_CFG = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4


def _cursors(text=None):
    if text is None:
        text = np.ones(24, np.int32)  # all-equal: deep windows available
    ref = ref_store.CorpusStore(text, RefConfig(**CUR_CFG), request_capacity=64)
    port = port_store.CorpusStore(text, SAConfig(**CUR_CFG), request_capacity=64,
                                  device="cpu")
    return (ref, ref_store.WindowCursor(ref)), (port, port_store.WindowCursor(port))


def _cursor_state(store, cur):
    return (cur.cached_windows, cur.peak_cached_windows, cur.window_bytes,
            store.frontier_bytes, store.peak_resident_bytes, store.requests,
            store.request_bytes, store.response_bytes, store.rounds,
            store.peak_windows, store.backend.cache_hits)


def _same_cursors(pairs, step):
    (rs, rc), (ps, pc) = pairs
    step(rs, rc)
    step(ps, pc)
    assert _cursor_state(ps, pc) == _cursor_state(rs, rc)


def test_cursor_release_returns_frontier_bytes():
    (ref, rcur), (port, pcur) = _cursors()
    steps = [
        lambda s, c: c.prefetch(np.array([0, 1, 2], np.int64)),
        lambda s, c: c.key(0, 2),  # deepen suffix 0 to depth 2
        lambda s, c: c.release(0),  # the whole chain at once
        lambda s, c: c.release(0),  # a second release is a no-op
        lambda s, c: c.release_all(),
    ]
    for step in steps:
        _same_cursors(((ref, rcur), (port, pcur)), step)
    assert pcur.cached_windows == 0 and port.frontier_bytes == 0
    assert pcur.peak_cached_windows == 5


def test_cursor_offer_rejects_gaps_and_accounts():
    (ref, rcur), (port, pcur) = _cursors()
    w = np.ones(4, np.int32)
    for gidx, depth in ((7, 1), (7, 0), (7, 1), (7, 3), (7, 1)):
        _same_cursors(((ref, rcur), (port, pcur)),
                      lambda s, c, g=gidx, d=depth: c.offer(g, d, w))
    assert pcur.cached_windows == 2 and port.requests == 0
    keys, ended = pcur.key(7, 1)  # served from the offer, no fetch
    rkeys, rended = rcur.key(7, 1)
    np.testing.assert_array_equal(keys, rkeys)
    assert ended == rended is False
    assert port.requests == 0
    _same_cursors(((ref, rcur), (port, pcur)), lambda s, c: c.release(7))


def test_cursor_offer_windows_is_the_offers_in_turn():
    """The batched offer of the port's re-rank equals ``repro``'s offers
    one window at a time: the same cache, counts and frontier."""
    (ref, rcur), (port, pcur) = _cursors(np.arange(1, 41, dtype=np.int32) % 5)
    rng = np.random.default_rng(3)
    for depth in (0, 1, 3, 2):
        gidx = rng.permutation(30)[:12].astype(np.int64)
        win = rng.integers(0, 5, size=(12, 4)).astype(np.int32)
        for g, w in zip(gidx, win, strict=True):
            rcur.offer(int(g), depth, w)
        pcur.offer_windows(torch.from_numpy(gidx), depth, torch.from_numpy(win))
        assert _cursor_state(port, pcur) == _cursor_state(ref, rcur)
    for g in range(30):
        for d in range(3):
            want, got = rcur.key(g, d), pcur.key(g, d)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    assert _cursor_state(port, pcur) == _cursor_state(ref, rcur)


def test_cursor_offered_window_is_an_owned_copy():
    (_, rcur), (_, pcur) = _cursors()
    w = np.ones(4, np.int32)
    rcur.offer(9, 0, w)
    pcur.offer(9, 0, w)
    w[:] = 99  # mutating the caller's buffer must not change the cache
    np.testing.assert_array_equal(pcur.key(9, 0)[0], rcur.key(9, 0)[0])


@pytest.mark.parametrize("text", [np.ones(24, np.int32), np.array([2, 1, 3, 1, 2], np.int32),
                                  np.random.default_rng(4).integers(1, 3, 40).astype(np.int32)],
                         ids=["ones", "mixed", "binary"])
def test_cursor_less_matches_repro(text):
    """Every ordered pair: the same answer as ``repro``'s cursor, the
    oracle's order, and the same fetches on the way."""
    (ref, rcur), (port, pcur) = _cursors(text)
    n = text.shape[0]
    for a in range(n):
        for b in range(n):
            assert pcur.less(a, b) == rcur.less(a, b)
    assert _cursor_state(port, pcur) == _cursor_state(ref, rcur)
    order = sorted(range(n), key=lambda i: (list(text[i:]) + [0], i))
    for a, b in zip(order, order[1:], strict=False):
        assert pcur.less(a, b) and not pcur.less(b, a)


# ---------------------------------------------------------------------------
# the host key packing and the one-suffix window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(vocab_size=4, packing="base"),
    dict(vocab_size=4, packing="bits", chars_per_word=0),
    dict(vocab_size=255, packing="base", chars_per_word=4, key_words=3),
    dict(vocab_size=4, chars_per_word=2, key_words=2),
], ids=["base-k26", "bits", "base-wraps", "k4"])
def test_host_key_packer_matches_pack_keys(cfg):
    port_cfg = SAConfig(**cfg)
    k = port_cfg.prefix_len
    win = np.random.default_rng(1).integers(0, cfg["vocab_size"] + 1,
                                            size=(64, k)).astype(np.int32)
    want = port_store.pack_keys(torch.from_numpy(win), port_cfg).numpy()
    np.testing.assert_array_equal(want, ref_store.pack_keys_np(win, RefConfig(**cfg)))
    pack = port_store.host_key_packer(port_cfg)
    got = np.array([pack(w.tolist()) for w in win], np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("corpus", [
    np.random.default_rng(2).integers(1, 5, size=(9, 7)).astype(np.int32),
    np.random.default_rng(2).integers(1, 5, size=(23,)).astype(np.int32),
], ids=["reads", "text"])
def test_window_and_fetch_key_match_gather(corpus, tmp_path):
    """``window`` of every backend (and through a proxy) is ``gather`` of
    one suffix at every depth, and ``CorpusStore.fetch_key`` counts what
    ``repro``'s ``fetch_keys`` of one suffix counts."""
    cfg = SAConfig(**CUR_CFG)
    path = str(tmp_path / "c.sachunk")
    write_chunked_corpus(corpus, path, chunk_items=4)
    backends = [port_store.InMemoryBackend(corpus, cfg, device="cpu"),
                port_store.ChunkedFileBackend(path, cfg, device="cpu")]
    backends.append(port_store.ThrottledBackend(backends[0]))
    stride = backends[0].stride_bits
    gidx = (np.arange(corpus.shape[0], dtype=np.int64) if corpus.ndim == 1 else
            ((np.arange(corpus.shape[0])[:, None] << stride)
             | np.arange(corpus.shape[1] + 1)[None, :]).reshape(-1))
    counters = ("requests", "request_bytes", "response_bytes", "rounds",
                "peak_windows", "peak_resident_bytes")
    for be in backends:
        store = port_store.CorpusStore(None, cfg, request_capacity=8, backend=be)
        ref = ref_store.CorpusStore(corpus, RefConfig(**CUR_CFG), request_capacity=8)
        for depth in range(store.max_window_depth):
            for g in gidx.tolist():
                got = be.window(g, depth)
                want = be.gather(  # salint: disable=SAL002
                    torch.tensor([g]), torch.tensor([depth]))[0].numpy()
                np.testing.assert_array_equal(got, want)
                words, ended = store.fetch_key(g, depth)
                rkeys, rended = ref.fetch_keys(np.array([g], np.int64), depth)
                assert words == tuple(rkeys[0].tolist()) and ended == bool(rended[0])
        assert ([getattr(store, c) for c in counters[:5]]
                == [getattr(ref, c) for c in counters[:5]])
    # window, gather and fetch_key a suffix and depth: three calls through the proxy
    assert backends[2].gather_calls == 3 * gidx.size * store.max_window_depth
    backends[1].close()


# ---------------------------------------------------------------------------
# the proxy backends
# ---------------------------------------------------------------------------


def _backend_pair(kind, corpus, tmp_path, wrap):
    """``wrap(module, inner, cfg)`` around an in-memory or chunked backend of
    each package over the same corpus (one chunked file, written once)."""
    rcfg, pcfg = RefConfig(**K4), SAConfig(**K4)
    if kind == "memory":
        rin = ref_store.InMemoryBackend(corpus, rcfg)
        pin = port_store.InMemoryBackend(corpus, pcfg, device="cpu")
    else:
        path = str(tmp_path / "c.sachunk")
        if not os.path.exists(path):
            write_chunked_corpus(corpus, path, chunk_items=8)
        rin = ref_store.ChunkedFileBackend(path, rcfg, cache_budget_bytes=1 << 13)
        pin = port_store.ChunkedFileBackend(path, pcfg, cache_budget_bytes=1 << 13,
                                            device="cpu")
    return wrap(ref_store, rin), wrap(port_store, pin)


FAULT_CORPUS = np.random.default_rng(12).integers(1, 5, size=(40, 10)).astype(np.int32)


@pytest.mark.parametrize("alg", ["merge_path", "kway", "rerank"])
@pytest.mark.parametrize("kind", ["memory", "chunked"])
def test_injected_faults_retried_to_repros_result(kind, alg, tmp_path):
    """``FlakyBackend`` faults in every phase (staging reads, merge
    gathers), absorbed by ``store_retries``: ``repro``'s result and
    counters, the fault-free build's result, and the retry counters apart
    from the traffic counters."""
    sb = dict(num_superblocks=4, merge_algorithm=alg, cache_budget_bytes=1 << 14,
              emit_lcp=True)
    rclean, pclean = _backend_pair(kind, FAULT_CORPUS, tmp_path, lambda m, b: b)
    clean = build_suffix_array_superblock(pclean, cfg=SAConfig(**K4),
                                          sb=SuperblockConfig(**sb))
    rclean.close()
    pclean.close()
    rflaky, pflaky = _backend_pair(
        kind, FAULT_CORPUS, tmp_path,
        lambda m, b: m.FlakyBackend(b, fail_every=3, failures_per_call=2))
    retried = dict(sb, store_retries=3, store_backoff_s=0.0)
    want, got = _build_both(pflaky, ref_corpus=rflaky, **retried)
    _assert_same(want, got, naive_sa_reads(FAULT_CORPUS))
    assert ((pflaky.injected, pflaky.gather_calls, pflaky.read_calls)
            == (rflaky.injected, rflaky.gather_calls, rflaky.read_calls))
    assert pflaky.injected > 0
    assert got.stats["store_retry_attempts"] == pflaky.injected
    assert got.stats["store_retried_calls"] > 0
    np.testing.assert_array_equal(got.suffix_array, clean.suffix_array)
    np.testing.assert_array_equal(got.lcp, clean.lcp)
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(clean.footprint)
    retry_keys = ("store_retry_attempts", "store_retried_calls")
    assert ({k: v for k, v in _walls_apart(got.stats).items() if k not in retry_keys}
            == {k: v for k, v in _walls_apart(clean.stats).items() if k not in retry_keys})
    assert clean.stats["store_retry_attempts"] == clean.stats["store_retried_calls"] == 0
    assert got.stats["store_backend"] == ("memory" if kind == "memory" else "chunked")
    for b in (rflaky, pflaky):
        b.close()


def test_faults_without_the_retry_layer_fail_fast():
    flaky = port_store.FlakyBackend(
        port_store.InMemoryBackend(FAULT_CORPUS, SAConfig(**K4), device="cpu"),
        fail_every=2)
    with pytest.raises(TransientError):
        build_suffix_array_superblock(flaky, cfg=SAConfig(**K4),
                                      sb=SuperblockConfig(num_superblocks=4))


def _retrying_pair(**flaky):
    """A RetryingBackend over a FlakyBackend of each package, whose sleeps
    are recorded."""
    slept = ([], [])
    pair = []
    for mod, cfg, kw, log in ((ref_store, RefConfig(**K4), {}, slept[0]),
                              (port_store, SAConfig(**K4), {"device": "cpu"}, slept[1])):
        inner = mod.FlakyBackend(mod.InMemoryBackend(FAULT_CORPUS, cfg, **kw), **flaky)
        pair.append(mod.RetryingBackend(inner, retries=3, backoff_s=0.01,
                                        max_backoff_s=0.02, sleep=log.append))
    return pair, slept


def _counters(rb):
    return rb.retry_attempts, rb.retried_calls, rb.gave_up, rb.inner.injected


def test_retrying_backend_backoff_sequence_deterministic():
    (rref, rport), (sref, sport) = _retrying_pair(fail_reads={0}, failures_per_call=3)
    np.testing.assert_array_equal(rport.read_items(0, 2),  # salint: disable=SAL002
                                  rref.read_items(0, 2))  # salint: disable=SAL002
    assert sport == sref == [0.01, 0.02, 0.02]  # doubled, then capped
    assert _counters(rport) == _counters(rref) == (3, 1, 0, 3)


def test_retrying_backend_gives_up_after_its_budget():
    (rref, rport), (sref, sport) = _retrying_pair(fail_gathers={0}, failures_per_call=10)
    g = np.array([0, 1], np.int64)
    with pytest.raises(TransientStoreError):
        rport.gather(  # salint: disable=SAL002
            torch.from_numpy(g), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ref_store.TransientStoreError):
        rref.gather(g, np.zeros(2, np.int64))  # salint: disable=SAL002
    assert _counters(rport) == _counters(rref) == (3, 1, 1, 4)
    assert sport == sref


def test_retrying_backend_never_retries_corruption(tmp_path):
    """``CorruptionError`` passes the retry layer on first sight, even with
    every exception retryable: from a read, and from a gather of a chunked
    file with a flipped byte."""
    class Corrupt(port_store.InMemoryBackend):
        calls = 0

        def read_items(self, lo, hi):
            type(self).calls += 1
            raise CorruptionError("chunk 0 of c.sachunk")

    rb = port_store.RetryingBackend(Corrupt(FAULT_CORPUS, SAConfig(**K4), device="cpu"),
                                    retries=5, backoff_s=0.0, retryable=(Exception,))
    with pytest.raises(CorruptionError):
        rb.read_items(0, 2)  # salint: disable=SAL002
    assert Corrupt.calls == 1 and rb.retry_attempts == 0

    path = str(tmp_path / "c.sachunk")
    write_chunked_corpus(FAULT_CORPUS, path, chunk_items=8)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    rb = port_store.RetryingBackend(
        port_store.ChunkedFileBackend(path, SAConfig(**K4), cache_budget_bytes=1 << 12,
                                      device="cpu"),
        retries=5, backoff_s=0.0, retryable=(Exception,))
    gidx = np.arange(FAULT_CORPUS.shape[0], dtype=np.int64) << rb.stride_bits
    with pytest.raises(CorruptionError):
        rb.gather(  # salint: disable=SAL002
            torch.from_numpy(gidx), torch.zeros_like(torch.from_numpy(gidx)))
    assert rb.retry_attempts == 0
    rb.close()


@pytest.mark.parametrize("alg", ["merge_path", "kway"])
def test_throttled_backend_counts_as_repro(alg):
    rthr, pthr = _backend_pair(
        "memory", FAULT_CORPUS, None,
        lambda m, b: m.ThrottledBackend(b, gather_delay_s=1e-5, read_delay_s=2e-5))
    want, got = _build_both(pthr, ref_corpus=rthr, num_superblocks=3,
                            merge_algorithm=alg, emit_lcp=True)
    _assert_same(want, got, naive_sa_reads(FAULT_CORPUS))
    counters = ("gather_calls", "read_calls", "throttled_calls")
    assert ([getattr(pthr, c) for c in counters]
            == [getattr(rthr, c) for c in counters])
    assert pthr.gather_calls > 0 and pthr.read_calls == 3
    assert pthr.throttled_sleep_s == pytest.approx(rthr.throttled_sleep_s)
    assert unwrap_backend(pthr) is pthr.inner
    assert pthr.resident_bytes == pthr.inner.resident_bytes


@pytest.mark.parametrize("kind", ["memory", "chunked"])
def test_a_callers_backend_stays_open_after_a_retried_build(kind, tmp_path):
    """The build closes what it made, never the caller's backend, also when
    ``store_retries`` wraps it (ownership is decided before the wrap)."""
    closed = []

    def spy(mod, backend):
        real = backend.close
        backend.close = lambda: (closed.append(True), real())
        return backend

    rb, pb = _backend_pair(kind, FAULT_CORPUS, tmp_path, spy)
    want, got = _build_both(pb, ref_corpus=rb, num_superblocks=3, store_retries=2,
                            merge_algorithm="kway")
    _assert_same(want, got, naive_sa_reads(FAULT_CORPUS))
    assert closed == []
    np.testing.assert_array_equal(  # still serves
        pb.read_items(0, 3), FAULT_CORPUS[:3])  # salint: disable=SAL002
    pb.close()
    assert closed == [True]
    rb.close()


def test_unwrap_backend_finds_the_real_backend():
    inner = port_store.InMemoryBackend(FAULT_CORPUS, SAConfig(**K4), device="cpu")
    layered = port_store.RetryingBackend(port_store.FlakyBackend(
        port_store.ThrottledBackend(inner)))
    assert unwrap_backend(layered) is inner
    assert unwrap_backend(inner) is inner
    assert layered.per_round and not inner.per_round
    assert layered.shape == inner.shape and layered.device == inner.device
