"""The port's persistence slice against ``repro`` on the CPU: the chunked
corpus format, the chunked store backend and its LRU cache, the integrity
checks, index directories in both directions (byte-identical files, equal
manifests, equal answers) and the streaming out-of-core build.

The chunked-store cases mirror ``tests/test_store_backends.py`` and the
integrity cases ``tests/test_integrity.py``, run on the port and, where a
counter or a byte can differ, held to ``repro`` on the same inputs.  This
file exercises raw backend reads, so SAL002 is off file-wide.
"""
# salint: disable-file=SAL002
import dataclasses
import filecmp
import json
import os
import struct
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSB
from repro.core import index_io as ref_index_io
from repro.core import integrity as ref_integrity
from repro.core.store import ChunkedFileBackend as RefChunked
from repro.core.store import InMemoryBackend as RefMemory
from repro.core.superblock import build_suffix_array_superblock as ref_superblock
from repro.data import chunk_store as ref_chunk_store
from repro.serve.sa_engine import SuffixArrayIndex as RefIndex
from repro_torch import SAConfig, SuffixArrayIndex, SuperblockConfig
from repro_torch.core import index_io
from repro_torch.core.integrity import (
    CorruptionError,
    crc32_array,
    crc32_bytes,
    crc32_file,
    publish_dir,
    publish_file,
)
from repro_torch.core.oracle import naive_sa_reads
from repro_torch.core.store import (
    ChunkedFileBackend,
    CorpusStore,
    InMemoryBackend,
    backend_fingerprint,
    materialize_backend,
)
from repro_torch.core.superblock import build_suffix_array_superblock
from repro_torch.data.chunk_store import (
    ChunkedCorpusReader,
    chunk_items_for_budget,
    default_chunk_items,
    load_corpus,
    read_chunked_corpus_meta,
    write_chunked_corpus,
    write_chunked_stream,
)
from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus

K4 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4
CFG = SAConfig(**K4)
REF_CFG = RefConfig(**K4)
# the manifest's wall times, and the self-crc that covers them
WALLS = ("t_stage_s", "t_build_s", "t_merge_s")


def _gather(backend, gidx, depth):
    """A port backend's windows for host ids/depths, as a host array."""
    return backend.gather(torch.from_numpy(np.array(gidx, np.int64)),
                          torch.from_numpy(np.array(depth, np.int64))).numpy()


def _flip_byte(path, offset):
    """Flip every bit of one byte; negative offsets count from the end."""
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _truncate(path, drop_bytes):
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        f.truncate(f.tell() - drop_bytes)


def _same_bytes(a, b):
    return filecmp.cmp(a, b, shallow=False)


# ---------------------------------------------------------------------------
# on-disk format
# ---------------------------------------------------------------------------


def test_chunked_corpus_roundtrip_text(tmp_path):
    rng = np.random.default_rng(0)
    text = rng.integers(1, 5, size=(101,)).astype(np.int32)  # partial tail
    p, q = str(tmp_path / "t.sachunk"), str(tmp_path / "ref.sachunk")
    meta = write_chunked_corpus(text, p, chunk_items=16)
    ref_chunk_store.write_chunked_corpus(text, q, chunk_items=16)
    assert _same_bytes(p, q)
    assert meta.text_mode and meta.items == 101 and meta.num_chunks == 7
    assert read_chunked_corpus_meta(p) == meta
    with ChunkedCorpusReader(p) as r:
        np.testing.assert_array_equal(r.read_items(0, 101), text)
        np.testing.assert_array_equal(r.read_items(20, 35), text[20:35])
        tail = r.read_chunk(6, halo=4)
        np.testing.assert_array_equal(tail[:5], text[96:])
        assert (tail[5:] == 0).all()


def test_chunked_corpus_roundtrip_reads(tmp_path):
    rng = np.random.default_rng(1)
    reads = rng.integers(1, 5, size=(23, 9)).astype(np.int32)
    p, q = str(tmp_path / "r.sachunk"), str(tmp_path / "ref.sachunk")
    meta = write_chunked_corpus(reads, p, chunk_items=5)
    ref_chunk_store.write_chunked_corpus(reads, q, chunk_items=5)
    assert _same_bytes(p, q)
    assert not meta.text_mode and meta.row_len == 9
    with ChunkedCorpusReader(p) as r:
        np.testing.assert_array_equal(r.read_items(0, 23), reads)
        np.testing.assert_array_equal(r.read_chunk(4), reads[20:])
        with pytest.raises(ValueError):
            r.read_chunk(0, halo=2)  # rows are atomic: no halo in reads mode
    np.testing.assert_array_equal(load_corpus(p), reads)


def test_chunked_corpus_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad")
    with open(p, "wb") as f:
        f.write(b"not a chunked corpus, definitely")
    with pytest.raises(ValueError):
        read_chunked_corpus_meta(p)


@pytest.mark.parametrize("batches,chunk_items", [
    ([40, 3, 17, 1], 8), ([5], 16), ([9, 9, 9], 0),
], ids=["ragged", "one-short-chunk", "default-chunks"])
@pytest.mark.parametrize("text_mode", [True, False], ids=["text", "reads"])
def test_chunked_stream_writer_matches_repro(tmp_path, batches, chunk_items,
                                             text_mode):
    """The streaming writer's file equals ``repro``'s byte for byte (header
    back-patch, per-chunk crcs folded across batch edges, footer)."""
    rng = np.random.default_rng(len(batches) + chunk_items)
    shape = (sum(batches),) if text_mode else (sum(batches), 6)
    corpus = rng.integers(1, 5, size=shape).astype(np.int32)
    parts = np.split(corpus, np.cumsum(batches)[:-1])
    p, q = str(tmp_path / "s.sachunk"), str(tmp_path / "ref.sachunk")
    meta = write_chunked_stream(iter(parts), p, chunk_items=chunk_items)
    want = ref_chunk_store.write_chunked_stream(iter(parts), q,
                                                chunk_items=chunk_items)
    assert _same_bytes(p, q)
    assert dataclasses.asdict(meta) == dataclasses.asdict(want)
    with ChunkedCorpusReader(p) as r:
        assert r.verify_all() == meta.num_chunks
        np.testing.assert_array_equal(r.read_items(0, meta.items), corpus)


def test_chunk_sizing_matches_repro():
    for items, row_len, budget in [(1000, 1, 4096), (5, 200, 1 << 20),
                                   (125_000, 200, 25 << 20), (1, 1, 64)]:
        assert (default_chunk_items(items, row_len)
                == ref_chunk_store.default_chunk_items(items, row_len))
        assert (chunk_items_for_budget(items, row_len, budget)
                == ref_chunk_store.chunk_items_for_budget(items, row_len, budget))


def _v1_file(path, corpus, chunk_items):
    """A version-1 corpus file as ``repro``'s pre-checksum writer laid it
    out: the header with version 1 and the tokens, no crc footer."""
    corpus = np.asarray(corpus, np.int32)
    text_mode = corpus.ndim == 1
    items, row_len = (corpus.shape[0], 1) if text_mode else corpus.shape
    with open(path, "wb") as f:
        f.write(ref_chunk_store._HEADER.pack(ref_chunk_store.MAGIC, 1,
                                             int(text_mode), items, row_len,
                                             chunk_items))
        f.write(np.ascontiguousarray(corpus, "<i4").tobytes())


@pytest.mark.parametrize("text_mode", [True, False], ids=["text", "reads"])
def test_v1_corpus_file_reads_in_the_port(tmp_path, text_mode):
    rng = np.random.default_rng(7)
    corpus = rng.integers(1, 5, size=(50,) if text_mode else (20, 7)).astype(np.int32)
    p = str(tmp_path / "v1.sachunk")
    _v1_file(p, corpus, chunk_items=8)
    with ref_chunk_store.ChunkedCorpusReader(p) as ref_r:
        assert ref_r.meta.version == 1
    meta = read_chunked_corpus_meta(p)
    assert meta.version == 1
    with ChunkedCorpusReader(p) as r:
        assert r.verify_all() == 0  # nothing to check in a v1 file
        np.testing.assert_array_equal(r.read_items(0, meta.items), corpus)
    ch = ChunkedFileBackend(p, CFG, cache_budget_bytes=1 << 16, device="cpu")
    ref_ch = RefChunked(p, REF_CFG, cache_budget_bytes=1 << 16)
    gidx = np.arange(0, ch.n * (1 if text_mode else 1 << ch.stride_bits), 3,
                     dtype=np.int64)
    if not text_mode:
        gidx = gidx[(gidx & ((1 << ch.stride_bits) - 1)) <= corpus.shape[1]]
    depth = np.zeros_like(gidx)
    np.testing.assert_array_equal(_gather(ch, gidx, depth), ref_ch.gather(gidx, depth))
    ch.close()
    ref_ch.close()


# ---------------------------------------------------------------------------
# backend equivalence
# ---------------------------------------------------------------------------


def _backends_text(path, text, chunk_items, budget=1 << 16):
    write_chunked_corpus(text, path, chunk_items=chunk_items)
    return (RefMemory(text, REF_CFG),
            ChunkedFileBackend(path, CFG, cache_budget_bytes=budget, device="cpu"),
            RefChunked(path, REF_CFG, cache_budget_bytes=budget))


def test_chunk_edge_and_tail_windows_exact(tmp_path):
    """Windows starting at / straddling a chunk boundary and running past
    the corpus tail, against repro's in-memory backend, one at a time so
    the cache counters follow each access."""
    rng = np.random.default_rng(2)
    text = rng.integers(1, 5, size=(50,)).astype(np.int32)
    mem, ch, ref_ch = _backends_text(str(tmp_path / "c.sachunk"), text, 8)
    for g, d in [(7, 0), (8, 0), (6, 0), (15, 0), (49, 0), (47, 0),
                 (0, 12), (40, 2), (49, 13)]:
        gi, dd = np.array([g], np.int64), np.array([d], np.int64)
        np.testing.assert_array_equal(_gather(ch, gi, dd), mem.gather(gi, dd),
                                      err_msg=f"(g={g}, d={d})")
        ref_ch.gather(gi, dd)
        assert (ch.cache_hits, ch.cache_misses) == (ref_ch.cache_hits,
                                                    ref_ch.cache_misses)


@pytest.mark.parametrize("n,chunk_items,seed", [
    (2, 1, 0), (17, 4, 1), (50, 7, 2), (120, 40, 3), (64, 64, 4), (99, 13, 5)])
def test_chunked_text_windows_match_memory(tmp_path, n, chunk_items, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 5, size=(n,)).astype(np.int32)
    mem, ch, ref_ch = _backends_text(str(tmp_path / "c.sachunk"), text,
                                     min(chunk_items, n))
    m = 64
    gidx = rng.integers(0, n, size=(m,)).astype(np.int64)
    edges = np.arange(0, n, max(1, min(chunk_items, n)), dtype=np.int64)
    gidx[: min(m, edges.size)] = edges[: min(m, edges.size)]
    gidx[-1] = n - 1
    depth = rng.integers(0, mem.max_len // mem.k + 2, size=(m,)).astype(np.int64)
    got = _gather(ch, gidx, depth)
    np.testing.assert_array_equal(got, mem.gather(gidx, depth))
    np.testing.assert_array_equal(got, ref_ch.gather(gidx, depth))
    assert (ch.cache_hits, ch.cache_misses, ch.resident_bytes) == (
        ref_ch.cache_hits, ref_ch.cache_misses, ref_ch.resident_bytes)
    ch.close()
    ref_ch.close()


@pytest.mark.parametrize("r,l,chunk_items,seed", [
    (1, 1, 1, 0), (40, 12, 16, 1), (13, 5, 3, 2), (25, 9, 25, 3), (7, 12, 2, 4)])
def test_chunked_reads_windows_match_memory(tmp_path, r, l, chunk_items, seed):
    rng = np.random.default_rng(seed)
    reads = rng.integers(1, 5, size=(r, l)).astype(np.int32)
    mem = RefMemory(reads, REF_CFG)
    p = str(tmp_path / "c.sachunk")
    write_chunked_corpus(reads, p, chunk_items=min(chunk_items, r))
    ch = ChunkedFileBackend(p, CFG, cache_budget_bytes=1 << 16, device="cpu")
    m = 64
    row = rng.integers(0, r, size=(m,)).astype(np.int64)
    off = rng.integers(0, l + 1, size=(m,)).astype(np.int64)
    gidx = (row << mem.stride_bits) | off
    depth = rng.integers(0, mem.max_len // mem.k + 2, size=(m,)).astype(np.int64)
    np.testing.assert_array_equal(_gather(ch, gidx, depth), mem.gather(gidx, depth))
    ch.close()


# ---------------------------------------------------------------------------
# LRU residency bound
# ---------------------------------------------------------------------------


def test_lru_cache_respects_budget_and_counts(tmp_path):
    rng = np.random.default_rng(3)
    text = rng.integers(1, 5, size=(128,)).astype(np.int32)
    p = str(tmp_path / "c.sachunk")
    write_chunked_corpus(text, p, chunk_items=16)  # 8 chunks, 80 B resident ea
    budget = 200  # fits 2 chunks (with halo), not 3
    ch = ChunkedFileBackend(p, CFG, cache_budget_bytes=budget, device="cpu")
    ref_ch = RefChunked(p, REF_CFG, cache_budget_bytes=budget)
    peak = 0
    for g in range(0, 128, 4):
        gi, d = np.array([g], np.int64), np.array([0], np.int64)
        _gather(ch, gi, d)
        ref_ch.gather(gi, d)
        assert ch.resident_bytes <= budget
        assert ch.resident_bytes == ref_ch.resident_bytes
        peak = max(peak, ch.resident_bytes)
    assert peak > 0
    assert ch.evictions == ref_ch.evictions > 0
    assert ch.cache_hits > ch.cache_misses >= 8
    assert (ch.cache_hits, ch.cache_misses) == (ref_ch.cache_hits, ref_ch.cache_misses)
    with pytest.raises(ValueError):
        ChunkedFileBackend(p, CFG, cache_budget_bytes=16, device="cpu")


def test_lru_eviction_order_is_least_recent(tmp_path):
    text = np.arange(1, 65, dtype=np.int32) % 4 + 1
    p = str(tmp_path / "c.sachunk")
    write_chunked_corpus(text, p, chunk_items=16)  # 4 chunks
    ch = ChunkedFileBackend(p, CFG, cache_budget_bytes=200, device="cpu")

    def touch(g):
        _gather(ch, np.array([g], np.int64), np.array([0], np.int64))

    touch(0)
    touch(16)
    touch(0)   # chunk 0: hit, refreshed
    touch(32)  # chunk 2: miss, evicts chunk 1 (least recent)
    assert ch.cache_misses == 3 and ch.cache_hits == 1
    touch(0)
    assert ch.cache_hits == 2
    touch(16)  # chunk 1 was evicted: miss again
    assert ch.cache_misses == 4


def test_store_calls_a_chunked_backend_one_capacity_chunk_at_a_time(tmp_path):
    """``CorpusStore`` over the chunked backend: windows on the device, and
    the traffic, cache and residency counters of repro's store, whose
    capacity loop calls the backend once per chunk of requests."""
    from repro.core.store import CorpusStore as RefStore

    rng = np.random.default_rng(4)
    text = rng.integers(1, 5, size=(300,)).astype(np.int32)
    p = str(tmp_path / "c.sachunk")
    write_chunked_corpus(text, p, chunk_items=20)
    store = CorpusStore(None, CFG, request_capacity=7, backend=ChunkedFileBackend(
        p, CFG, cache_budget_bytes=300, device="cpu"))
    ref = RefStore(None, REF_CFG, request_capacity=7,
                   backend=RefChunked(p, REF_CFG, cache_budget_bytes=300))
    gidx = rng.integers(0, 300, size=(50,)).astype(np.int64)
    np.testing.assert_array_equal(store.fetch_windows(gidx, 2).numpy(),
                                  ref.fetch_windows(gidx, 2))
    keys, ended = store.fetch_keys(gidx[:23], 1)
    want_k, want_e = ref.fetch_keys(gidx[:23], 1)
    np.testing.assert_array_equal(keys.numpy(), want_k)
    np.testing.assert_array_equal(ended.numpy(), want_e)
    store.add_frontier(100)
    ref.add_frontier(100)
    store.fetch_windows(gidx[::-1].copy(), 0)
    ref.fetch_windows(gidx[::-1].copy(), 0)
    for name in ("requests", "request_bytes", "response_bytes", "rounds",
                 "peak_windows", "peak_resident_bytes"):
        assert getattr(store, name) == getattr(ref, name), name
    for name in ("cache_hits", "cache_misses", "evictions", "resident_bytes"):
        assert getattr(store.backend, name) == getattr(ref.backend, name), name
    assert backend_fingerprint(store.backend) == __import__(
        "repro.core.store", fromlist=["x"]).backend_fingerprint(ref.backend)
    np.testing.assert_array_equal(materialize_backend(store.backend), text)
    store.backend.close()
    ref.backend.close()


# ---------------------------------------------------------------------------
# integrity primitives and chunk checksums
# ---------------------------------------------------------------------------


def _corpus():
    rng = np.random.default_rng(3)
    return rng.integers(1, 5, size=(24, 8)).astype(np.int32)


def test_crc_helpers_agree_with_repro(tmp_path):
    arr = np.arange(100, dtype=np.int64).reshape(10, 10)
    assert crc32_array(arr) == crc32_bytes(arr.tobytes()) == ref_integrity.crc32_array(arr)
    assert crc32_array(arr.T) == ref_integrity.crc32_array(arr.T)
    p = tmp_path / "a.bin"
    p.write_bytes(arr.tobytes())
    assert crc32_file(str(p)) == crc32_file(str(p), block=7) == crc32_array(arr)


def test_publish_file_and_dir(tmp_path):
    tmp, final = str(tmp_path / "x.tmp"), str(tmp_path / "x")
    (tmp_path / "x").write_text("old")
    (tmp_path / "x.tmp").write_text("new")
    publish_file(tmp, final)
    assert (tmp_path / "x").read_text() == "new" and not os.path.exists(tmp)
    d_tmp, d_final = tmp_path / "d.tmp", tmp_path / "d"
    d_tmp.mkdir()
    (d_tmp / "f").write_text("payload")
    publish_dir(str(d_tmp), str(d_final))
    assert (d_final / "f").read_text() == "payload" and not d_tmp.exists()


def test_chunk_bitflip_names_the_chunk(tmp_path):
    path = str(tmp_path / "c.sachunk")
    write_chunked_corpus(_corpus(), path, chunk_items=8)
    _flip_byte(path, os.path.getsize(path) // 2)  # mid-payload
    with ChunkedCorpusReader(path) as r:
        with pytest.raises(CorruptionError, match=r"chunk \d+") as ei:
            for ci in range(r.meta.num_chunks):
                r.read_chunk(ci)
    assert ei.value.path == path


def test_verify_all_scans_every_chunk(tmp_path):
    path = str(tmp_path / "c.sachunk")
    write_chunked_corpus(_corpus(), path, chunk_items=8)
    with ChunkedCorpusReader(path) as r:
        assert r.verify_all() == r.meta.num_chunks
    _flip_byte(path, os.path.getsize(path) // 2)
    with ChunkedCorpusReader(path) as r:
        with pytest.raises(CorruptionError, match="chunk"):
            r.verify_all()


def test_checksum_table_truncation_detected(tmp_path):
    path = str(tmp_path / "c.sachunk")
    write_chunked_corpus(_corpus(), path, chunk_items=8)
    _truncate(path, 4)  # tear the footer's tail
    with pytest.raises(CorruptionError, match="chunk checksum table"):
        with ChunkedCorpusReader(path) as r:
            r.read_chunk(0)


def test_verify_off_reads_corrupt_bytes_unchecked(tmp_path):
    path = str(tmp_path / "c.sachunk")
    write_chunked_corpus(_corpus(), path, chunk_items=8)
    _flip_byte(path, os.path.getsize(path) // 2)
    with ChunkedCorpusReader(path, verify=False) as r:
        for ci in range(r.meta.num_chunks):
            r.read_chunk(ci)  # no raise


# ---------------------------------------------------------------------------
# index artifacts: manifest digests + self-crc
# ---------------------------------------------------------------------------


@pytest.fixture()
def index_dir(tmp_path):
    corpus = _corpus()
    backend = InMemoryBackend(corpus, CFG, device="cpu")
    sa = naive_sa_reads(corpus).astype(np.int64)
    lcp = np.zeros(sa.shape[0], np.int32)
    index_io.save_index(str(tmp_path / "ix"), CFG, backend, sa, lcp=lcp)
    # the same directory written by repro is byte for byte the port's
    ref_backend = RefMemory(corpus, REF_CFG)
    ref_index_io.save_index(str(tmp_path / "ref"), REF_CFG, ref_backend, sa, lcp=lcp)
    for name in os.listdir(str(tmp_path / "ref")):
        assert _same_bytes(str(tmp_path / "ix" / name), str(tmp_path / "ref" / name))
    return str(tmp_path / "ix")


def test_open_index_verify_eager_passes_clean(index_dir):
    backend, sa, lcp, manifest = index_io.open_index(index_dir, verify="eager",
                                                     device="cpu")
    assert manifest["version"] == index_io.VERSION
    assert isinstance(backend, ChunkedFileBackend) and lcp is not None
    backend.close()
    backend, *_ = index_io.open_index(index_dir, store_backend="memory",
                                      verify="eager", device="cpu")
    assert isinstance(backend, InMemoryBackend)
    with pytest.raises(ValueError, match="store backend"):
        index_io.open_index(index_dir, store_backend="tape", device="cpu")
    with pytest.raises(ValueError, match="verify mode"):
        index_io.open_index(index_dir, verify="sometimes", device="cpu")


@pytest.mark.parametrize("artifact", [index_io.SA_FILE, index_io.LCP_FILE])
def test_eager_open_names_flipped_array_artifact(index_dir, artifact):
    _flip_byte(os.path.join(index_dir, artifact), -1)
    with pytest.raises(CorruptionError, match=artifact):
        index_io.open_index(index_dir, verify="eager", device="cpu")


def test_eager_open_names_flipped_corpus(index_dir):
    path = os.path.join(index_dir, index_io.CORPUS_FILE)
    _flip_byte(path, os.path.getsize(path) // 2)
    with pytest.raises(CorruptionError, match=index_io.CORPUS_FILE):
        index_io.open_index(index_dir, verify="eager", device="cpu")


def test_lazy_open_defers_corpus_check_to_first_read(index_dir):
    path = os.path.join(index_dir, index_io.CORPUS_FILE)
    _flip_byte(path, os.path.getsize(path) // 2)
    backend, sa, lcp, manifest = index_io.open_index(index_dir, verify="lazy",
                                                     device="cpu")
    try:
        with pytest.raises(CorruptionError, match="chunk"):
            _gather(backend, np.asarray(sa), 0)
    finally:
        backend.close()


def test_verify_off_opens_flipped_index(index_dir):
    _flip_byte(os.path.join(index_dir, index_io.SA_FILE), -1)
    path = os.path.join(index_dir, index_io.CORPUS_FILE)
    _flip_byte(path, os.path.getsize(path) // 2)
    backend, sa, lcp, manifest = index_io.open_index(index_dir, verify="off",
                                                     device="cpu")
    assert sa.shape[0] > 0
    _gather(backend, np.asarray(sa)[:4], 0)  # corrupt chunks read unchecked
    backend.close()


def test_manifest_value_flip_fails_self_crc(index_dir):
    mpath = os.path.join(index_dir, index_io.MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["geometry"]["suffixes"] += 1  # parses fine; self-crc disagrees
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CorruptionError, match="index manifest"):
        index_io.open_index(index_dir, device="cpu")


def test_manifest_truncation_is_corruption(index_dir):
    _truncate(os.path.join(index_dir, index_io.MANIFEST_NAME), 20)
    with pytest.raises(CorruptionError, match="index manifest"):
        index_io.open_index(index_dir, device="cpu")


def test_open_refuses_the_sanitizer(index_dir, monkeypatch):
    """Under REPRO_SANITIZE the opened backend is wrapped in the sanitizer,
    as repro wraps it, on either store: the index serves repro's answers,
    and the sanitizer makes repro's checks over them."""
    from repro.core.sanitize import SanitizingBackend as RefSanitizing
    from repro_torch.core.sanitize import SanitizingBackend

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    corpus = _corpus()
    for store_backend in ("chunked", "memory"):
        backend, *_ = index_io.open_index(index_dir, store_backend=store_backend,
                                          device="cpu")
        assert isinstance(backend, SanitizingBackend)
        backend.close()
        with SuffixArrayIndex.open(index_dir, store_backend=store_backend,
                                   device="cpu") as port:
            want = RefIndex.open(index_dir, store_backend=store_backend)
            assert _answers(port, corpus) == _answers(want, corpus)
            got_b, want_b = port.store.backend, want.store.backend
            assert isinstance(got_b, SanitizingBackend)
            assert isinstance(want_b, RefSanitizing)
            assert (got_b.checks, got_b.oracle_windows_checked) == (
                want_b.checks, want_b.oracle_windows_checked)
            assert got_b.checks > 0
            assert port.stats() == want.stats()
            want.close()


# ---------------------------------------------------------------------------
# index directories across the two packages
# ---------------------------------------------------------------------------

READS = synth_dna_reads(40, 30, seed=3)
TEXT, _ = synth_token_corpus(900, 4, seed=3)
INDEX_CASES = {  # id -> (corpus, SuperblockConfig keywords)
    "reads-in-core": (READS, {}),
    "reads-out-of-core": (READS, dict(num_superblocks=3)),
    "reads-out-of-core-resume": (READS, dict(num_superblocks=3, resume=True)),
    "reads-streaming": (READS, dict(num_superblocks=3, store_backend="chunked",
                                    cache_budget_bytes=READS.size)),
    "text-streaming": (TEXT, dict(num_superblocks=3, store_backend="chunked",
                                  cache_budget_bytes=TEXT.size)),
}


def _patterns(corpus, seed=1, count=12):
    rng = np.random.default_rng(seed)
    flat = corpus.reshape(-1)
    pats = [flat[s : s + m].astype(np.int64)
            for s, m in zip(rng.integers(0, flat.size - 12, count),
                            rng.integers(1, 12, count), strict=True)]
    return pats + [np.array([1, 2, 3, 4, 1, 2], np.int64), np.array([9], np.int64)]


def _answers(idx, corpus):
    pats = _patterns(corpus)
    hits = idx.locate(pats) if corpus.ndim == 1 else idx.align(pats)
    return (np.asarray(idx.count(pats)).tolist(),
            [np.asarray(h).tolist() for h in hits])


def _manifest(index_dir):
    """The manifest less the wall times, the index path and the self-crc."""
    with open(os.path.join(index_dir, index_io.MANIFEST_NAME)) as f:
        m = json.load(f)
    m.pop("manifest_crc")
    m["stats"] = {k: v for k, v in m["stats"].items() if k not in WALLS}
    return m


def _check_dirs_equal(a, b):
    for name in (index_io.SA_FILE, index_io.LCP_FILE, index_io.CORPUS_FILE):
        assert _same_bytes(os.path.join(a, name), os.path.join(b, name)), name
    assert _manifest(a) == _manifest(b)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_build_into_index_dir_matches_repro(tmp_path, case):
    """``build(index_dir=...)`` in both packages: byte-identical SA, LCP and
    corpus files, equal manifests (walls aside), equal answers, and each
    package opens the other's directory and answers the same."""
    corpus, sbk = INDEX_CASES[case]
    a, b = str(tmp_path / "repro"), str(tmp_path / "port")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RefIndex.build(corpus, cfg=RefConfig(vocab_size=4), sb=RefSB(**sbk),
                             index_dir=a)
        port = SuffixArrayIndex.build(corpus, cfg=SAConfig(vocab_size=4),
                                      sb=SuperblockConfig(**sbk), index_dir=b,
                                      device="cpu")
    _check_dirs_equal(a, b)
    assert ({k: v for k, v in port.build_stats.items() if k not in WALLS + ("index_dir",)}
            == {k: v for k, v in ref.build_stats.items() if k not in WALLS + ("index_dir",)})
    want = _answers(ref, corpus)
    assert _answers(port, corpus) == want
    assert type(port.store.backend).__name__ == type(ref.store.backend).__name__
    port_of_ref = SuffixArrayIndex.open(a, device="cpu")
    ref_of_port = RefIndex.open(b)
    assert _answers(port_of_ref, corpus) == want
    assert _answers(ref_of_port, corpus) == want
    for x, y in ((port_of_ref, ref_of_port), (port, ref)):
        assert {k: v for k, v in x.stats().items() if k != "index_dir"} == {
            k: v for k, v in y.stats().items() if k != "index_dir"}
    for idx in (ref, port, port_of_ref, ref_of_port):
        idx.close()


@pytest.mark.parametrize("store_backend", ["chunked", "memory"])
@pytest.mark.parametrize("verify", ["eager", "lazy", "off"])
def test_save_then_open_matches_repro(tmp_path, store_backend, verify):
    """``save`` of an in-memory build in both packages writes the same
    bytes; the reopened indexes answer as the built ones, on either store
    backend and at every verify mode."""
    a, b = str(tmp_path / "repro"), str(tmp_path / "port")
    ref = RefIndex.build(READS, cfg=RefConfig(vocab_size=4))
    port = SuffixArrayIndex.build(READS, cfg=SAConfig(vocab_size=4), device="cpu")
    ref.save(a)
    port.save(b)
    _check_dirs_equal(a, b)
    want = _answers(ref, READS)
    with SuffixArrayIndex.open(b, store_backend=store_backend, verify=verify,
                               device="cpu") as reopened:
        assert reopened.index_dir == b and reopened.lcp is not None
        assert _answers(reopened, READS) == want
        ref_reopened = RefIndex.open(b, store_backend=store_backend, verify=verify)
        assert _answers(ref_reopened, READS) == want
        assert reopened.stats()["backend"] == ref_reopened.stats()["backend"]
        assert reopened.engine.engine_stats() == ref_reopened.engine.engine_stats()
        ref_reopened.close()


def test_saving_an_index_served_from_a_corpus_file_points_at_it(tmp_path):
    """An index built over a chunked corpus file keeps serving from it, and
    its saved manifest points at that file instead of copying it."""
    corpus_file = str(tmp_path / "reads.sachunk")
    write_chunked_corpus(READS, corpus_file, chunk_items=8)
    port = SuffixArrayIndex.build(corpus_file, cfg=SAConfig(vocab_size=4),
                                  device="cpu")
    ref = RefIndex.build(corpus_file, cfg=RefConfig(vocab_size=4))
    assert isinstance(port.store.backend, ChunkedFileBackend)
    assert _answers(port, READS) == _answers(ref, READS)
    port.save(str(tmp_path / "ix"))
    manifest = index_io.read_manifest(str(tmp_path / "ix"))
    assert manifest["corpus"]["path"] == os.path.abspath(corpus_file)
    assert not os.path.exists(str(tmp_path / "ix" / index_io.CORPUS_FILE))
    with SuffixArrayIndex.open(str(tmp_path / "ix"), device="cpu") as again:
        assert _answers(again, READS) == _answers(ref, READS)
    port.close()
    ref.close()


# ---------------------------------------------------------------------------
# the streaming out-of-core build
# ---------------------------------------------------------------------------

STREAM_READS = synth_dna_reads(192, 24, seed=7)  # benchmarks/scaling.py's
STREAM_TEXT, _ = synth_token_corpus(4096, 4, seed=7)


@pytest.mark.parametrize("name,knobs", [
    ("reads", dict()),
    ("text", dict()),
    ("reads", dict(emit_lcp=True, pipeline_depth=0)),
    ("text", dict(emit_lcp=True, merge_tile=16)),
], ids=["reads", "text", "reads-lcp-sync", "text-lcp-tile16"])
def test_streaming_build_matches_repro(name, knobs):
    """``store_backend="chunked"`` at a budget of a quarter of the corpus
    bytes (``benchmarks/scaling.py::run_streaming``): repro's SA, LCP,
    Footprint and stats (walls aside), with ``peak_resident_bytes`` under
    the budget."""
    corpus = STREAM_READS if name == "reads" else STREAM_TEXT
    budget = corpus.size * 4 // 4
    sbk = dict(num_superblocks=4, store_backend="chunked",
               cache_budget_bytes=budget, **knobs)
    cfg = dict(vocab_size=4, packing="base")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_superblock(corpus, cfg=RefConfig(**cfg), sb=RefSB(**sbk))
        got = build_suffix_array_superblock(corpus, cfg=SAConfig(**cfg),
                                            sb=SuperblockConfig(**sbk), device="cpu")
    np.testing.assert_array_equal(got.suffix_array, want.suffix_array)
    if knobs.get("emit_lcp"):
        np.testing.assert_array_equal(got.lcp, want.lcp)
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(want.footprint)
    assert ({k: v for k, v in got.stats.items() if k not in WALLS}
            == {k: v for k, v in want.stats.items() if k not in WALLS})
    assert got.stats["store_backend"] == "chunked" and got.stats["spilled_runs"] > 0
    assert got.footprint.peak_resident_bytes <= budget


def test_streaming_build_from_a_corpus_file(tmp_path):
    """A corpus file path builds streaming, as repro's does."""
    p = str(tmp_path / "text.sachunk")
    write_chunked_corpus(STREAM_TEXT, p, chunk_items=256)
    sbk = dict(num_superblocks=3, cache_budget_bytes=8192)
    want = ref_superblock(p, cfg=RefConfig(vocab_size=4), sb=RefSB(**sbk))
    got = build_suffix_array_superblock(p, cfg=SAConfig(vocab_size=4),
                                        sb=SuperblockConfig(**sbk), device="cpu")
    np.testing.assert_array_equal(got.suffix_array, want.suffix_array)
    assert ({k: v for k, v in got.stats.items() if k not in WALLS}
            == {k: v for k, v in want.stats.items() if k not in WALLS})


def test_streaming_build_refuses_the_device_refiner():
    sb = SuperblockConfig(num_superblocks=3, store_backend="chunked",
                          merge_backend="device")
    with pytest.raises(ValueError, match="HBM-resident"):
        build_suffix_array_superblock(STREAM_READS[:30], cfg=SAConfig(vocab_size=4),
                                      sb=sb, device="cpu")


def test_write_manifest_needs_a_spill_dir():
    with pytest.raises(ValueError, match="write_manifest needs spill_dir"):
        build_suffix_array_superblock(STREAM_READS[:30], cfg=SAConfig(vocab_size=4),
                                      sb=SuperblockConfig(write_manifest=True),
                                      device="cpu")


def test_spill_dir_holds_the_output_memmaps(tmp_path):
    """With ``spill_dir`` the SA and LCP come back as memmaps of
    ``suffix_array.npy``/``lcp.npy`` there, the same bytes as repro's, and
    no temporary file is left behind."""
    a, b = str(tmp_path / "repro"), str(tmp_path / "port")
    sbk = dict(num_superblocks=3, emit_lcp=True)
    ref_superblock(STREAM_READS, cfg=RefConfig(vocab_size=4),
                   sb=RefSB(spill_dir=a, **sbk))
    got = build_suffix_array_superblock(STREAM_READS, cfg=SAConfig(vocab_size=4),
                                        sb=SuperblockConfig(spill_dir=b, **sbk),
                                        device="cpu")
    assert isinstance(got.suffix_array, np.memmap) and isinstance(got.lcp, np.memmap)
    for name in (index_io.SA_FILE, index_io.LCP_FILE):
        assert _same_bytes(os.path.join(a, name), os.path.join(b, name))
    assert sorted(os.listdir(b)) == sorted(os.listdir(a)) == [
        index_io.LCP_FILE, index_io.SA_FILE]


def test_header_layout_is_repro_s():
    """The header struct the two packages read and write."""
    from repro_torch.data import chunk_store

    assert chunk_store._HEADER.format == ref_chunk_store._HEADER.format
    assert chunk_store.MAGIC == ref_chunk_store.MAGIC
    assert struct.calcsize(chunk_store._HEADER.format) == chunk_store.HEADER_BYTES
