"""Chunked on-disk corpus format (the >host-RAM store substrate).

A numpy copy of ``repro.data.chunk_store``: the two packages read and write
the same bytes.  The paper's store keeps the raw corpus resident in memory; our
``ChunkedFileBackend`` (``repro_torch.core.store``) bounds *resident* bytes instead:
the corpus lives in this flat chunked file and only an LRU-bounded set of
chunks is ever host-resident.  This module is the serialization layer — a
fixed little-endian header followed by raw row-major int32 tokens, addressed
in chunks of whole corpus *items* (reads-mode rows / text-mode tokens),
followed (version 2) by a per-chunk crc32 footer:

    [magic "SACHNK01"][version u32][text_mode u32]
    [items i64][row_len i64][chunk_items i64]
    [tokens ... int32 LE, row-major]
    [chunk crc32 x num_chunks, u32 LE][table crc32 u32 LE]      (v2)

The footer sits *after* the tokens so the streaming writer stays one-pass:
token bytes land at their final offsets while per-chunk crcs accumulate in
O(num_chunks) memory, and the table's own offset is derived from the
back-patched header.  Version-1 files (no footer) still read — ``verify``
just has nothing to check.  A chunk whose bytes do not match its crc raises
:class:`~repro_torch.core.integrity.CorruptionError` naming the chunk; see
``docs/fault_tolerance.md`` for the full checksum coverage map.

Chunking by whole items keeps reads-mode rows atomic (a row never spans two
chunks); text-mode windows *can* straddle a chunk edge, which the reader
serves exactly via the ``halo`` argument (a chunk plus the next ``halo``
tokens, zero-padded past the corpus end).
"""
from __future__ import annotations

import contextlib
import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.integrity import CorruptionError, crc32_bytes, publish_file

MAGIC = b"SACHNK01"
_HEADER = struct.Struct("<8sIIqqq")
HEADER_BYTES = _HEADER.size
_VERSION = 2  # written; version-1 files (pre-checksum) remain readable


@dataclass(frozen=True)
class ChunkedCorpusMeta:
    """Static geometry of one chunked corpus file."""

    text_mode: bool
    items: int  # rows (reads mode) or tokens (text mode)
    row_len: int  # L (reads) or 1 (text)
    chunk_items: int  # items per chunk (last chunk may be short)
    version: int = _VERSION

    @property
    def num_chunks(self) -> int:
        return max(1, -(-self.items // self.chunk_items))

    @property
    def corpus_bytes(self) -> int:
        """Raw on-disk token bytes (int32 lanes, the resident-set yardstick)."""
        return self.items * self.row_len * 4

    @property
    def chunk_bytes(self) -> int:
        """Bytes of one full chunk (the LRU cache's unit of residency)."""
        return self.chunk_items * self.row_len * 4

    def chunk_range(self, ci: int) -> tuple:
        lo = ci * self.chunk_items
        return lo, min(lo + self.chunk_items, self.items)


def default_chunk_items(items: int, row_len: int,
                        target_bytes: int = 1 << 20) -> int:
    """Chunk size heuristic: ~``target_bytes`` per chunk, at least one item,
    and at least 8 chunks for any non-trivial corpus (so an LRU budget of a
    fraction of the corpus actually exercises eviction)."""
    by_bytes = max(1, target_bytes // max(1, row_len * 4))
    by_count = max(1, -(-items // 8))
    return max(1, min(items, by_bytes, by_count))


def chunk_items_for_budget(items: int, row_len: int,
                           cache_budget_bytes: int) -> int:
    """Chunk size compatible with a resident-byte budget.

    The single source of the budget split used by the streaming build
    (``repro_torch.core.superblock``) *and* the launcher's ``--corpus-file``
    serialization: the LRU cache gets half the budget, so chunks target an
    eighth of it (several chunks cacheable, and a written file can never
    make ``ChunkedFileBackend`` reject the same budget later).
    """
    return default_chunk_items(
        items, row_len, target_bytes=max(row_len * 4, cache_budget_bytes // 8))


def _write_footer(f, crcs: List[int]) -> None:
    table = np.asarray(crcs, "<u4").tobytes()
    f.write(table)
    f.write(struct.pack("<I", crc32_bytes(table)))


def write_chunked_corpus(corpus, path: str, chunk_items: int = 0) -> ChunkedCorpusMeta:
    """Serialize a corpus array to the chunked on-disk format.

    ``corpus``: (items,) int32 tokens (text mode) or (items, L) int32 rows
    (reads mode).  ``chunk_items`` 0 derives :func:`default_chunk_items`.
    Written to a tmp name and atomically published (fsync'd rename), so a
    crash mid-serialization never leaves a half-written corpus at ``path``.
    Returns the written :class:`ChunkedCorpusMeta`.
    """
    corpus = np.asarray(corpus, np.int32)
    text_mode = corpus.ndim == 1
    if text_mode:
        items, row_len = corpus.shape[0], 1
    else:
        items, row_len = corpus.shape
    if chunk_items <= 0:
        chunk_items = default_chunk_items(items, row_len)
    chunk_items = max(1, min(chunk_items, max(items, 1)))
    meta = ChunkedCorpusMeta(text_mode=text_mode, items=items,
                             row_len=row_len, chunk_items=chunk_items)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(_HEADER.pack(MAGIC, _VERSION, int(text_mode),
                                 items, row_len, chunk_items))
            # stream chunk by chunk: the writer never needs more than one
            # chunk contiguous (the input array may itself be a memmap).
            crcs = []
            for ci in range(meta.num_chunks):
                lo, hi = meta.chunk_range(ci)
                raw = np.ascontiguousarray(corpus[lo:hi], "<i4").tobytes()
                crcs.append(crc32_bytes(raw))
                f.write(raw)
            _write_footer(f, crcs)
        publish_file(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return meta


def write_chunked_stream(batches, path: str,
                         chunk_items: int = 0) -> ChunkedCorpusMeta:
    """Serialize a corpus arriving as an *iterable of item batches* — the
    >RAM writer: at no point is more than one batch plus one partial-chunk
    carry buffer resident.

    ``batches`` yields (b,) int32 token arrays (text mode) or (b, L) int32
    row arrays (reads mode); geometry comes from the first batch and every
    later batch must match it.  The total item count is unknown up front, so
    a placeholder header is written first and back-patched once the stream
    is drained (the header lives at a fixed offset); per-chunk crcs
    accumulate batch by batch (batches need not align to chunk edges) and
    land in the trailing footer.  ``chunk_items`` 0 derives ~1 MiB chunks
    (the item count is unknown, so the at-least-8-chunks clause of
    :func:`default_chunk_items` cannot apply).

    The write happens under a tmp name, atomically published (fsync'd
    rename) once complete: a crash mid-stream leaves nothing at ``path``.
    Returns the final :class:`ChunkedCorpusMeta`; an empty iterable is an
    error (a corpus file must carry its geometry).
    """
    it = iter(batches)
    try:
        first = np.asarray(next(it), np.int32)
    except StopIteration:
        raise ValueError("write_chunked_stream: empty batch iterable "
                         "(geometry is derived from the first batch)") from None
    text_mode = first.ndim == 1
    row_len = 1 if text_mode else first.shape[1]
    if chunk_items <= 0:
        chunk_items = max(1, (1 << 20) // max(1, row_len * 4))
    items = 0
    crcs: List[int] = []
    chunk_crc = 0  # running crc of the partially-filled current chunk
    chunk_fill = 0  # items accumulated into it so far
    item_bytes = row_len * 4
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(_HEADER.pack(MAGIC, _VERSION, int(text_mode),
                                 0, row_len, chunk_items))  # back-patched
            batch = first
            while batch is not None:
                batch = np.asarray(batch, np.int32)
                if (batch.ndim != first.ndim
                        or (not text_mode and batch.shape[1] != row_len)):
                    raise ValueError(
                        f"write_chunked_stream: batch shape {batch.shape} "
                        f"does not match the first batch's geometry "
                        f"({'text' if text_mode else f'rows of {row_len}'})")
                raw = np.ascontiguousarray(batch, "<i4").tobytes()
                f.write(raw)
                # fold the batch into per-chunk crcs at chunk-edge splits
                view = memoryview(raw)
                n = batch.shape[0]
                pos = 0
                while pos < n:
                    take = min(chunk_items - chunk_fill, n - pos)
                    chunk_crc = zlib.crc32(
                        view[pos * item_bytes:(pos + take) * item_bytes],
                        chunk_crc)
                    chunk_fill += take
                    pos += take
                    if chunk_fill == chunk_items:
                        crcs.append(chunk_crc & 0xFFFFFFFF)
                        chunk_crc = chunk_fill = 0
                items += n
                batch = next(it, None)
            if chunk_fill or not crcs:
                crcs.append(chunk_crc & 0xFFFFFFFF)  # short final chunk
            _write_footer(f, crcs)
            f.seek(0)
            f.write(_HEADER.pack(MAGIC, _VERSION, int(text_mode),
                                 items, row_len, chunk_items))
        publish_file(tmp, path)
    except BaseException:
        # a crash/error mid-stream must never leave a valid-looking file:
        # only the tmp name is ever partially written, and it is removed.
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return ChunkedCorpusMeta(text_mode=text_mode, items=items,
                             row_len=row_len, chunk_items=chunk_items)


def read_chunked_corpus_meta(path: str) -> ChunkedCorpusMeta:
    with open(path, "rb") as f:
        raw = f.read(HEADER_BYTES)
    if len(raw) < HEADER_BYTES:
        raise ValueError(f"{path}: truncated chunked-corpus header")
    magic, version, text_mode, items, row_len, chunk_items = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a chunked corpus file (magic {magic!r})")
    if version not in (1, _VERSION):
        raise ValueError(f"{path}: unsupported version {version}")
    return ChunkedCorpusMeta(text_mode=bool(text_mode), items=items,
                             row_len=row_len, chunk_items=chunk_items,
                             version=version)


class ChunkedCorpusReader:
    """pread-based random access over a chunked corpus file.

    Every read is positional (``os.pread``), so one reader can serve
    interleaved chunk and range requests without seek state; nothing is
    cached here — residency policy belongs to the caller (the store
    backend's LRU).  Positional reads also make the reader safe under the
    pipelined build's staging prefetch (``core/pipeline_exec.py``): the
    background worker and the merge path can read through the same fd
    concurrently without corrupting each other's offsets.  The *backend
    cache above this reader* is not thread-safe — the pipeline keeps all
    cache-touching calls on one thread at a time (store-quiescence
    windows), which is why only ``stage_items``/``fetch_keys`` hand-offs
    are prefetched.

    ``verify=True`` (default) checks each whole-chunk read against the v2
    footer crcs — :meth:`read_chunk` is the store backend's only load path,
    so every byte the LRU ever caches is verified on the way in.  Range
    reads (:meth:`read_items`) are sub-chunk and stay unverified; callers
    needing end-to-end assurance on those run :meth:`verify_all` first
    (``open_index(verify="eager")`` does).  Version-1 files carry no crcs;
    ``verify`` is a no-op for them.
    """

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        self.meta = read_chunked_corpus_meta(path)
        self.verify = bool(verify) and self.meta.version >= 2
        self._fd = os.open(path, os.O_RDONLY)
        self._crcs: Optional[np.ndarray] = None
        if self.meta.version >= 2:
            self._crcs = self._load_footer()

    def _artifact(self, what: str) -> str:
        return f"{what} of {os.path.basename(self.path)}"

    def _load_footer(self) -> np.ndarray:
        m = self.meta
        off = HEADER_BYTES + m.corpus_bytes
        want = m.num_chunks * 4 + 4
        raw = os.pread(self._fd, want, off)
        if len(raw) != want:
            raise CorruptionError(
                self._artifact("chunk checksum table"),
                detail=f"short footer read ({len(raw)} of {want} bytes)",
                path=self.path)
        table, tail = raw[:-4], raw[-4:]
        if struct.unpack("<I", tail)[0] != crc32_bytes(table):
            raise CorruptionError(
                self._artifact("chunk checksum table"),
                detail="table crc mismatch", path=self.path)
        return np.frombuffer(table, "<u4")

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "ChunkedCorpusReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _read_tokens(self, tok_lo: int, tok_hi: int) -> np.ndarray:
        """Flat token positions [tok_lo, tok_hi) across the whole corpus,
        zero-padded past the end (the suffix-window padding convention)."""
        total = self.meta.items * self.meta.row_len
        want = tok_hi - tok_lo
        avail = max(0, min(tok_hi, total) - tok_lo)
        out = np.zeros(want, np.int32)
        if avail:
            raw = os.pread(self._fd, avail * 4, HEADER_BYTES + tok_lo * 4)
            if len(raw) != avail * 4:
                raise IOError(
                    f"{self.path}: short read at token {tok_lo} "
                    f"({len(raw)} of {avail * 4} bytes)"
                )
            out[:avail] = np.frombuffer(raw, "<i4")
        return out

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        """Materialize items [lo, hi): (hi-lo,) tokens or (hi-lo, L) rows.

        Sub-chunk ranges carry no crc of their own — this path is
        unverified (see the class docstring)."""
        m = self.meta
        lo, hi = max(0, lo), min(hi, m.items)
        flat = self._read_tokens(lo * m.row_len, hi * m.row_len)
        return flat if m.text_mode else flat.reshape(hi - lo, m.row_len)

    def _check_chunk(self, ci: int, chunk_rows: np.ndarray) -> None:
        got = crc32_bytes(np.ascontiguousarray(chunk_rows, "<i4").tobytes())
        if got != int(self._crcs[ci]):
            raise CorruptionError(
                self._artifact(f"chunk {ci}"),
                detail=(f"crc 0x{got:08x} != "
                        f"recorded 0x{int(self._crcs[ci]):08x}"),
                path=self.path)

    def read_chunk(self, ci: int, halo: int = 0) -> np.ndarray:
        """Chunk ``ci`` plus ``halo`` extra trailing *tokens* (text mode:
        serves windows that straddle the chunk edge; zero-padded past the
        corpus end).  Reads mode returns (rows, L) and accepts no halo —
        rows are atomic, no window spans a chunk.
        """
        m = self.meta
        lo, hi = m.chunk_range(ci)
        if m.text_mode:
            buf = self._read_tokens(lo, hi + halo)
            if self.verify:
                self._check_chunk(ci, buf[:hi - lo])  # halo: next chunk's crc
            return buf
        if halo:
            raise ValueError("halo is a text-mode concept (rows are atomic)")
        rows = self.read_items(lo, hi)
        if self.verify:
            self._check_chunk(ci, rows)
        return rows

    def verify_all(self) -> int:
        """Eagerly verify every chunk crc (one sequential pass); returns the
        number of chunks checked (0 for a version-1 file)."""
        if self._crcs is None:
            return 0
        m = self.meta
        for ci in range(m.num_chunks):
            lo, hi = m.chunk_range(ci)
            self._check_chunk(ci, self._read_tokens(lo * m.row_len,
                                                    hi * m.row_len))
        return m.num_chunks


def load_corpus(path: str) -> np.ndarray:
    """Materialize a whole chunked corpus file as one host array.

    The store-layer front door for whole-file loads (salint SAL002 bans raw
    ``read_items`` calls elsewhere): opens, reads, and closes the reader in
    one scope, so callers cannot leak the fd.
    """
    with ChunkedCorpusReader(path) as r:
        return r.read_items(0, r.meta.items)
