"""The in-memory data store: ``mgetsuffix`` (paper §IV, Redis).

The port of ``repro.core.store``, in two halves.

Device half.  The corpus stays resident on the card, sharded over the ranks
of ``StoreSpec.ranks`` in blocks of ``rows_per_shard`` rows, and requests
carry indexes only; ``mget_window`` routes a batch of (row, offset) requests
to their owner ranks with one ``exchange``, gathers the K-token windows there
(the ``window_gather`` kernel under ``cfg.use_pallas``), a bounded chunk of
slots at a time, and returns them with a second ``exchange``, or the
already-packed key words under ``server_pack``.  ``serve_windows`` is what
the pipeline calls at one shard: the same service, but it gathers and packs
only the served rows, so a round over 201 M suffixes never holds a window
per capacity slot.  The rank store (``mget_scalar``, ``scatter_update``)
routes one int32 a position the same way.

Serving half (``StoreBackend``, ``InMemoryBackend``, ``ChunkedFileBackend``,
the proxies ``ThrottledBackend``, ``RetryingBackend`` and ``FlakyBackend``,
``CorpusStore``, ``WindowCursor``).  The JAX package keeps these on the
host; in the port the in-memory backend's padded corpus is a tensor on its
device, and ``CorpusStore`` takes and returns tensors there.  The chunked
backend keeps the JAX package's design: the corpus on disk, an LRU cache of
chunks on the host under ``cache_budget_bytes``; the store gathers from it
one capacity chunk a call, as the JAX store does (so its cache counters are
the JAX package's), and moves each batch of windows to its device in one
copy.  A proxy is called one capacity chunk a call too (so its call counts
and fault ordinals are the JAX package's); over an in-memory backend each
chunk is a gather on the device.  The query engine, the post-hoc LCP, the
per-superblock builds and the out-of-core merge (``fetch_keys``,
``gather_keys`` + ``note_fetched``, ``rank_windows``, ``mget_window_host``,
the merge frontier) go through it, with the JAX package's traffic and
residency counters.  ``WindowCursor``, the k-way merge's cache, keeps its
packed keys on the host, where the merge's heap compares them.
"""
from __future__ import annotations

import math
import operator
import time
from dataclasses import dataclass
from collections import OrderedDict
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.distributed import SINGLE, Ranks, bucket_scatter, exchange, lex_order
from repro_torch.core.integrity import (
    DEFAULT_RETRYABLE,
    CorruptionError,
    TransientStoreError,
)
from repro_torch.core.spans import span
from repro_torch.core.types import WORD_BITS
from repro_torch.device import resolve_device

# Most requests whose windows are gathered at once by serve_windows.
FETCH_CHUNK = 1 << 22
# Default resident-byte budget of the chunked store backend (LRU chunk cache
# and merge frontier share it; see superblock._resolve_backend).
DEFAULT_CACHE_BUDGET = 64 << 20


def index_request_bytes(num_items: int, stride_bits: int) -> int:
    """Modeled bytes of one suffix-index request: int31 words carried in
    int32 lanes, one while the address space fits 31 bits, two beyond
    (``repro.core.store.index_request_bytes``)."""
    bits = max(1, (max(num_items - 1, 1)).bit_length() + stride_bits)
    return 4 * -(-bits // WORD_BITS)


@dataclass(frozen=True)
class StoreSpec:
    """Static layout of the store; ``ranks`` holds its shards, one a rank
    (the JAX package's ``axis``)."""

    num_shards: int
    rows_per_shard: int  # reads mode: rows; text mode: tokens
    row_len: int  # L (reads) or 1 (text)
    request_capacity: int  # per-destination capacity
    ranks: Ranks = SINGLE

    @property
    def is_text(self) -> bool:
        return self.row_len == 1

    @property
    def index_bytes(self) -> int:
        stride = 0 if self.is_text else int(math.ceil(math.log2(self.row_len + 1)))
        return index_request_bytes(self.num_shards * self.rows_per_shard, stride)


@dataclass
class FetchStats:
    """Per-call effective/padded byte counters (int64 device scalars)."""

    requests: torch.Tensor
    request_bytes: torch.Tensor
    response_bytes: torch.Tensor
    padded_request_bytes: int
    padded_response_bytes: int
    dropped: torch.Tensor


def token_bytes(vocab_size: int) -> int:
    """Bytes per raw token for footprint accounting (paper counts chars)."""
    return max(1, (max(vocab_size, 1).bit_length() + 7) // 8)


def _response_bytes(cfg: SAConfig, k: int) -> int:
    """Effective bytes of one response: packed words or raw tokens."""
    if cfg.server_pack:
        return 4 * cfg.key_words
    return k * token_bytes(cfg.vocab_size)


def _fetch_stats(n_ok, dropped, spec: StoreSpec, cfg: SAConfig,
                 k: int) -> FetchStats:
    per_resp = _response_bytes(cfg, k)
    cap = spec.num_shards * spec.request_capacity
    n_ok = n_ok.long()
    return FetchStats(
        requests=n_ok,
        request_bytes=n_ok * spec.index_bytes,
        response_bytes=n_ok * per_resp,
        padded_request_bytes=cap * 8,
        padded_response_bytes=cap * per_resp,
        dropped=dropped.long(),
    )


def _gather(local_rows, local_row, off, spec: StoreSpec, cfg: SAConfig, k: int):
    """Owner-side window gather of local (row, offset) requests."""
    if spec.is_text:
        return _text_window(local_rows.reshape(-1), local_row, off, k)
    if cfg.use_pallas:
        from repro_torch.kernels import ops as kops  # the mgetsuffix kernel

        return kops.window_gather(local_rows, local_row, off, k)
    return encoding.window_at(local_rows, local_row, off, k)


def mget_window(
    local_rows: torch.Tensor,
    row_id: torch.Tensor,
    offset: torch.Tensor,
    active: torch.Tensor,
    spec: StoreSpec,
    cfg: SAConfig,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, FetchStats]:
    """Batched window fetch ("mgetsuffix") from the sharded store.

    The contract of ``repro.core.store.mget_window``: requests are bucketed
    by owner rank with ``request_capacity`` slots per owner and exchanged;
    the owner gathers a window for every slot it received, at most
    ``FETCH_CHUNK`` slots at a time, and the responses are exchanged back and
    routed by slot.  ``local_rows`` is this rank's shard, ``row_id`` and
    ``offset`` global.  Returns (win_or_words, exhausted, ok, stats):
    (M, K) windows or (M, key_words) packed words under ``cfg.server_pack``;
    ``exhausted`` is True where the window ran past the suffix end or the
    request was not served; ``ok`` is False for inactive requests and
    capacity drops.
    """
    k = window or cfg.prefix_len
    d, cap = spec.num_shards, spec.request_capacity

    with span("sa.store.fetch", row_id.device):
        owner = torch.where(active, torch.div(row_id, spec.rows_per_shard,
                                              rounding_mode="floor"), d)
        owner = owner.clamp(0, d).to(torch.int32)  # inactive -> dump bucket d
        reqs = torch.stack([torch.where(active, row_id, -1),
                            torch.where(active, offset, 0)], dim=1)
        buf, slot, _ = bucket_scatter(reqs, owner, d + 1, cap, fill=-1)
        dropped = torch.sum(active & (slot >= d * cap))

        recv = exchange(buf[:d], spec.ranks).reshape(d * cap, 2)
        del buf
        base = spec.ranks.rank * spec.rows_per_shard
        resp_width = cfg.key_words if cfg.server_pack else k
        payload = torch.empty((d * cap, resp_width + 1), dtype=torch.int32,
                              device=recv.device)
        for lo in range(0, d * cap, FETCH_CHUNK):
            hi = lo + FETCH_CHUNK
            req_row = recv[lo:hi, 0]
            local_row = torch.where(req_row >= 0, req_row - base, -1).contiguous()
            windows = _gather(local_rows, local_row, recv[lo:hi, 1].contiguous(),
                              spec, cfg, k)
            payload[lo:hi, resp_width] = torch.any(windows == 0, dim=-1)
            payload[lo:hi, :resp_width] = (
                encoding.pack_words(windows, cfg) if cfg.server_pack else windows)
            del windows, local_row
        del recv

        flatresp = exchange(payload.reshape(d, cap, resp_width + 1), spec.ranks)
        flatresp = flatresp.reshape(d * cap, resp_width + 1)
        guard = torch.zeros((1, resp_width + 1), dtype=flatresp.dtype,
                            device=flatresp.device)
        flatresp = torch.cat([flatresp, guard], dim=0)
        back = flatresp[slot.long().clamp(0, d * cap)]
        ok = active & (slot < d * cap)
        out = torch.where(ok[:, None], back[:, :resp_width], 0)
        exhausted = torch.where(ok, back[:, resp_width] > 0, True)
        return out, exhausted, ok, _fetch_stats(torch.sum(ok), dropped, spec, cfg, k)


def serve_windows(
    local_rows: torch.Tensor,
    row_id: torch.Tensor,
    offset: torch.Tensor,
    active: torch.Tensor,
    spec: StoreSpec,
    cfg: SAConfig,
    chunk: int = FETCH_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, FetchStats]:
    """:func:`mget_window` at one shard, gathering only the served rows
    (the pipeline's fetch at one rank; at D ranks it calls
    :func:`mget_window`).

    Which requests are served is decided over the whole batch first, as
    ``bucket_scatter`` routes them: active requests owned by shard 0 are
    served in array order up to ``request_capacity``; every other active
    request is a drop.  The served rows are then gathered and packed in
    chunks of at most ``chunk`` requests.

    Returns (words, exhausted, ok, stats): (M, key_words) packed key words
    of the served windows (0 elsewhere, which is also what packing
    ``mget_window``'s zeroed raw responses gives), and ``exhausted``, ``ok``
    and stats exactly as one :func:`mget_window` call gives them.
    """
    k = cfg.prefix_len
    if spec.num_shards != 1:
        raise ValueError("serve_windows serves one shard; use mget_window")
    with span("sa.store.fetch", row_id.device):
        m = row_id.shape[0]
        dev = row_id.device
        owned = active & (row_id < spec.rows_per_shard)
        ok = owned & (torch.cumsum(owned, 0) <= spec.request_capacity)
        words = torch.zeros((m, cfg.key_words), dtype=torch.int32, device=dev)
        exhausted = torch.ones((m,), dtype=torch.bool, device=dev)
        served = torch.nonzero(ok).squeeze(1)
        for lo in range(0, served.shape[0], chunk):
            idx = served[lo : lo + chunk]
            win = _gather(local_rows, row_id[idx], offset[idx], spec, cfg, k)
            exhausted[idx] = torch.any(win == 0, dim=-1)
            words[idx] = encoding.pack_words(win, cfg)
            del win
        n_ok = torch.tensor(served.shape[0], device=dev)
        dropped = torch.sum(active) - n_ok
        return words, exhausted, ok, _fetch_stats(n_ok, dropped, spec, cfg, k)


def _text_window(flat: torch.Tensor, local_pos: torch.Tensor, off: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Text-mode window gather from a flat local token shard (0-padded)."""
    n = flat.shape[0]
    padded = torch.nn.functional.pad(flat, (0, k))
    pos = torch.where(local_pos >= 0, local_pos + off, n).clamp(0, n).long()
    cols = (pos[:, None] + torch.arange(k, device=flat.device)[None, :]).clamp(
        0, n + k - 1)
    return padded[cols]


def _scalar_owner(pos: torch.Tensor, active: torch.Tensor, spec: StoreSpec):
    """Owner shard of each active in-range position; ``num_shards`` (the
    dump bucket) for the rest."""
    d = spec.num_shards
    live = active & (pos >= 0) & (pos < d * spec.rows_per_shard)
    return torch.where(live, torch.div(pos, spec.rows_per_shard, rounding_mode="floor"),
                       d).to(torch.int32)


def mget_scalar(
    local_vals: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    spec: StoreSpec,
    fill: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fetch one int32 per global position from the rank store
    (``repro.core.store.mget_scalar``): requests are bucketed by owner rank
    with ``request_capacity`` slots, exchanged, served there, and routed
    back by slot; an unserved or inactive request reads ``fill``.  Returns
    (values, dropped)."""
    d, cap = spec.num_shards, spec.request_capacity
    owner = _scalar_owner(pos, active, spec)
    reqs = torch.stack([pos, torch.zeros_like(pos)], dim=1)
    buf, slot, _ = bucket_scatter(reqs, owner, d + 1, cap, fill=-1)
    dropped = torch.sum(active & (slot >= d * cap)).to(torch.int32)
    req_pos = exchange(buf[:d], spec.ranks)[..., 0].reshape(-1)
    lp = req_pos - spec.ranks.rank * spec.rows_per_shard
    ok = (req_pos >= 0) & (lp >= 0) & (lp < spec.rows_per_shard)
    lp = lp.clamp(0, spec.rows_per_shard - 1).long()
    vals = torch.where(ok, local_vals[lp], fill)
    resp = exchange(vals.reshape(d, cap, 1), spec.ranks).reshape(-1)
    resp = torch.cat([resp, resp.new_full((1,), fill)])
    back = resp[slot.long().clamp(0, d * cap)]
    return torch.where(active & (slot < d * cap), back, fill), dropped


def scatter_update(
    local_vals: torch.Tensor,
    pos: torch.Tensor,
    values: torch.Tensor,
    active: torch.Tensor,
    spec: StoreSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter (pos -> value) into the rank store, the rank write-back
    (``repro.core.store.scatter_update``): requests past an owner's
    ``request_capacity`` are dropped.  Returns (new_local_vals, dropped)."""
    d, cap = spec.num_shards, spec.request_capacity
    rows = spec.rows_per_shard
    owner = _scalar_owner(pos, active, spec)
    reqs = torch.stack([pos, values], dim=1)
    buf, slot, _ = bucket_scatter(reqs, owner, d + 1, cap, fill=-1)
    dropped = torch.sum(active & (slot >= d * cap)).to(torch.int32)
    recv = exchange(buf[:d], spec.ranks).reshape(d * cap, 2)
    lp = recv[:, 0] - spec.ranks.rank * rows
    ok = (recv[:, 0] >= 0) & (lp >= 0) & (lp < rows)
    padded = torch.cat([local_vals, local_vals.new_zeros((1,))])
    padded[lp[ok].long()] = recv[:, 1][ok]
    return padded[:rows], dropped


_PLACE_VALUES = {}  # (base, digits, device) -> place values on the device


def _place_values(base: int, digits: int, device) -> torch.Tensor:
    """``base^(digits-1), ..., base^0`` as int64 (wrapped mod 2^64), made on
    ``device`` once, so a pack issues no host-to-device copy."""
    key = (base, digits, str(device))
    place = _PLACE_VALUES.get(key)
    if place is None:
        powers = [pow(base, e, 1 << 64) for e in range(digits - 1, -1, -1)]
        powers = [p - (1 << 64) if p >= 1 << 63 else p for p in powers]
        place = _PLACE_VALUES[key] = torch.tensor(powers, dtype=torch.int64,
                                                  device=device)
    return place


def pack_keys(windows: torch.Tensor, cfg: SAConfig) -> torch.Tensor:
    """(..., K) token windows -> (..., key_words) int32 key words.

    The tensor counterpart of ``repro.core.store.pack_keys_np``: the words
    are accumulated in int64 and cast to int32 at the end, so int64 windows
    give the same words as ``pack_keys_np`` (wrapping included).
    """
    w = windows.to(torch.int64)
    cpw = cfg.resolved_chars_per_word()
    assert w.shape[-1] == cpw * cfg.key_words, (tuple(w.shape), cpw * cfg.key_words)
    if cfg.packing == "base":
        # sum of token * base^place: the Horner loop's value mod 2^64, in a
        # few tensor ops instead of two a token
        place = _place_values(cfg.vocab_size + 1, cpw, w.device)
        w = w.reshape(*w.shape[:-1], cfg.key_words, cpw)
        return (w * place).sum(dim=-1).to(torch.int32)
    bits = max(1, int(cfg.vocab_size).bit_length())
    words = []
    for i in range(cfg.key_words):
        acc = torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)
        for j in range(i * cpw, (i + 1) * cpw):
            acc = (acc << bits) | w[..., j]
        words.append((acc << (31 - bits * cpw)).to(torch.int32))
    return torch.stack(words, dim=-1)


def _wrap_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def host_key_packer(cfg: SAConfig) -> Callable[[List[int]], Tuple[int, ...]]:
    """A function that packs one K-token window (a list of ints) to its key
    words as a tuple of ints: the words :func:`pack_keys` gives, computed
    on the host (the exact value wrapped to int32 is the int64 sum's int32
    cast)."""
    cpw = cfg.resolved_chars_per_word()
    spans = [(i * cpw, (i + 1) * cpw) for i in range(cfg.key_words)]
    if cfg.packing == "base":
        base = cfg.vocab_size + 1
        place = [base ** e for e in range(cpw - 1, -1, -1)]

        def pack(window: List[int]) -> Tuple[int, ...]:
            return tuple([_wrap_int32(sum(map(operator.mul, window[lo:hi], place)))
                          for lo, hi in spans])
        return pack
    bits = max(1, int(cfg.vocab_size).bit_length())

    def pack_bits(window: List[int]) -> Tuple[int, ...]:
        words = []
        for lo, hi in spans:
            acc = 0
            for t in window[lo:hi]:
                acc = (acc << bits) | t
            words.append(_wrap_int32(acc << (31 - bits * cpw)))
        return tuple(words)
    return pack_bits


def lex_less_rows(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise lexicographic compare of two (m, W) key-word matrices:
    ``(less, equal)`` bool vectors (``repro.core.store.lex_less_rows``)."""
    lt = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    for w in range(a.shape[1]):
        lt |= eq & (a[:, w] < b[:, w])
        eq &= a[:, w] == b[:, w]
    return lt, eq


# ---------------------------------------------------------------------------
# Store backends: where the corpus lives
# ---------------------------------------------------------------------------


class StoreBackend:
    """Protocol for the raw-token substrate behind :class:`CorpusStore`
    (``repro.core.store.StoreBackend``).

    Shared geometry (set by :meth:`_init_geometry`): ``text_mode``, ``n``
    (items), ``row_len``, ``stride_bits``, ``max_len``, ``k``.  A backend
    answers exact window gathers on its ``device`` (:meth:`gather`) and
    materializes contiguous item ranges on the host for staging
    (:meth:`read_items`).
    """

    device: torch.device
    # True for a backend whose counters and residency depend on its call
    # pattern: the store then calls it one capacity chunk a call, as the
    # JAX store calls every backend
    per_round = False
    # True for a backend whose windows are made on the host (``gather_host``):
    # the store gathers a batch there and copies it to the device once
    host_windows = False

    def _init_geometry(self, text_mode: bool, items: int, row_len: int,
                       cfg: SAConfig) -> None:
        self.text_mode = text_mode
        self.n = items
        self.row_len = row_len
        self.k = cfg.prefix_len
        if text_mode:
            self.stride_bits = 0
            self.max_len = items
        else:
            self.stride_bits = int(math.ceil(math.log2(row_len + 1)))
            self.max_len = row_len + 1
        self.cache_hits = 0
        self.cache_misses = 0
        self.corpus_bytes = items * row_len * 4  # int32 lanes

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n,) if self.text_mode else (self.n, self.row_len)

    @property
    def resident_bytes(self) -> int:
        raise NotImplementedError

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 1.0

    def gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """(m,) int64 global suffix ids -> (m, K) int32 windows at token
        offset ``depth * K`` into each suffix (0-padded past the end)."""
        raise NotImplementedError

    def window(self, gidx: int, depth: int) -> np.ndarray:
        """One suffix's (K,) window at ``depth``, on the host: what
        :meth:`gather` gives for one suffix, from one call."""
        raise NotImplementedError

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:  # optional hook, default no-op
        pass


def padded_windows(padded: torch.Tensor, stride_bits: int, k: int,
                   gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(m, K) int32 windows of suffixes ``gidx`` at token offset ``depth * K``
    of a corpus zero-padded by K tokens (``InMemoryBackend.padded``): token
    p of suffix g is the corpus token there, 0 past the text's end or the
    row's.  No counter is touched."""
    cols = torch.arange(k, device=padded.device)
    if padded.dim() == 1:
        n = padded.shape[0] - k
        pos = torch.clamp(gidx + depth * k, max=n)
        return padded[torch.clamp(pos[:, None] + cols[None, :], max=n + k - 1)]
    row = gidx >> stride_bits
    off = gidx & ((1 << stride_bits) - 1)
    off = torch.clamp(off + depth * k, max=padded.shape[1] - k)
    return padded[row[:, None], off[:, None] + cols[None, :]]


class InMemoryBackend(StoreBackend):
    """Whole-corpus backend, resident on ``device`` (the card by default).

    The corpus zero-padded by K tokens at the end of the text or of every
    row (``padded``: ``(n + K,)`` or ``(rows, row_len + K)``) is an int32
    tensor there; the host array is kept for :meth:`read_items`.
    """

    def __init__(self, corpus, cfg: SAConfig, device=None):
        corpus = np.ascontiguousarray(corpus, np.int32)
        text_mode = corpus.ndim == 1
        if text_mode:
            items, row_len = corpus.shape[0], 1
        else:
            items, row_len = corpus.shape
        self._init_geometry(text_mode, items, row_len, cfg)
        self.device = resolve_device(device)
        self._corpus = corpus
        self.padded = torch.nn.functional.pad(
            torch.from_numpy(corpus).to(self.device), (0, self.k))

    @property
    def resident_bytes(self) -> int:
        return self.padded.numel() * self.padded.element_size()

    def gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        self.cache_hits += int(gidx.shape[0])  # always resident
        return padded_windows(self.padded, self.stride_bits, self.k, gidx, depth)

    def window(self, gidx: int, depth: int) -> np.ndarray:
        """A view of ``padded`` at offsets computed here, copied to the host
        in one copy: no kernel is launched."""
        self.cache_hits += 1
        if self.text_mode:
            pos = min(gidx + depth * self.k, self.n)
            view = self.padded[pos : pos + self.k]
        else:
            off = min((gidx & ((1 << self.stride_bits) - 1)) + depth * self.k,
                      self.row_len)
            view = self.padded[gidx >> self.stride_bits, off : off + self.k]
        return view.cpu().numpy()

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        return self._corpus[lo:hi]


class ChunkedFileBackend(StoreBackend):
    """Disk-resident backend: chunked corpus file + budgeted LRU chunk cache
    (``repro.core.store.ChunkedFileBackend``).

    The corpus lives in the ``repro_torch.data.chunk_store`` format and only
    cached chunks are host-resident: ``resident_bytes`` is the exact sum of
    cached chunk array bytes and never exceeds ``cache_budget_bytes``
    (eviction runs *before* a miss loads).  Text-mode chunks carry a K-token
    halo so windows straddling a chunk edge are served from one chunk;
    reads-mode rows are atomic within a chunk.  ``read_items`` streams from
    the file without touching the cache.  ``gather_host`` is the JAX
    backend's numpy gather; ``gather`` wraps it for tensors and returns the
    windows on ``device`` (the card by default).
    """

    per_round = True
    host_windows = True

    def __init__(self, path: str, cfg: SAConfig, cache_budget_bytes: int = 0,
                 verify: bool = True, device=None):
        from repro_torch.data.chunk_store import ChunkedCorpusReader

        self.device = resolve_device(device)
        # every chunk the LRU caches is crc-checked on load (v2 files)
        self._reader = ChunkedCorpusReader(path, verify=verify)
        meta = self._reader.meta
        self._init_geometry(meta.text_mode, meta.items, meta.row_len, cfg)
        self.path = path
        self.chunk_items = meta.chunk_items
        self.num_chunks = meta.num_chunks
        # a text chunk resident in cache carries its K-token halo
        halo_bytes = self.k * 4 if meta.text_mode else 0
        self._full_chunk_bytes = meta.chunk_bytes + halo_bytes
        if cache_budget_bytes <= 0:
            cache_budget_bytes = DEFAULT_CACHE_BUDGET
        if cache_budget_bytes < self._full_chunk_bytes:
            self._reader.close()  # constructor raises: don't leak the fd
            raise ValueError(
                f"chunk cache budget of {cache_budget_bytes} B cannot hold "
                f"one chunk ({self._full_chunk_bytes} B). The streaming "
                "build gives the LRU half of SuperblockConfig."
                "cache_budget_bytes — lower chunk_records (or rewrite the "
                "corpus file with smaller chunks), or raise the budget"
            )
        self.cache_budget_bytes = int(cache_budget_bytes)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._resident = 0
        self.evictions = 0

    @property
    def resident_bytes(self) -> int:
        return self._resident

    def close(self) -> None:
        self._cache.clear()
        self._resident = 0
        self._reader.close()

    def _chunk(self, ci: int) -> np.ndarray:
        chunk = self._cache.get(ci)
        if chunk is not None:
            self._cache.move_to_end(ci)
            self.cache_hits += 1
            return chunk
        self.cache_misses += 1
        incoming = self._full_chunk_bytes  # upper bound (tail chunks shorter)
        while self._cache and self._resident + incoming > self.cache_budget_bytes:
            _, old = self._cache.popitem(last=False)
            self._resident -= old.nbytes
            self.evictions += 1
        chunk = self._reader.read_chunk(ci, halo=self.k if self.text_mode else 0)
        self._cache[ci] = chunk
        self._resident += chunk.nbytes
        return chunk

    def gather_host(self, gidx: np.ndarray, depth) -> np.ndarray:
        """(m,) int64 global suffix ids and window depths (host arrays) ->
        (m, K) int32 windows, one cache access per chunk touched."""
        gidx = np.asarray(gidx, np.int64)
        m = gidx.shape[0]
        depth = np.broadcast_to(np.asarray(depth, np.int64), (m,))
        out = np.zeros((m, self.k), np.int32)
        if self.text_mode:
            pos = np.minimum(gidx + depth * self.k, self.n)
            ci = np.minimum(pos // self.chunk_items, self.num_chunks - 1)
        else:
            row = (gidx >> self.stride_bits).astype(np.int64)
            off = (gidx & ((1 << self.stride_bits) - 1)).astype(np.int64)
            off = np.minimum(off + depth * self.k, self.max_len - 1)
            ci = row // self.chunk_items
        for c in np.unique(ci):
            sel = np.flatnonzero(ci == c)
            chunk = self._chunk(int(c))
            base = int(c) * self.chunk_items
            if self.text_mode:
                local = pos[sel] - base  # halo covers the straddle/tail
                cols = local[:, None] + np.arange(self.k)[None, :]
                out[sel] = chunk[cols]
            else:
                cols = off[sel][:, None] + np.arange(self.k)[None, :]
                valid = cols < self.row_len  # zero-pad past the row end
                cc = np.minimum(cols, self.row_len - 1)
                out[sel] = np.where(valid, chunk[row[sel] - base][
                    np.arange(sel.size)[:, None], cc], 0)
        return out

    def gather(self, gidx: torch.Tensor, depth) -> torch.Tensor:
        win = self.gather_host(_host(gidx), _host(depth))
        return torch.from_numpy(win).to(self.device)

    def window(self, gidx: int, depth: int) -> np.ndarray:
        """:meth:`gather_host` of one suffix, in scalar arithmetic: one
        cache access of its chunk."""
        k = self.k
        if self.text_mode:
            pos = min(gidx + depth * k, self.n)
            ci = min(pos // self.chunk_items, self.num_chunks - 1)
            local = pos - ci * self.chunk_items  # the halo covers the tail
            return self._chunk(ci)[local : local + k].copy()
        row = gidx >> self.stride_bits
        off = min((gidx & ((1 << self.stride_bits) - 1)) + depth * k, self.max_len - 1)
        ci = row // self.chunk_items
        out = np.zeros(k, np.int32)
        n = max(0, min(k, self.row_len - off))  # zero-pad past the row end
        out[:n] = self._chunk(ci)[row - ci * self.chunk_items, off : off + n]
        return out

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        return self._reader.read_items(lo, hi)


class _ProxyBackend(StoreBackend):
    """A backend around ``inner`` (``repro.core.store``'s proxy idiom):
    geometry, cache counters and residency are the inner backend's, and
    every data call passes through :meth:`_through`, which a proxy
    overrides.  ``per_round``: the store calls a proxy one capacity chunk a
    call, so its call counts are the JAX package's."""

    per_round = True

    def __init__(self, inner: StoreBackend):
        self.inner = inner

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    @property
    def resident_bytes(self) -> int:
        return self.inner.resident_bytes

    @property
    def host_windows(self) -> bool:
        return self.inner.host_windows

    def _through(self, kind: str, fn, *args):
        return fn(*args)

    def gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        return self._through("gather", self.inner.gather, gidx, depth)

    def gather_host(self, gidx: np.ndarray, depth) -> np.ndarray:
        return self._through("gather", self.inner.gather_host, gidx, depth)

    def window(self, gidx: int, depth: int) -> np.ndarray:
        return self._through("gather", self.inner.window, gidx, depth)

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        return self._through("read", self.inner.read_items, lo, hi)

    def close(self) -> None:
        self.inner.close()


class ThrottledBackend(_ProxyBackend):
    """Deterministic slow-medium proxy (``repro.core.store.ThrottledBackend``):
    a fixed ``time.sleep`` before every gather and every ``read_items``
    call, so a pipelined build's overlap is measured against a latency that
    does not depend on the machine's load.  Counts ``gather_calls``,
    ``read_calls``, ``throttled_calls`` and ``throttled_sleep_s``."""

    def __init__(self, inner: StoreBackend, gather_delay_s: float = 0.0,
                 read_delay_s: float = 0.0):
        super().__init__(inner)
        self.gather_delay_s = float(gather_delay_s)
        self.read_delay_s = float(read_delay_s)
        self.gather_calls = 0
        self.read_calls = 0
        self.throttled_calls = 0
        self.throttled_sleep_s = 0.0

    def _through(self, kind: str, fn, *args):
        if kind == "gather":
            self.gather_calls += 1
            seconds = self.gather_delay_s
        else:
            self.read_calls += 1
            seconds = self.read_delay_s
        if seconds > 0:
            time.sleep(seconds)
            self.throttled_calls += 1
            self.throttled_sleep_s += seconds
        return fn(*args)


class RetryingBackend(_ProxyBackend):
    """Transparent retry proxy (``repro.core.store.RetryingBackend``).

    A call that raises one of ``retryable`` (by default
    :data:`~repro_torch.core.integrity.DEFAULT_RETRYABLE`) is retried up to
    ``retries`` times with deterministic capped exponential backoff
    (``backoff_s * 2**attempt``, at most ``max_backoff_s``; no jitter).
    :class:`~repro_torch.core.integrity.CorruptionError` is never retried.
    Counts ``retry_attempts`` (extra attempts), ``retried_calls`` (calls
    that needed one) and ``gave_up`` (calls past the budget), apart from the
    store's traffic counters; ``sleep`` is injectable.
    """

    def __init__(self, inner: StoreBackend, retries: int = 3,
                 backoff_s: float = 0.01, max_backoff_s: float = 1.0,
                 retryable=DEFAULT_RETRYABLE, sleep=time.sleep):
        super().__init__(inner)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.retryable = tuple(retryable)
        self._sleep = sleep
        self.retry_attempts = 0
        self.retried_calls = 0
        self.gave_up = 0

    def _through(self, kind: str, fn, *args):
        attempt = 0
        while True:
            try:
                return fn(*args)
            except CorruptionError:
                raise  # fatal by contract: see repro_torch.core.integrity
            except self.retryable:
                if attempt >= self.retries:
                    self.gave_up += 1
                    raise
                if attempt == 0:
                    self.retried_calls += 1
                self.retry_attempts += 1
                delay = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
                if delay > 0:
                    self._sleep(delay)
                attempt += 1


class FlakyBackend(_ProxyBackend):
    """Deterministic fault injector (``repro.core.store.FlakyBackend``):
    raises :class:`~repro_torch.core.integrity.TransientStoreError` on
    scripted gathers and reads.  ``fail_every=N`` fails every Nth call (call
    0 included), ``fail_gathers``/``fail_reads`` name ordinals; a failing
    call fails ``failures_per_call`` times.  An injected failure does not
    advance the ordinal, so the calls that reach ``inner`` are a fault-free
    run's.  Counts ``gather_calls``, ``read_calls`` and ``injected``."""

    def __init__(self, inner: StoreBackend, fail_gathers=(), fail_reads=(),
                 fail_every: int = 0, failures_per_call: int = 1):
        super().__init__(inner)
        self.fail_gathers = {int(x) for x in fail_gathers}
        self.fail_reads = {int(x) for x in fail_reads}
        self.fail_every = int(fail_every)
        self.failures_per_call = int(failures_per_call)
        self.gather_calls = 0
        self.read_calls = 0
        self.injected = 0
        self._fails: dict = {}

    def _through(self, kind: str, fn, *args):
        attr = "gather_calls" if kind == "gather" else "read_calls"
        n = getattr(self, attr)
        scripted = self.fail_gathers if kind == "gather" else self.fail_reads
        hit = n in scripted or (self.fail_every > 0 and n % self.fail_every == 0)
        c = self._fails.get((kind, n), 0)
        if hit and c < self.failures_per_call:
            self._fails[(kind, n)] = c + 1
            self.injected += 1
            raise TransientStoreError(f"injected {kind} fault at call {n} (#{c + 1})")
        setattr(self, attr, n + 1)
        return fn(*args)


def _host(x) -> np.ndarray:
    """A tensor, array or int as a host int64 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.int64).numpy()
    return np.asarray(x, np.int64)


# ---------------------------------------------------------------------------
# The serving store
# ---------------------------------------------------------------------------


class CorpusStore:
    """Corpus window server (``repro.core.store.CorpusStore``).

    Windows are served from a :class:`StoreBackend` on its device; the store
    owns the traffic accounting of the JAX package: ``request_capacity``
    requests per service round, ``index_bytes`` per request (derived from
    the address space), ``K * token_bytes`` per raw-window response, and
    ``peak_resident_bytes`` of the backend plus the merge frontier that the
    out-of-core merge registers with :meth:`add_frontier`.  From an
    in-memory backend a batch is gathered at once where the JAX store loops
    over capacity chunks, and the counters grow exactly as that loop grows
    them; a ``per_round`` backend (the chunked one, a proxy) is called one
    capacity chunk at a time, as the JAX store calls it.
    """

    def __init__(self, corpus, cfg: SAConfig, request_capacity: int = 4096,
                 backend: Optional[StoreBackend] = None, device=None):
        if backend is None:
            backend = InMemoryBackend(corpus, cfg, device=device)
        self.backend = backend
        self.cfg = cfg
        self.key_words = cfg.key_words
        self.text_mode = backend.text_mode
        self.n = backend.n
        self.stride_bits = backend.stride_bits
        self.max_len = backend.max_len
        self.k = cfg.prefix_len
        self.request_capacity = max(1, int(request_capacity))
        self.token_bytes = token_bytes(cfg.vocab_size)
        self.index_bytes = index_request_bytes(self.n, self.stride_bits)
        self.pack_host = host_key_packer(cfg)
        # fetch accounting
        self.requests = 0
        self.request_bytes = 0
        self.response_bytes = 0
        self.retries = 0
        self.rounds = 0
        self.peak_windows = 0
        # store-layer residency: backend + merge frontier
        self.frontier_bytes = 0
        self.peak_resident_bytes = 0
        # per-block staging (separate from the fetch traffic)
        self.staged_items = 0
        self.staged_bytes = 0
        self._note_resident()

    @property
    def device(self) -> torch.device:
        return self.backend.device

    @property
    def max_window_depth(self) -> int:
        """Upper bound on K-token windows any suffix comparison can consume
        (one extra all-zero window past the end resolves exhaustion)."""
        return -(-self.max_len // self.k) + 2

    def _note_resident(self) -> None:
        cur = self.backend.resident_bytes + self.frontier_bytes
        if cur > self.peak_resident_bytes:
            self.peak_resident_bytes = cur

    def add_frontier(self, delta_bytes: int) -> None:
        """Register merge-frontier residency (the tile buffers' deltas)."""
        self.frontier_bytes += delta_bytes
        if delta_bytes > 0:
            self._note_resident()

    # -- per-block staging --------------------------------------------------
    def stage_read(self, lo: int, hi: int) -> np.ndarray:
        """The backend half of :meth:`stage_items`: the host item range
        ``[lo, hi)``, no store counter touched."""
        return self.backend.read_items(lo, hi)

    def note_staged(self, lo: int, hi: int, nbytes: int) -> None:
        """The accounting half of :meth:`stage_items`."""
        self.staged_items += int(hi - lo)
        self.staged_bytes += int(nbytes)

    def stage_items(self, lo: int, hi: int) -> np.ndarray:
        """The contiguous item range ``[lo, hi)`` for an in-core build, with
        its volume counted in ``staged_items`` / ``staged_bytes``."""
        out = self.stage_read(lo, hi)
        self.note_staged(lo, hi, out.nbytes)
        return out

    def _depths(self, depth, m: int) -> torch.Tensor:
        """(m,) int64 window depths on the device; a Python int is filled in
        there rather than copied from the host (a copy would wait for the
        queued work)."""
        if isinstance(depth, int):
            return torch.full((m,), depth, dtype=torch.int64, device=self.device)
        return torch.as_tensor(depth, dtype=torch.int64, device=self.device).expand(m)

    # -- raw gather ---------------------------------------------------------
    def _gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        out = self.backend.gather(gidx, depth)
        self._note_resident()
        return out

    def _round_windows(self, gidx: torch.Tensor, depth, each_round=None) -> torch.Tensor:
        """The JAX store's capacity loop over a ``per_round`` backend: one
        backend call per ``request_capacity`` requests, ``each_round()``
        after each.  A ``host_windows`` backend gathers on the host and the
        batch is copied to the device once; any other gathers on the
        device."""
        m = int(gidx.shape[0])
        cap = self.request_capacity
        if self.backend.host_windows:
            g = _host(gidx)
            d = np.broadcast_to(_host(depth), (m,))
            win = np.zeros((m, self.k), np.int32)
            for lo in range(0, m, cap):
                win[lo : lo + cap] = self.backend.gather_host(g[lo : lo + cap],
                                                              d[lo : lo + cap])
                if each_round is not None:
                    each_round()
            return torch.from_numpy(win).to(self.device)  # one copy
        d = self._depths(depth, m)
        parts = []
        for lo in range(0, m, cap):
            parts.append(self.backend.gather(gidx[lo : lo + cap], d[lo : lo + cap]))
            if each_round is not None:
                each_round()
        return torch.cat(parts)

    # -- batched fetch ------------------------------------------------------
    def fetch_windows(self, gidx, depth) -> torch.Tensor:
        """(m, K) int32 windows of suffixes ``gidx`` at window ``depth``.

        The JAX store serves ``request_capacity`` requests a round, one
        backend gather each; here all ``m`` are gathered at once and the
        counters grow exactly as that loop grows them.  Host ``gidx`` and
        ``depth`` stay on the host for a backend that gathers there.
        """
        gidx = torch.as_tensor(gidx, dtype=torch.int64)
        if not (self.backend.per_round and self.backend.host_windows):
            gidx = gidx.to(self.device)
        m = int(gidx.shape[0])
        if m == 0:
            out = torch.zeros((0, self.k), dtype=torch.int32, device=self.device)
        elif self.backend.per_round:
            # residency noted after every round, as the JAX store notes it
            out = self._round_windows(gidx, depth, each_round=self._note_resident)
            self._count_windows(m)
        else:
            out = self._gather(gidx, self._depths(depth, m))
            self._count_windows(m)
        self.peak_windows = max(self.peak_windows, m)
        return out

    def fetch_window_pair(self, a: torch.Tensor, b: torch.Tensor,
                          depth) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fetch_windows(a, depth), fetch_windows(b, depth)`` from one
        backend gather, counted as the two calls (the LCP's pair fetch)."""
        m = int(a.shape[0])
        if m == 0 or self.backend.per_round:
            return self.fetch_windows(a, depth), self.fetch_windows(b, depth)
        win = self._gather(torch.cat([a, b]), self._depths(depth, 2 * m))
        for _ in range(2):
            self._count_windows(m)
        self.peak_windows = max(self.peak_windows, m)
        return win[:m], win[m:]

    def _count_windows(self, m: int, rounds: Optional[int] = None) -> None:
        """The counters of one JAX fetch of ``m`` windows: a round per
        capacity chunk (``rounds``, when given, for fetches summed)."""
        self.rounds += -(-m // self.request_capacity) if rounds is None else rounds
        self.requests += m
        self.request_bytes += m * self.index_bytes
        self.response_bytes += m * self.k * self.token_bytes

    def note_searched(self, windows: int, rounds: int, peak: int) -> None:
        """The counters of the in-memory fetches that the ``pattern_search``
        kernel made on the device, as the search's round loop would have
        made them with :meth:`fetch_windows`: ``windows`` windows over
        ``rounds`` capacity rounds, the largest fetch ``peak`` windows, every
        one a backend cache hit."""
        self._count_windows(windows, rounds)
        self.peak_windows = max(self.peak_windows, peak)
        self.backend.cache_hits += windows
        self._note_resident()

    def gather_keys(self, gidx, depth) -> Tuple[torch.Tensor, torch.Tensor]:
        """The backend half of :meth:`fetch_keys`: windows at ``depth``
        packed to key words, no counter or residency touched.

        The worker-thread-safe fetch that the merge's refill prefetch
        submits to the pipeline executor; the collector accounts it on the
        main thread with :meth:`note_fetched`.  Returns ``(keys, ended)``:
        (m, key_words) int32 and (m,) bool, on the store's device.
        """
        gidx = torch.as_tensor(gidx, dtype=torch.int64, device=self.device)
        m = int(gidx.shape[0])
        if m == 0:
            return (torch.zeros((0, self.key_words), dtype=torch.int32,
                                device=self.device),
                    torch.zeros((0,), dtype=torch.bool, device=self.device))
        if self.backend.per_round:
            # the worker-thread path: no residency noted here (SAL010);
            # note_fetched accounts it on the main thread
            win = self._round_windows(gidx, depth)
        else:
            win = self.backend.gather(gidx, self._depths(depth, m))
        return pack_keys(win, self.cfg), (win == 0).any(dim=1)

    def note_fetched(self, m: int) -> None:
        """Main-thread accounting for ``m`` windows served by
        :meth:`gather_keys`: the totals, rounds and peak of the JAX store's
        capacity loop."""
        m = int(m)
        if m <= 0:
            return
        self._count_windows(m)
        self.peak_windows = max(self.peak_windows, m)
        self._note_resident()

    def fetch_keys(self, gidx, depth) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched packed-key fetch: :meth:`gather_keys` + :meth:`note_fetched`.

        ``keys`` are order-preserving words (:func:`pack_keys`); ``ended``
        is True where the window holds a ``0``: the suffix ends inside it
        and every deeper window is all-zero.
        """
        keys, ended = self.gather_keys(gidx, depth)
        self.note_fetched(keys.shape[0])
        return keys, ended

    def fetch_key(self, gidx: int, depth: int) -> Tuple[Tuple[int, ...], bool]:
        """One suffix's packed key words and end flag at ``depth``, on the
        host (``WindowCursor``'s miss): :meth:`fetch_keys` of one suffix,
        counted as that, from one backend call and one copy."""
        win = self.backend.window(int(gidx), int(depth)).tolist()
        self.note_fetched(1)
        return self.pack_host(win), 0 in win

    def rank_windows(self, keys: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
        """Output ranks of candidate rows under (key words..., global index).

        The plain version of the ``merge_path_ranks`` kernel in the merge:
        rank of a row = number of rows lexicographically smaller, ties
        broken by the global index.  ``np.lexsort`` of the JAX store is
        chained stable sorts here.  Returns (C,) int64.
        """
        order = lex_order([keys[:, w] for w in range(keys.shape[1])] + [gidx])
        ranks = torch.empty_like(order)
        ranks[order] = torch.arange(order.shape[0], device=order.device)
        return ranks

    def mget_window_host(self, gidx, depth, active, group):
        """One capacity-bounded service round over active tie groups.

        Serves whole groups, in order, until ``request_capacity`` requests
        are placed; a leading group larger than the capacity is served alone
        so rounds always progress.  Returns ``(windows, ok)``: unserved
        slots have ``ok == False`` and zero windows, and the caller must not
        advance a group with an unserved active member.  The name is the
        JAX store's; the round runs on the store's device.
        """
        m = gidx.shape[0]
        dev = self.device
        win = torch.zeros((m, self.k), dtype=torch.int32, device=dev)
        ok = torch.zeros((m,), dtype=torch.bool, device=dev)
        act = torch.nonzero(active).squeeze(1)
        self.rounds += 1
        n_act = int(act.shape[0])
        if n_act == 0:
            return win, ok
        ag = group[act]
        new_grp = torch.ones((n_act,), dtype=torch.bool, device=dev)
        new_grp[1:] = ag[1:] != ag[:-1]
        grp_id = torch.cumsum(new_grp, 0) - 1
        # request count through the end of each group
        end_count = torch.zeros((n_act,), dtype=torch.int64, device=dev)
        end_count.scatter_reduce_(
            0, grp_id, torch.arange(1, n_act + 1, device=dev), "amax")
        fits = end_count <= self.request_capacity
        fits[0] = True  # oversized leading group: serve alone
        served = act[fits[grp_id]]
        n_served = int(served.shape[0])
        win[served] = self._gather(gidx[served], depth[served])
        ok[served] = True
        self.requests += n_served
        self.request_bytes += n_served * self.index_bytes
        self.response_bytes += n_served * self.k * self.token_bytes
        self.retries += n_act - n_served
        self.peak_windows = max(self.peak_windows, n_served)
        return win, ok


def _host_entries(keys: torch.Tensor, ended: torch.Tensor) -> List[Tuple[Tuple[int, ...], bool]]:
    """``(key words, ended)`` cache entries of a fetched batch, copied to
    the host in one copy."""
    rows = torch.cat([keys.to(torch.int64), ended[:, None].to(torch.int64)],
                     dim=1).cpu().tolist()
    return [(tuple(r[:-1]), bool(r[-1])) for r in rows]


class WindowCursor:
    """Per-suffix progressive packed-key cache over a :class:`CorpusStore`
    (``repro.core.store.WindowCursor``).

    The k-way merge compares run heads over and over: a partition probe
    compares a run member against a splitter, every heap sift two run
    heads.  The cursor fetches a window once per (suffix, K-token depth)
    and re-serves it for every later comparison, so store traffic is one
    depth-0 window per suffix plus deeper windows down to the actual
    tie-breaking depth.  Entries are the packed key words (as a tuple of
    ints) and the end-of-suffix flag, kept on the host, where the merge's
    heap compares them: a hit touches no device.  :meth:`prefetch` copies a
    batch of fetched keys to the host once; a miss in :meth:`key` or
    :meth:`less` is one singleton :meth:`CorpusStore.fetch_key` (one copy).
    The cursor counts ``cached_windows``/``peak_cached_windows`` and
    registers ``(key_words + 1) * 4`` bytes an entry with the store's
    frontier (``CorpusStore.add_frontier``); :meth:`release` drops a
    suffix's entries as the merge emits it, :meth:`release_all` every
    entry (the streaming merge's reset between phases).
    """

    def __init__(self, store: CorpusStore):
        self.store = store
        self._win: dict = {}  # gidx -> [(key words, ended) at depth 0, 1, ...]
        # one cached entry: key_words packed lanes + the ended flag lane
        self.window_bytes = (store.key_words + 1) * 4
        self.cached_windows = 0
        self.peak_cached_windows = 0
        self._max_depth = store.max_window_depth

    def _account(self, delta: int) -> None:
        self.cached_windows += delta
        if delta > 0:
            self.peak_cached_windows = max(self.peak_cached_windows,
                                           self.cached_windows)
        self.store.add_frontier(delta * self.window_bytes)

    def prefetch(self, gidx) -> None:
        """Batch-fetch depth-0 windows for every uncached suffix in ``gidx``
        (a host array): one capacity-chunked store fetch, one copy."""
        miss = [g for g in np.asarray(gidx, np.int64).tolist() if g not in self._win]
        if not miss:
            return
        keys, ended = self.store.fetch_keys(
            torch.tensor(miss, dtype=torch.int64, device=self.store.device), 0)
        for g, entry in zip(miss, _host_entries(keys, ended), strict=True):
            self._win[g] = [entry]
        self._account(len(miss))

    def _entry(self, gidx: int, depth: int) -> Tuple[Tuple[int, ...], bool]:
        ws = self._win.get(gidx)
        if ws is None:
            ws = self._win[gidx] = []
        while len(ws) <= depth:
            ws.append(self.store.fetch_key(gidx, len(ws)))
            self._account(1)
        return ws[depth]

    def key(self, gidx: int, depth: int) -> Tuple[np.ndarray, bool]:
        """``(key words, ended)`` of ``gidx`` at ``depth`` (cached; fetched
        on a miss, with every shallower depth missing)."""
        words, ended = self._entry(int(gidx), int(depth))
        return np.array(words, np.int32), ended

    def _offer(self, gidx: int, depth: int, entry) -> bool:
        ws = self._win.get(gidx)
        if ws is None:
            if depth != 0:
                return False
            self._win[gidx] = [entry]
        elif len(ws) == depth:
            ws.append(entry)
        else:
            return False
        return True

    def offer(self, gidx: int, depth: int, window) -> None:
        """Warm the cache with an externally fetched raw (K,) window (no
        store round; packed on the way in, an owned copy).  Depths must
        arrive consecutively per suffix; an offer that would leave a gap,
        or repeat a depth, is ignored."""
        w = np.asarray(window).astype(np.int32).tolist()
        if self._offer(int(gidx), int(depth), (self.store.pack_host(w), 0 in w)):
            self._account(1)

    def offer_windows(self, gidx: torch.Tensor, depth, windows: torch.Tensor) -> None:
        """:meth:`offer` of a batch of distinct suffixes whose (m, K)
        windows lie on the store's device: packed there and copied to the
        host once.  ``depth`` is an int or an (m,) tensor."""
        m = int(gidx.shape[0])
        if m == 0:
            return
        depth = torch.as_tensor(depth, dtype=torch.int64, device=gidx.device).expand(m)
        rows = torch.cat([gidx[:, None], depth[:, None],
                          pack_keys(windows, self.store.cfg).to(torch.int64),
                          (windows == 0).any(dim=1)[:, None].to(torch.int64)],
                         dim=1).cpu().tolist()
        taken = sum(self._offer(r[0], r[1], (tuple(r[2:-1]), bool(r[-1])))
                    for r in rows)
        if taken:
            self._account(taken)

    def release(self, gidx: int) -> None:
        """Drop a suffix's cached keys (call when the merge emits it)."""
        ws = self._win.pop(gidx, None)
        if ws is not None:
            self._account(-len(ws))

    def release_all(self) -> None:
        """Drop every cached entry (the streaming merge's reset between
        phases: residency is reclaimed at the price of re-fetching)."""
        total = self.cached_windows
        self._win.clear()
        if total:
            self._account(-total)

    def less(self, a: int, b: int) -> bool:
        """Exact ``suffix(a) < suffix(b)``; equal contents tie by index.

        Progressive packed-key comparison (word order is token-window
        order), ``a``'s window fetched before ``b``'s at each depth as the
        JAX cursor fetches them; equal windows in which ``a`` ends mean
        equal suffixes, and the global index breaks the tie.
        """
        if a == b:
            return False
        win = self._win
        for d in range(self._max_depth):
            ws = win.get(a)
            wa, ended = ws[d] if ws is not None and len(ws) > d else self._entry(a, d)
            ws = win.get(b)
            wb, _ = ws[d] if ws is not None and len(ws) > d else self._entry(b, d)
            if wa != wb:
                return wa < wb
            if ended:
                return a < b
        raise RuntimeError("suffix comparison overran the window bound")


# ---------------------------------------------------------------------------
# Store-layer backend access helpers (the only sanctioned raw-read paths
# outside a CorpusStore; everything else is a salint SAL002 violation)
# ---------------------------------------------------------------------------


def stream_backend_items(backend: StoreBackend,
                         batch_items: int = 1 << 18) -> Iterator[np.ndarray]:
    """Yield the backend's items in order as host batches of at most
    ``batch_items`` items (``repro.core.store.stream_backend_items``), so a
    serialization never holds a corpus-sized host array."""
    batch_items = max(1, int(batch_items))
    for lo in range(0, backend.n, batch_items):
        yield backend.read_items(lo, min(lo + batch_items, backend.n))


def backend_fingerprint(backend: StoreBackend,
                        sample_items: int = 1024) -> dict:
    """Geometry + head-sample crc of a backend's corpus
    (``repro.core.store.backend_fingerprint``): a fingerprint, not an
    integrity check."""
    from repro_torch.core.integrity import crc32_array

    head = np.ascontiguousarray(
        backend.read_items(0, min(backend.n, int(sample_items))), np.int32)
    return {
        "items": int(backend.n),
        "row_len": int(backend.row_len),
        "text_mode": bool(backend.text_mode),
        "head_crc": crc32_array(head),
    }


def materialize_backend(backend: StoreBackend) -> np.ndarray:
    """Whole-corpus host array of a backend (``repro.core.store``'s escape
    hatch for paths that need the full corpus, such as an in-core build or
    the device refiner); bounded-residency paths stream instead."""
    if backend.n == 0:
        shape = (0,) if backend.text_mode else (0, backend.row_len)
        return np.zeros(shape, np.int32)
    return np.concatenate(list(stream_backend_items(backend)), axis=0)
