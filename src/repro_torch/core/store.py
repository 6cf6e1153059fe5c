"""The in-memory data store at one shard: ``mgetsuffix`` (paper §IV, Redis).

The port of ``repro.core.store``, in two halves.

Device half.  The corpus stays resident on the card and requests carry
indexes only; ``mget_window`` routes a batch of (row, offset) requests to the
owner shard, gathers the K-token windows there (the ``window_gather`` kernel
under ``cfg.use_pallas``) and returns them, or the already-packed key words
under ``server_pack``.  ``serve_windows`` is what the pipeline calls: the same
service at one shard, but it gathers and packs only the served rows, a
bounded chunk at a time, so a round over 201 M suffixes never holds a window
per capacity slot.

Serving half (``StoreBackend``, ``InMemoryBackend``, ``CorpusStore``).  The
JAX package keeps these on the host; in the port the backend's padded corpus
is a tensor on its device, and ``CorpusStore.fetch_windows`` takes and
returns tensors there.  The query engine, the post-hoc LCP and the
single-block build go through it, with the JAX package's traffic counters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.distributed import bucket_scatter, exchange
from repro_torch.core.types import WORD_BITS
from repro_torch.device import resolve_device

# Most requests whose windows are gathered at once by serve_windows.
FETCH_CHUNK = 1 << 22


def index_request_bytes(num_items: int, stride_bits: int) -> int:
    """Modeled bytes of one suffix-index request: int31 words carried in
    int32 lanes, one while the address space fits 31 bits, two beyond
    (``repro.core.store.index_request_bytes``)."""
    bits = max(1, (max(num_items - 1, 1)).bit_length() + stride_bits)
    return 4 * -(-bits // WORD_BITS)


@dataclass(frozen=True)
class StoreSpec:
    """Static layout of the store (one shard in this slice)."""

    num_shards: int
    rows_per_shard: int  # reads mode: rows; text mode: tokens
    row_len: int  # L (reads) or 1 (text)
    request_capacity: int  # per-destination capacity

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
    """Batched window fetch ("mgetsuffix") at one shard.

    The contract of ``repro.core.store.mget_window``: requests are bucketed
    by owner with ``request_capacity`` slots per owner, the owner gathers a
    window for every slot, and responses are routed back by slot.
    Returns (win_or_words, exhausted, ok, stats): (M, K) windows or
    (M, key_words) packed words under ``cfg.server_pack``; ``exhausted`` is
    True where the window ran past the suffix end or the request was not
    served; ``ok`` is False for inactive requests and capacity drops.
    """
    k = window or cfg.prefix_len
    d, cap = spec.num_shards, spec.request_capacity
    if d != 1:
        raise NotImplementedError("mget_window across shards is ROADMAP.md item 10")

    owner = torch.where(active, torch.div(row_id, spec.rows_per_shard,
                                          rounding_mode="floor"), d)
    owner = owner.clamp(0, d).to(torch.int32)  # inactive -> dump bucket d
    reqs = torch.stack([torch.where(active, row_id, -1),
                        torch.where(active, offset, 0)], dim=1)
    buf, slot, _ = bucket_scatter(reqs, owner, d + 1, cap, fill=-1)
    dropped = torch.sum(active & (slot >= d * cap))

    recv = exchange(buf[:d])
    req_row = recv[..., 0].reshape(-1)
    req_off = recv[..., 1].reshape(-1).contiguous()
    local_row = torch.where(req_row >= 0, req_row, -1).contiguous()
    windows = _gather(local_rows, local_row, req_off, spec, cfg, k)
    exhausted_w = torch.any(windows == 0, dim=-1)
    payload = encoding.pack_words(windows, cfg) if cfg.server_pack else windows
    resp_width = payload.shape[1]
    payload = torch.cat([payload, exhausted_w[:, None].to(torch.int32)], dim=1)

    flatresp = exchange(payload.reshape(d, cap, resp_width + 1))
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
    """:func:`mget_window` at one shard, gathering only the served rows.

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
        raise NotImplementedError("mget_window across shards is ROADMAP.md item 10")
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


def pack_keys(windows: torch.Tensor, cfg: SAConfig) -> torch.Tensor:
    """(..., K) token windows -> (..., key_words) int32 key words.

    The tensor counterpart of ``repro.core.store.pack_keys_np``: the words
    are accumulated in int64 and cast to int32 at the end, so int64 windows
    give the same words as ``pack_keys_np`` (wrapping included).
    """
    w = windows.to(torch.int64)
    cpw = cfg.resolved_chars_per_word()
    assert w.shape[-1] == cpw * cfg.key_words, (tuple(w.shape), cpw * cfg.key_words)
    bits = max(1, int(cfg.vocab_size).bit_length())
    words = []
    for i in range(cfg.key_words):
        acc = torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)
        for j in range(i * cpw, (i + 1) * cpw):
            if cfg.packing == "base":
                acc = acc * (cfg.vocab_size + 1) + w[..., j]
            else:
                acc = (acc << bits) | w[..., j]
        if cfg.packing != "base":
            acc = acc << (31 - bits * cpw)
        words.append(acc.to(torch.int32))
    return torch.stack(words, dim=-1)


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

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n,) if self.text_mode else (self.n, self.row_len)

    @property
    def resident_bytes(self) -> int:
        raise NotImplementedError

    def gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """(m,) int64 global suffix ids -> (m, K) int32 windows at token
        offset ``depth * K`` into each suffix (0-padded past the end)."""
        raise NotImplementedError

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:  # optional hook, default no-op
        pass


class InMemoryBackend(StoreBackend):
    """Whole-corpus backend, resident on ``device`` (the card by default).

    The zero-padded corpus (``_flat`` in text mode, ``_rows`` for reads) is
    an int32 tensor there; the host array is kept for :meth:`read_items`.
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
        dev_corpus = torch.from_numpy(corpus).to(self.device)
        if text_mode:
            self._flat = torch.nn.functional.pad(dev_corpus, (0, self.k))
        else:
            self._rows = torch.nn.functional.pad(dev_corpus, (0, self.k))
        del dev_corpus

    @property
    def resident_bytes(self) -> int:
        t = self._flat if self.text_mode else self._rows
        return t.numel() * t.element_size()

    def gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        self.cache_hits += int(gidx.shape[0])  # always resident
        cols = torch.arange(self.k, device=self.device)
        if self.text_mode:
            pos = torch.clamp(gidx + depth * self.k, max=self.n)
            return self._flat[torch.clamp(pos[:, None] + cols[None, :],
                                          max=self.n + self.k - 1)]
        row = gidx >> self.stride_bits
        off = gidx & ((1 << self.stride_bits) - 1)
        off = torch.clamp(off + depth * self.k, max=self.max_len - 1)
        return self._rows[row[:, None], off[:, None] + cols[None, :]]

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        return self._corpus[lo:hi]


# ---------------------------------------------------------------------------
# The serving store
# ---------------------------------------------------------------------------


class CorpusStore:
    """Corpus window server (``repro.core.store.CorpusStore``).

    Windows are served from a :class:`StoreBackend` on its device; the store
    owns the traffic accounting of the JAX package: ``request_capacity``
    requests per service round, ``index_bytes`` per request (derived from
    the address space), ``K * token_bytes`` per raw-window response, and
    ``peak_resident_bytes`` of the backend.  The out-of-core merge's calls
    (``fetch_keys``, ``gather_keys``, ``rank_windows``, the retried
    ``mget_window_host`` and the frontier that ``WindowCursor`` registers)
    are ROADMAP.md item 9.
    """

    def __init__(self, corpus, cfg: SAConfig, request_capacity: int = 4096,
                 backend: Optional[StoreBackend] = None, device=None):
        if backend is None:
            backend = InMemoryBackend(corpus, cfg, device=device)
        self.backend = backend
        self.cfg = cfg
        self.text_mode = backend.text_mode
        self.n = backend.n
        self.stride_bits = backend.stride_bits
        self.max_len = backend.max_len
        self.k = cfg.prefix_len
        self.request_capacity = max(1, int(request_capacity))
        self.token_bytes = token_bytes(cfg.vocab_size)
        self.index_bytes = index_request_bytes(self.n, self.stride_bits)
        # fetch accounting
        self.requests = 0
        self.request_bytes = 0
        self.response_bytes = 0
        self.rounds = 0
        self.peak_windows = 0
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
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.backend.resident_bytes)

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

    # -- raw gather ---------------------------------------------------------
    def _gather(self, gidx: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        out = self.backend.gather(gidx, depth)
        self._note_resident()
        return out

    # -- batched fetch ------------------------------------------------------
    def fetch_windows(self, gidx, depth) -> torch.Tensor:
        """(m, K) int32 windows of suffixes ``gidx`` at window ``depth``.

        The JAX store serves ``request_capacity`` requests a round, one
        backend gather each; here all ``m`` are gathered at once and the
        counters grow exactly as that loop grows them.
        """
        gidx = torch.as_tensor(gidx, dtype=torch.int64, device=self.device)
        m = int(gidx.shape[0])
        depth = torch.as_tensor(depth, dtype=torch.int64,
                                device=self.device).expand(m)
        if m == 0:
            out = torch.zeros((0, self.k), dtype=torch.int32, device=self.device)
        else:
            out = self._gather(gidx, depth)
            self.rounds += -(-m // self.request_capacity)
            self.requests += m
            self.request_bytes += m * self.index_bytes
            self.response_bytes += m * self.k * self.token_bytes
        self.peak_windows = max(self.peak_windows, m)
        return out


def materialize_backend(backend: StoreBackend) -> np.ndarray:
    """Whole-corpus host array of a backend (``repro.core.store``'s escape
    hatch for paths that need the full corpus, such as an in-core build)."""
    return backend.read_items(0, backend.n)
