"""Runtime sanitizer: accounting-checking proxies for store and merge (the
port of ``repro.core.sanitize``).

On under ``REPRO_SANITIZE=1`` in the environment or
``SuperblockConfig.sanitize``; off by default.  Three checks:

* **accounting cross-check**: on every gather the backend's claimed
  ``resident_bytes`` is recomputed from the live cache allocations, and
  the LRU budget invariant (``resident <= cache_budget_bytes``) is
  asserted;
* **halo-window byte-exactness**: a sampled subset of every gather's
  windows is read again through the uncached item path (``read_items``
  reads straight from the corpus) and compared byte for byte.  Every
  gather route of the port's backends is checked: ``gather`` (tensors on
  the device), ``gather_host`` (a chunked backend's host windows) and
  ``window`` (``WindowCursor``'s singleton).  Only the sampled rows of a
  device result are copied to the host;
* **merge-order verification**: sampled adjacent pairs of every piece the
  merge emits (and the seams between pieces) are checked in suffix order,
  through a private audit :class:`CorpusStore`, so the build store's own
  traffic counters are untouched.

Violations raise :class:`SanitizeError` (an ``AssertionError``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core.store import CorpusStore, StoreBackend, _ProxyBackend


class SanitizeError(AssertionError):
    """A runtime invariant check failed under REPRO_SANITIZE."""


def sanitize_enabled(sb=None) -> bool:
    """True when the sanitizer is on: ``REPRO_SANITIZE`` set to anything but
    ``0`` or empty, or ``sb.sanitize`` on the given config."""
    if os.environ.get("REPRO_SANITIZE", "") not in ("", "0"):
        return True
    return bool(sb is not None and getattr(sb, "sanitize", False))


def unwrap_backend(backend: StoreBackend) -> StoreBackend:
    """The real backend behind any proxy layers (sanitizing, retrying,
    throttling, fault-injecting), each of which holds the wrapped backend
    as ``.inner``: what the build dispatches on for the backend's residency
    regime."""
    depth = 0
    while "inner" in getattr(backend, "__dict__", ()) and depth < 32:
        backend = backend.inner
        depth += 1
    return backend


def _sample_indices(m: int, sample: int) -> np.ndarray:
    """Up to ``sample`` indices spread evenly over ``range(m)``,
    deterministic, endpoints included (chunk edges are where halo bugs
    live)."""
    if m <= 0:
        return np.zeros(0, np.int64)
    return np.unique(np.linspace(0, m - 1, num=min(m, sample)).astype(np.int64))


class SanitizingBackend(_ProxyBackend):
    """Accounting-checking proxy around any :class:`StoreBackend`
    (``repro.core.sanitize.SanitizingBackend``).

    Geometry and counters are the wrapped backend's.  A ``per_round``
    proxy like the others, so the store calls it one capacity chunk a call,
    as the JAX store calls its backend: ``checks`` (one a gather call, on
    any route) and ``oracle_windows_checked`` are the JAX sanitizer's.
    """

    def __init__(self, inner: StoreBackend, sample: int = 4):
        super().__init__(inner)
        self.sample = max(1, int(sample))
        self.checks = 0
        self.oracle_windows_checked = 0
        self.observed_peak_bytes = 0

    def read_items(self, lo: int, hi: int) -> np.ndarray:
        before = self.inner.resident_bytes
        out = self.inner.read_items(lo, hi)
        if self.inner.resident_bytes != before:
            raise SanitizeError(
                "read_items changed backend residency "
                f"({before} -> {self.inner.resident_bytes} B): staging must "
                "bypass the window cache")
        return out

    def gather(self, gidx: torch.Tensor, depth) -> torch.Tensor:
        out = self.inner.gather(gidx, depth)
        m = int(gidx.shape[0])
        sel = _sample_indices(m, self.sample)
        # only the sampled rows come to the host
        idx = torch.from_numpy(sel).to(out.device)
        depth = torch.as_tensor(depth, dtype=torch.int64, device=out.device).expand(m)
        rows = torch.cat([gidx[idx].to(torch.int64)[:, None], depth[idx][:, None],
                          out[idx].to(torch.int64)], dim=1).cpu().numpy()
        self._check(rows[:, 0], rows[:, 1], rows[:, 2:].astype(np.int32))
        return out

    def gather_host(self, gidx: np.ndarray, depth) -> np.ndarray:
        out = self.inner.gather_host(gidx, depth)
        gidx = np.asarray(gidx, np.int64)
        depth = np.broadcast_to(np.asarray(depth, np.int64), gidx.shape)
        sel = _sample_indices(int(gidx.shape[0]), self.sample)
        self._check(gidx[sel], depth[sel], out[sel])
        return out

    def window(self, gidx: int, depth: int) -> np.ndarray:
        out = self.inner.window(gidx, depth)
        self._check(np.array([gidx], np.int64), np.array([depth], np.int64),
                    out[None, :])
        return out

    # -- checks -------------------------------------------------------------
    def _check(self, gidx: np.ndarray, depth: np.ndarray, got: np.ndarray) -> None:
        """One gather call's checks: the cache accounting, then the sampled
        windows ``got`` of suffixes ``gidx`` at ``depth`` against the
        uncached reads."""
        self.checks += 1
        self._check_cache_accounting()
        self.observed_peak_bytes = max(self.observed_peak_bytes,
                                       self.inner.resident_bytes)
        if gidx.size:
            oracle = self._oracle_windows(gidx, depth)
            if not np.array_equal(got, oracle):
                bad = int((got != oracle).any(axis=1).argmax())
                raise SanitizeError(
                    f"cached window for gidx={int(gidx[bad])} "
                    f"depth={int(depth[bad])} differs from the uncached "
                    f"oracle read (corrupted or mis-haloed cache chunk)")
            self.oracle_windows_checked += int(gidx.size)

    def _check_cache_accounting(self) -> None:
        inner = self.inner
        cache = getattr(inner, "_cache", None)
        if cache is None:
            return  # a backend with no cache to account for
        live = sum(int(c.nbytes) for c in cache.values())
        claimed = inner.resident_bytes
        if live != claimed:
            raise SanitizeError(
                f"backend accounting leak: resident_bytes claims {claimed} B "
                f"but live cache allocations sum to {live} B")
        budget = getattr(inner, "cache_budget_bytes", None)
        if budget is not None and live > budget:
            raise SanitizeError(
                f"LRU budget invariant broken: {live} B resident exceeds "
                f"cache_budget_bytes={budget} B after eviction")

    def _oracle_windows(self, gidx: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """Reference windows through the uncached item path: the geometry of
        ``StoreBackend.gather`` on the host."""
        inner = self.inner
        k = inner.k
        out = np.zeros((gidx.shape[0], k), np.int32)
        if inner.text_mode:
            pos = np.minimum(gidx + depth * k, inner.n)
            for i, p in enumerate(pos.tolist()):
                w = inner.read_items(int(p), int(p) + k)
                out[i, : w.shape[0]] = w
        else:
            mask = (1 << inner.stride_bits) - 1
            row = (gidx >> inner.stride_bits).astype(np.int64)
            off = np.minimum((gidx & mask) + depth * k, inner.max_len - 1)
            for i in range(gidx.shape[0]):
                r = inner.read_items(int(row[i]), int(row[i]) + 1)
                w = r.reshape(-1)[int(off[i]) : int(off[i]) + k]
                out[i, : w.shape[0]] = w
        return out


def _sampled(piece, idx: np.ndarray) -> np.ndarray:
    """``piece[idx]`` as a host int64 array: a tensor's selected entries are
    copied to the host, not the piece."""
    if isinstance(piece, torch.Tensor):
        return piece.reshape(-1)[torch.from_numpy(idx).to(piece.device)].cpu().numpy()
    return np.asarray(piece, np.int64).reshape(-1)[idx]


class SanitizingSink:
    """Order-verifying proxy around the merge's output sink
    (``repro.core.sanitize.SanitizingSink``).

    Checks sampled adjacent pairs of every appended piece, and the seam
    against the previous piece's last suffix, in true suffix order: packed
    key windows compared depth by depth, ties by global index.  Fetches go
    through a private audit :class:`CorpusStore` over the same backend
    (one singleton ``fetch_key`` a window, the JAX audit's one-suffix
    fetch), so the build store's request and byte counters are untouched.
    """

    def __init__(self, sink, backend: StoreBackend, cfg: SAConfig,
                 sample: int = 4, request_capacity: int = 4096):
        self._sink = sink
        self._audit = CorpusStore(None, cfg, backend=backend,
                                  request_capacity=request_capacity)
        self.sample = max(1, int(sample))
        self._prev_last: Optional[int] = None
        self.pairs_checked = 0

    def __getattr__(self, name: str):
        return getattr(self._sink, name)

    def append(self, piece) -> None:
        m = int(piece.shape[0])
        if m:
            left = _sample_indices(m - 1, self.sample)
            ends = np.array([0, m - 1], np.int64)
            vals = _sampled(piece, np.concatenate([ends, left, left + 1])).tolist()
            first, last = vals[0], vals[1]
            pairs = zip(vals[2 : 2 + left.size], vals[2 + left.size :])
            if self._prev_last is not None:
                self._check_pair(self._prev_last, first)
            for a, b in pairs:
                self._check_pair(a, b)
            self._prev_last = last
        self._sink.append(piece)

    def _check_pair(self, a: int, b: int) -> None:
        """Assert ``suffix(a) < suffix(b)`` (ties by index) or raise."""
        self.pairs_checked += 1
        if a == b:
            raise SanitizeError(f"merge emitted duplicate suffix {a}")
        store = self._audit
        for d in range(store.max_window_depth):
            ka, ea = store.fetch_key(a, d)
            kb, _ = store.fetch_key(b, d)
            if kb < ka:  # key words order as their windows do
                raise SanitizeError(
                    f"merge emitted out-of-order pair: suffix {b} sorts "
                    f"before its predecessor {a} (diverge at window depth "
                    f"{d})")
            if ka != kb:
                return  # a < b strictly at this depth
            if ea:
                # equal content and both suffixes ended: index breaks the tie
                if a > b:
                    raise SanitizeError(
                        f"merge emitted equal-content suffixes {a}, {b} in "
                        f"non-index order")
                return
        raise SanitizeError(
            f"suffix comparison of {a}, {b} overran the window depth bound")


def check_footprint(store: CorpusStore,
                    backend: Optional[StoreBackend] = None) -> None:
    """End-of-build cross-check of the store's Footprint accounting against
    independently recomputed backend state."""
    inner = unwrap_backend(backend if backend is not None else store.backend)
    cache = getattr(inner, "_cache", None)
    if cache is not None:
        live = sum(int(c.nbytes) for c in cache.values())
        if live != inner.resident_bytes:
            raise SanitizeError(
                f"backend accounting leak at build end: resident_bytes "
                f"claims {inner.resident_bytes} B, live cache holds {live} B")
        budget = getattr(inner, "cache_budget_bytes", None)
        if budget is not None and live > budget:
            raise SanitizeError(
                f"LRU budget invariant broken at build end: {live} B "
                f"resident exceeds cache_budget_bytes={budget} B")
    if store.frontier_bytes < 0:
        raise SanitizeError(
            f"negative merge frontier ({store.frontier_bytes} B): more "
            f"window bytes released than registered")
    store._note_resident()
    current = inner.resident_bytes + store.frontier_bytes
    if store.peak_resident_bytes < current:
        raise SanitizeError(
            f"peak_resident_bytes ({store.peak_resident_bytes} B) below "
            f"current residency ({current} B): peak tracking missed a fetch")
