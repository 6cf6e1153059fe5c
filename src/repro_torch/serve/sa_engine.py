"""Sharded suffix-array query engine and the build → query facade.

The port of ``repro.serve.sa_engine``.  :class:`ShardedSAEngine` answers
batched count/locate/align over (store, sa[, lcp]) exactly as the JAX
engine does, with the same counters: the SA split into contiguous shards at
splitter suffixes, one batched Manber–Myers binary search for all queries of
a batch, LLCP/RLCP bounds from the LCP array, a byte-budgeted result cache.

Its state lives on the store's device: ``sa``, ``lcp``, LLCP/RLCP and every
per-round vector (``lo``, ``hi``, ``l``, ``r``, ``t``, ``undecided``) are
tensors there, and patterns are padded into one ``(q, lmax)`` int64 tensor.
Under ``use_pallas`` over an in-memory backend a bound is one launch of the
hand-written ``pattern_search`` kernel, which runs every round of every row
on the card (its plain version, the round loop, for CPU tensors); the
counters are rebuilt from its record of window levels.  Otherwise each
round compares all live rows a window level at a time: one fetch and one
``pattern_cmp_level`` launch a level under ``use_pallas`` (a chunked
backend, whose cache counters follow its calls, and the routing to shards),
:func:`repro_torch.core.search.compare_level` without.  The public types stay
the JAX package's: numpy counts and positions, tuple lists.

:class:`SuffixArrayIndex` builds with the post-hoc LCP array on the card by
default, saves and opens the index directories of
``repro_torch.core.index_io`` (byte-compatible with ``repro``'s), and
builds straight into one with ``build(index_dir=...)``.  A reopened index
puts SA, LCP and LLCP/RLCP on the card as a freshly built one does; its
corpus stays on disk behind the chunked backend's cache, or on the card
with ``store_backend="memory"``.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core.search import bound_rounds, compare_level, compare_levels
from repro_torch.core.store import (
    ChunkedFileBackend,
    CorpusStore,
    InMemoryBackend,
    StoreBackend,
)
from repro_torch.device import resolve_device

__all__ = ["ShardedSAEngine", "SuffixArrayIndex"]


# ---------------------------------------------------------------------------
# hot-pattern result cache
# ---------------------------------------------------------------------------


class _ResultCache:
    """Byte-budgeted LRU of pattern bytes -> (lo, hi)."""

    _ENTRY_OVERHEAD = 64  # dict slot + the two ints, approximately

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._d: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def _cost(self, key: bytes) -> int:
        return len(key) + self._ENTRY_OVERHEAD

    def get(self, key: bytes) -> Optional[Tuple[int, int]]:
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key: bytes, val: Tuple[int, int]) -> None:
        if self.budget <= 0 or self._cost(key) > self.budget:
            return
        if key in self._d:
            self._d.move_to_end(key)
            self._d[key] = val
            return
        while self._d and self._bytes + self._cost(key) > self.budget:
            old, _ = self._d.popitem(last=False)
            self._bytes -= self._cost(old)
        self._d[key] = val
        self._bytes += self._cost(key)

    @property
    def resident_bytes(self) -> int:
        return self._bytes


def _as_batch(patterns) -> Tuple[List[np.ndarray], bool]:
    """Normalize to (list of 1-D int64 patterns, was_single_pattern)."""
    if isinstance(patterns, np.ndarray):
        if patterns.ndim == 2:
            return [np.asarray(r, np.int64) for r in patterns], False
        return [np.asarray(patterns, np.int64).ravel()], True
    seq = list(patterns)
    if seq and isinstance(seq[0], (int, np.integer)):
        return [np.asarray(seq, np.int64)], True
    return [np.asarray(p, np.int64).ravel() for p in seq], False


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# entries of a host array copied to the device at once
_COPY_CHUNK = 1 << 26


def _on_device(arr, device) -> torch.Tensor:
    """An int64 copy of ``arr`` on ``device``.  A host array (a reopened
    index's read-only memmap included) is copied in slices of
    ``_COPY_CHUNK`` entries, so no second host copy of a 1.6 GB SA is
    made."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.int64)
    arr = np.asarray(arr)
    out = torch.empty(arr.shape, dtype=torch.int64, device=device)
    for lo in range(0, arr.shape[0], _COPY_CHUNK):
        part = np.array(arr[lo : lo + _COPY_CHUNK], dtype=np.int64)
        out[lo : lo + part.shape[0]] = torch.from_numpy(part)
    return out



class ShardedSAEngine:
    """Batched queries over (store, sa[, lcp]) on the store's device."""

    def __init__(
        self,
        store: CorpusStore,
        sa,
        lcp=None,
        num_shards: int = 0,
        cache_budget_bytes: int = 1 << 20,
        use_pallas: Optional[bool] = None,
        block: int = 256,
    ):
        self.store = store
        dev = self.device = store.device
        self.sa = _on_device(sa, dev)
        self.lcp = None if lcp is None else _on_device(lcp, dev)
        n = self.sa.shape[0]
        if num_shards <= 0:
            # the JAX engine's local device count
            num_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
        self.num_shards = max(1, min(int(num_shards), max(n, 1)))
        s = self.num_shards
        self.bounds = np.array([i * n // s for i in range(s + 1)], np.int64)
        # the most rounds a bound takes: ceil(log2(largest shard + 1))
        self._max_rounds = int(np.diff(self.bounds).max(initial=0)).bit_length() + 1
        self._bounds = torch.from_numpy(self.bounds).to(dev)
        # splitters: the first suffix of every shard but the first
        self.splitters = self.sa[self._bounds[1:-1]]
        self.use_pallas = (store.cfg.use_pallas if use_pallas is None
                           else bool(use_pallas))
        self.block = int(block)
        self.cache = _ResultCache(cache_budget_bytes)
        self._llcp: Optional[torch.Tensor] = None
        self._rlcp: Optional[torch.Tensor] = None
        self.stats: Dict[str, int] = {
            "queries": 0, "search_rounds": 0, "compare_rounds": 0,
        }
        if self.lcp is not None and n:
            self._build_llcp()

    # -- LLCP/RLCP precompute ------------------------------------------------
    def _build_llcp(self) -> None:
        """Per-shard LLCP/RLCP over the canonical binary-search tree.

        The JAX engine fills them by a recursion with one Python call per
        position.  Here the tree is walked level by level: top-down to list
        each level's nodes ``(lo, hi)`` (every position of a shard is the
        mid of exactly one node), then bottom-up, where a node's value is
        ``min(lcp[lo+1 .. hi])`` (0 when it touches a shard's sentinel) and
        is the min of its two children's.  ``llcp[mid]`` and ``rlcp[mid]``
        are the values of the node's left and right child: about 2·log2(n)
        tensor passes and no Python call per node.
        """
        n = self.sa.shape[0]
        dev = self.device
        lcpadj = self.lcp
        bounds = self._bounds
        llcp = torch.zeros(n, dtype=torch.int64, device=dev)
        rlcp = torch.zeros(n, dtype=torch.int64, device=dev)
        val = torch.zeros(n, dtype=torch.int64, device=dev)  # node value by mid
        lo, hi = bounds[:-1] - 1, bounds[1:]  # every shard holds a position
        levels = []
        while True:
            internal = hi - lo >= 2
            lo, hi = lo[internal], hi[internal]
            if lo.numel() == 0:
                break
            levels.append((lo, hi))
            mid = (lo + hi) >> 1
            lo, hi = torch.cat([lo, mid]), torch.cat([mid, hi])

        def child(clo, chi, left, right):
            sentinel = (clo < left) | (chi >= right)
            leaf = lcpadj[chi.clamp(max=n - 1)]
            inner = val[(clo + chi) >> 1]
            return torch.where(sentinel, 0, torch.where(chi - clo == 1, leaf, inner))

        for lo, hi in reversed(levels):
            mid = (lo + hi) >> 1
            shard = torch.searchsorted(bounds, mid, right=True) - 1
            left, right = bounds[shard], bounds[shard + 1]
            a = child(lo, mid, left, right)
            b = child(mid, hi, left, right)
            llcp[mid], rlcp[mid] = a, b
            val[mid] = torch.where((lo < left) | (hi >= right), 0,
                                   torch.minimum(a, b))
        self._llcp, self._rlcp = llcp, rlcp

    # -- batched compares ----------------------------------------------------
    def _compare_level(self, *args) -> None:
        """One window level over the rows in play (``compare_level``'s
        contract): one ``pattern_cmp_level`` launch (its plain version for
        CPU tensors), or its tensor mirror."""
        self.stats["compare_rounds"] += 1
        if self.use_pallas:
            from repro_torch.kernels import ops as kops

            kops.pattern_cmp_level(*args, block=self.block)
        else:
            compare_level(*args)

    def _compare_batch(
        self,
        gidx: torch.Tensor,
        pat_rows: torch.Tensor,
        pat_len: torch.Tensor,
        t0: torch.Tensor,
        pi: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Trichotomy of suffix(gidx[i]) vs pattern ``pi[i]``, starting from
        ``t0[i]`` already-matched tokens (:func:`compare_levels` over the
        store's fetches).

        Returns ``(cmp, t)``: cmp in {-1, 0, +1} with 0 = the pattern is a
        prefix of the suffix, and t = matched tokens (capped at the pattern
        length).  One store fetch and one batched compare per window level
        still in play.
        """
        if pi is None:
            pi = torch.arange(gidx.shape[0], device=self.device)
        return compare_levels(self.store.fetch_windows, self._compare_level, gidx,
                              pat_rows, pat_len, t0, pi, self.store.k,
                              self.store.max_window_depth + 1)

    def _route(self, pat_rows: torch.Tensor, pat_len: torch.Tensor,
               upper: bool) -> torch.Tensor:
        """Target shard per query: one batched trichotomy against all
        splitters; prefix-count of splitters below the query's bound class."""
        s, q = self.num_shards, pat_len.shape[0]
        dev = self.device
        if s == 1:
            return torch.zeros(q, dtype=torch.int64, device=dev)
        g = self.splitters.repeat(q)
        pi = torch.arange(q, device=dev).repeat_interleave(s - 1)
        c, _ = self._compare_batch(
            g, pat_rows, pat_len, torch.zeros(g.shape[0], dtype=torch.int64,
                                              device=dev), pi=pi)
        c = c.reshape(q, s - 1)
        below = (c <= 0) if upper else (c < 0)  # prefix-match counts as <='
        return below.sum(dim=1)

    def _bound_batch(self, pat_rows: torch.Tensor, pat_len: torch.Tensor,
                     upper: bool) -> torch.Tensor:
        """Vectorized Manber–Myers bound for every query at once
        (``repro.serve.sa_engine.ShardedSAEngine._bound_batch``): under
        ``use_pallas`` over an in-memory backend one ``pattern_search`` call
        on the device, else the round loop (:func:`bound_rounds`), a batched
        compare a round."""
        shard = self._route(pat_rows, pat_len, upper)
        lo = self._bounds[shard] - 1
        hi = self._bounds[shard + 1].clone()
        if self.use_pallas and not self.store.backend.per_round:
            return self._search_on_device(pat_rows, pat_len, lo, hi, upper)
        hi, rounds = bound_rounds(
            self.sa, self._llcp, self._rlcp, lo, hi, upper,
            lambda g, t0, rows, _: self._compare_batch(g, pat_rows, pat_len, t0,
                                                       pi=rows))
        self.stats["search_rounds"] += rounds
        return hi

    def _search_on_device(self, pat_rows: torch.Tensor, pat_len: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor,
                          upper: bool) -> torch.Tensor:
        """One bound of every row in one ``pattern_search`` call (its plain
        version for CPU tensors), and the counters the round loop would have
        kept, rebuilt from the kernel's record with one reduction and one
        host read: ``levels[i, r]`` windows of row i in round r make, for
        each round r and level j, one fetch of ``m[r, j] = #{i : levels[i, r]
        > j}`` windows and one compare."""
        from repro_torch.kernels import ops as kops

        store = self.store
        bound, levels, active = kops.pattern_search(
            store.backend.padded, store.stride_bits, store.k, self.sa, self._llcp,
            self._rlcp, pat_rows, pat_len, lo, hi, upper, self._max_rounds,
            block=self.block)
        # levels sorted down each round: column r's entry t*cap is the levels
        # (j) whose fetch m[r, j] takes more than t capacity rounds
        top = torch.sort(levels, dim=0, descending=True).values.to(torch.int64)
        rounds, compares, windows, peak, fetch_rounds = torch.stack([
            active.max().to(torch.int64), top[0].sum(), top.sum(),
            (levels > 0).sum(dim=0).max(),
            top[:: store.request_capacity].sum()]).tolist()
        if rounds > self._max_rounds:
            raise RuntimeError(f"pattern_search: {rounds} rounds over the bound "
                               f"{self._max_rounds}")
        self.stats["search_rounds"] += rounds
        self.stats["compare_rounds"] += compares
        store.note_searched(windows, fetch_rounds, peak)
        return bound

    # -- public batched queries ---------------------------------------------
    def ranges(self, patterns: Sequence) -> np.ndarray:
        """(q, 2) int64 ``[lo, hi)`` SA ranges, cache-served when hot."""
        pats = [np.asarray(p, np.int64).ravel() for p in patterns]
        q = len(pats)
        out = np.zeros((q, 2), np.int64)
        self.stats["queries"] += q
        keys = [p.tobytes() for p in pats]
        miss: "OrderedDict[bytes, List[int]]" = OrderedDict()
        for i, key in enumerate(keys):
            hit = self.cache.get(key)
            if hit is None:
                miss.setdefault(key, []).append(i)
            else:
                out[i] = hit
        if miss:
            res = self._search([pats[g[0]] for g in miss.values()])
            for (key, g), row in zip(miss.items(), res, strict=True):
                out[g] = row
                self.cache.put(key, (int(row[0]), int(row[1])))
        return out

    def _search(self, pats: List[np.ndarray]) -> np.ndarray:
        n = self.sa.shape[0]
        u = len(pats)
        out = np.zeros((u, 2), np.int64)
        # tokens < 1 collide with the end-of-suffix padding: such patterns
        # can never occur in a corpus of real (>= 1) tokens
        live = [i for i, p in enumerate(pats) if p.size == 0 or p.min() >= 1]
        if not live or n == 0:
            return out
        lmax = max(1, max(pats[i].size for i in live))
        rows = np.zeros((len(live), lmax), np.int64)
        plen = np.zeros(len(live), np.int64)
        for j, i in enumerate(live):
            rows[j, : pats[i].size] = pats[i]
            plen[j] = pats[i].size
        rows_t = torch.from_numpy(rows).to(self.device)
        plen_t = torch.from_numpy(plen).to(self.device)
        lo = self._bound_batch(rows_t, plen_t, upper=False)
        hi = self._bound_batch(rows_t, plen_t, upper=True)
        out[live, 0] = lo.cpu().numpy()
        out[live, 1] = hi.cpu().numpy()
        return out

    def count(self, patterns: Sequence) -> np.ndarray:
        rg = self.ranges(patterns)
        return rg[:, 1] - rg[:, 0]

    def locate(self, patterns: Sequence) -> List[np.ndarray]:
        """Per pattern: ascending global indexes of every occurrence
        (text positions, or packed ``row << stride | off`` for reads), read
        back from the card in one copy."""
        rg = self.ranges(patterns)
        if not len(rg):
            return []
        occ = torch.cat([self.sa[lo:hi] for lo, hi in rg]).cpu().numpy()
        return [np.sort(part)
                for part in np.split(occ, np.cumsum(rg[:, 1] - rg[:, 0])[:-1])]

    def align(self, patterns: Sequence) -> List[List[Tuple[int, int]]]:
        """Per pattern: sorted (read_id, offset) pairs (reads mode only)."""
        if self.store.text_mode:
            raise ValueError("align() needs a reads-mode index; "
                             "use locate() for text corpora")
        sb = self.store.stride_bits
        mask = (1 << sb) - 1
        return [
            [(int(g >> sb), int(g & mask)) for g in occ]
            for occ in self.locate(patterns)
        ]

    def engine_stats(self) -> Dict[str, Any]:
        return {
            **self.stats,
            "num_shards": self.num_shards,
            "lcp_accelerated": self._llcp is not None,
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_resident_bytes": self.cache.resident_bytes,
            "store_requests": self.store.requests,
            "store_response_bytes": self.store.response_bytes,
        }


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

class SuffixArrayIndex:
    """Build → query over one index (``repro.serve.sa_engine.SuffixArrayIndex``).

    Examples::

        idx = SuffixArrayIndex.build(reads, cfg=SAConfig(vocab_size=4))
        idx.count(pattern)                  # one pattern -> int
        idx.align([p1, p2, p3])             # batch -> list of match lists
        idx.save("/data/my_index")

        idx = SuffixArrayIndex.open("/data/my_index")   # no rebuild
        idx.locate(pattern)

    Queries accept one pattern (a 1-D sequence of ints) or a batch (list of
    sequences / 2-D array) and return unbatched / batched results
    correspondingly.  ``sa`` and ``lcp`` are host arrays as in the JAX
    package (memmaps of a reopened index); the engine keeps its copies on
    the store's device.  ``build(index_dir=...)`` persists during the build.
    """

    def __init__(
        self,
        store: CorpusStore,
        sa,
        lcp=None,
        index_dir: Optional[str] = None,
        stats: Optional[Dict[str, Any]] = None,
        num_shards: int = 0,
        result_cache_bytes: int = 1 << 20,
        use_pallas: Optional[bool] = None,
    ):
        self.store = store
        self.cfg = store.cfg
        self.sa = sa
        self.lcp = lcp
        self.index_dir = index_dir
        self.build_stats = stats or {}
        self._engine_kw = dict(
            num_shards=num_shards, cache_budget_bytes=result_cache_bytes,
            use_pallas=use_pallas,
        )
        self._engine: Optional[ShardedSAEngine] = None

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def build(
        cls,
        corpus,
        lengths=None,
        cfg: Optional[SAConfig] = None,
        sb: Optional[SuperblockConfig] = None,
        index_dir: Optional[str] = None,
        emit_lcp: bool = True,
        device=None,
        group=None,
        **engine_kw,
    ) -> "SuffixArrayIndex":
        """Build (``build_suffix_array_auto``) and wrap for querying.

        ``corpus`` is an array, a chunked corpus file path or a store
        backend.  ``device`` places the corpus, the build and the engine:
        the card by default (raises without CUDA), ``"cpu"`` for the plain
        path.  As in the JAX package the build's store serves the LCP and is
        discarded, and a fresh store serves the queries.  ``index_dir``
        persists the index during the build (it doubles as the superblock
        ``spill_dir``, so streamed output lands there directly); the
        returned index serves from that directory.

        ``group``: the process group to build on (``None``: the initialized
        world, one rank without one).  Every rank builds collectively and
        gets an index of its own that answers alone.  With ``index_dir``
        rank 0 writes the directory and every rank opens it once the build
        has returned (it ends on a barrier).
        """
        from repro_torch.core.superblock import build_suffix_array_auto

        cfg = cfg or SAConfig()
        sb = sb or SuperblockConfig()
        if index_dir is not None:
            sb = dataclasses.replace(sb, spill_dir=index_dir, write_manifest=True,
                                     emit_lcp=emit_lcp or sb.emit_lcp)
        elif emit_lcp and not sb.emit_lcp:
            sb = dataclasses.replace(sb, emit_lcp=True)
        if isinstance(corpus, StoreBackend):
            device = corpus.device
        device = resolve_device(device)
        res = build_suffix_array_auto(corpus, lengths=lengths, cfg=cfg, sb=sb,
                                      device=device, group=group)
        if index_dir is not None:
            idx = cls.open(
                index_dir,
                store_backend=("memory" if sb.store_backend == "memory"
                               else "chunked"),
                cache_budget_bytes=sb.cache_budget_bytes, device=device,
                **engine_kw,
            )
            idx.build_stats = res.stats
            return idx
        store = CorpusStore(None, cfg,
                            backend=_serving_backend(corpus, cfg, sb, device),
                            request_capacity=sb.request_capacity)
        return cls(store, res.suffix_array, lcp=res.lcp, stats=res.stats,
                   **engine_kw)

    @classmethod
    def open(
        cls,
        index_dir: str,
        store_backend: str = "chunked",
        cache_budget_bytes: int = 0,
        request_capacity: int = 4096,
        verify: str = "lazy",
        device=None,
        **engine_kw,
    ) -> "SuffixArrayIndex":
        """Serve a previously built index directory, ``repro``'s or the
        port's, with no rebuild.

        ``store_backend="chunked"`` (default) keeps the corpus on disk
        behind the budgeted LRU chunk cache; ``"memory"`` puts it on
        ``device``.  ``verify`` sets the integrity posture (``"eager"`` /
        ``"lazy"`` / ``"off"``, see
        :func:`repro_torch.core.index_io.open_index`); failures raise
        :class:`repro_torch.core.integrity.CorruptionError` naming the
        artifact.  The engine's SA, LCP and LLCP/RLCP go to ``device``.
        """
        from repro_torch.core import index_io

        device = resolve_device(device)
        backend, sa, lcp, manifest = index_io.open_index(
            index_dir, store_backend=store_backend,
            cache_budget_bytes=cache_budget_bytes, verify=verify, device=device,
        )
        store = CorpusStore(None, SAConfig(**manifest["sa_config"]),
                            backend=backend, request_capacity=request_capacity)
        return cls(store, sa, lcp=lcp, index_dir=index_dir,
                   stats=manifest.get("stats"), **engine_kw)

    def save(self, index_dir: str) -> str:
        """Write the persistent layout; returns the manifest path.  The
        corpus is serialized into the directory unless this index already
        serves from a persistent chunked file (then the manifest points at
        it)."""
        from repro_torch.core import index_io

        corpus_ref = getattr(self.store.backend, "path", None)
        if corpus_ref is not None:
            corpus_ref = os.path.abspath(corpus_ref)
        mpath = index_io.save_index(
            index_dir, self.cfg, self.store.backend, self.sa, self.lcp,
            stats=self.build_stats, corpus_ref=corpus_ref,
        )
        self.index_dir = index_dir
        return mpath

    def close(self) -> None:
        self.store.backend.close()

    def __enter__(self) -> "SuffixArrayIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- queries -------------------------------------------------------------
    @property
    def engine(self) -> ShardedSAEngine:
        if self._engine is None:
            self._engine = ShardedSAEngine(
                self.store, self.sa, lcp=self.lcp, **self._engine_kw)
        return self._engine

    def count(self, patterns):
        """Occurrences per pattern: int for one pattern, (q,) for a batch."""
        pats, single = _as_batch(patterns)
        c = self.engine.count(pats)
        return int(c[0]) if single else c

    def locate(self, patterns):
        """Sorted occurrence positions (global indexes) per pattern."""
        pats, single = _as_batch(patterns)
        occ = self.engine.locate(pats)
        return occ[0] if single else occ

    def align(self, patterns):
        """Sorted (read_id, offset) matches per pattern (reads mode)."""
        pats, single = _as_batch(patterns)
        hits = self.engine.align(pats)
        return hits[0] if single else hits

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "backend": type(self.store.backend).__name__,
            "suffixes": int(np.shape(self.sa)[0]),
            "has_lcp": self.lcp is not None,
            "index_dir": self.index_dir,
        }
        if self._engine is not None:
            out.update(self._engine.engine_stats())
        return out


def _serving_backend(corpus, cfg: SAConfig, sb: SuperblockConfig,
                     device) -> StoreBackend:
    """Backend for querying a freshly built, non-persisted index: the
    caller's backend, a chunked one over a corpus file, or a new in-memory
    one over the array on ``device``; wrapped in the sanitizer when it is
    on (``repro.serve.sa_engine._serving_backend``)."""
    from repro_torch.core.sanitize import SanitizingBackend, sanitize_enabled

    if isinstance(corpus, StoreBackend):
        backend = corpus
    elif isinstance(corpus, (str, os.PathLike)):
        backend = ChunkedFileBackend(os.fspath(corpus), cfg,
                                     cache_budget_bytes=max(sb.cache_budget_bytes, 0),
                                     device=device)
    else:
        backend = InMemoryBackend(np.asarray(corpus, np.int32), cfg, device=device)
    if sanitize_enabled(sb) and not isinstance(backend, SanitizingBackend):
        backend = SanitizingBackend(backend)
    return backend
