"""Out-of-core suffix-array construction via superblocks.

The port of ``repro.core.superblock``: the single-pass build when one run
holds every record, and otherwise the paper's scale path in three phases.

1. **Partition**: the corpus is split into S contiguous superblocks whose
   record sets each fit one run (:func:`plan_superblocks`).
2. **Local SAs**: every superblock runs the in-core build
   (``core/pipeline.py``) on the store's device.  With ``pipeline_depth >=
   1`` the next block is staged on a background worker meanwhile.  Reads
   mode: block SAs are exact.  Text mode: they are exact away from the
   block tail.
3. **Merge via the store**.  Text-mode block tails (the risk set) are
   re-ranked exactly against the store and join the merge as runs of their
   own.  ``merge_algorithm="merge_path"`` (the default): every run's next ``tile``
   heads are fetched in one batched store call and packed to key words,
   tie groups deeper than the fetched window are escalated together (one
   batched fetch per depth, or one :class:`DeviceRefiner` call under
   ``merge_backend="device"``), and every candidate's output rank comes
   from one ``merge_path_ranks`` launch (the hand-written CUDA kernel under
   ``cfg.use_pallas``, ``CorpusStore.rank_windows`` otherwise).  Everything
   ranked below the merge-path safety horizon is emitted, with its LCP
   under ``emit_lcp``.  The tile state lives on the store's device; a round
   reads one scalar per escalation level and one for the horizon.
   ``"kway"``: splitter ranks located in every run by binary search, and
   buckets merged through a heap of run heads on the host, every compare
   served by a :class:`WindowCursor` (host keys, a singleton store fetch
   a miss).  ``"rerank"``: every suffix re-ranked from scratch in pieces
   of the record bound (``_sorted_runs``); under ``merge_backend="device"``
   the :class:`DeviceRefiner` ranks them.

Streaming (``store_backend="chunked"``, a corpus file path, or any backend
but the in-memory one): the corpus stays on disk behind the chunked
backend's LRU cache (half of ``cache_budget_bytes``), each block stages
only its own items, block SAs spill to disk and the merge reads its tiles
from those spills, with the tile width sized by the read-ahead share of
the budget (the k-way merge's read-ahead and splitter pool by
:class:`_MergeFrontier`), so ``peak_resident_bytes`` (cache plus frontier)
stays under the budget.  ``spill_dir`` receives ``suffix_array.npy``/``lcp.npy`` as
memmaps, and ``write_manifest`` finalizes it as an index directory
(``repro_torch.core.index_io``).

The output equals the JAX package's: the suffix array, the LCP array, every
``Footprint`` field and every ``stats`` key but the wall times ``t_*_s``
(the host seconds of the spans ``sb.stage``, ``sb.block`` and ``sb.merge``,
:mod:`repro_torch.core.spans`, summed over the build), and the files of a ``spill_dir`` byte for byte.  ``store_retries > 0``
wraps the backend in a :class:`RetryingBackend`, and the sanitizer
(``sanitize`` or ``REPRO_SANITIZE``) wraps it, and the merge's sink, in its
checking proxies (``repro_torch.core.sanitize``).

Crash safety (``resume`` with a ``spill_dir``): every block's run is spilled
to a stable scratch directory under ``spill_dir``, on every backend, and
journaled (``repro_torch.core.journal``) once its write is observed done; a
re-entered build adopts every verified block run with its stats and
footprint contributions and redoes the merge.  The journal is the JAX
package's format, so a build killed under either package resumes in the
other.
"""
from __future__ import annotations

import contextlib
import heapq
import math
import os
import shutil
import tempfile
import uuid
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core.distributed import (
    SINGLE,
    Ranks,
    barrier,
    broadcast_object,
    lex_order,
    run_starts,
    world,
)
from repro_torch.core.integrity import CorruptionError, crc32_array, publish_file
from repro_torch.core.journal import JOURNAL_NAME, BuildJournal, verify_spilled_run
from repro_torch.core.lcp import lcp_from_sa, pairwise_lcp
from repro_torch.core.pipeline import DeviceRefiner, _tied, build_suffix_array
from repro_torch.core.pipeline_exec import PipelineExecutor, pipeline_point
from repro_torch.core.sanitize import (
    SanitizingBackend,
    SanitizingSink,
    check_footprint,
    sanitize_enabled,
    unwrap_backend,
)
from repro_torch.core.spans import span
from repro_torch.core.store import (
    DEFAULT_CACHE_BUDGET,
    ChunkedFileBackend,
    CorpusStore,
    InMemoryBackend,
    RetryingBackend,
    StoreBackend,
    WindowCursor,
    backend_fingerprint,
    materialize_backend,
)
from repro_torch.device import resolve_device
from repro_torch.core.types import WORD_BITS, WORD_MOD, Footprint, SAResult

# LCP pairs compared at once on the card (the default of ``lcp_from_sa`` on
# the CPU); the single-block build's LCP store is discarded, so the batch
# changes no reported number
CUDA_LCP_BATCH = 1 << 22


@dataclass(frozen=True)
class SuperblockPlan:
    """Static partition of a corpus into superblocks."""

    text_mode: bool
    total_records: int
    num_superblocks: int
    capacity_records: int  # record bound for any single run / merge bucket
    blocks: Tuple[Tuple[int, int], ...]  # [lo, hi) token / row ranges
    stride_bits: int


def plan_superblocks(corpus_shape, cfg: SAConfig, sb: SuperblockConfig) -> SuperblockPlan:
    """Derive the superblock split from the capacity knobs
    (``repro.core.superblock.plan_superblocks``, warnings included).

    ``num_superblocks`` wins if set; otherwise ``max_records_per_run``
    gives the smallest S whose blocks fit; both unset give S = 1.  A block
    is at least one item, so a budget below one read's ``L + 1`` records
    warns, and ``capacity_records`` is what bounds ``peak_records``.
    """
    text_mode = len(corpus_shape) == 1
    if text_mode:
        items, per_item = corpus_shape[0], 1
        stride_bits = 0
    else:
        r, l = corpus_shape
        items, per_item = r, l + 1
        stride_bits = int(math.ceil(math.log2(l + 1)))
    total = items * per_item
    if sb.num_superblocks > 0:
        s = sb.num_superblocks
    elif sb.max_records_per_run > 0:
        items_fit = sb.max_records_per_run // per_item
        s = -(-items // items_fit) if items_fit >= 1 else items
    else:
        s = 1
    s = max(1, min(s, items))
    per_block = -(-items // s)
    blocks = tuple((lo, min(lo + per_block, items))
                   for lo in range(0, items, per_block))
    if 0 < sb.max_records_per_run < per_block * per_item:
        if sb.num_superblocks > 0:
            warnings.warn(
                f"max_records_per_run={sb.max_records_per_run} ignored: "
                f"explicit num_superblocks={sb.num_superblocks} yields "
                f"{per_block * per_item} records per block, over the budget",
                stacklevel=2,
            )
        else:
            warnings.warn(
                f"max_records_per_run={sb.max_records_per_run} is below the "
                f"granularity floor ({per_block * per_item} records per "
                "block); peak per-run records will exceed the requested "
                "budget",
                stacklevel=2,
            )
    return SuperblockPlan(
        text_mode=text_mode,
        total_records=total,
        num_superblocks=len(blocks),
        capacity_records=per_block * per_item,
        blocks=blocks,
        stride_bits=stride_bits,
    )


def corpus_shape_of(corpus) -> Tuple[int, ...]:
    """Corpus shape without materializing it: an array's own shape, a
    :class:`StoreBackend`'s geometry, a chunked corpus file's header."""
    if isinstance(corpus, StoreBackend):
        return corpus.shape
    if isinstance(corpus, (str, os.PathLike)):
        from repro_torch.data.chunk_store import read_chunked_corpus_meta

        meta = read_chunked_corpus_meta(os.fspath(corpus))
        return (meta.items,) if meta.text_mode else (meta.items, meta.row_len)
    return np.shape(corpus)


def _to_device(run, device) -> torch.Tensor:
    """A run (a tensor, a host array, or a spilled run's memmap, of which
    this reads a copy) as an int64 tensor on ``device``."""
    if isinstance(run, torch.Tensor):
        return run.to(device)
    if type(run) is np.ndarray and run.flags.writeable:  # not a spill's view
        return torch.from_numpy(np.ascontiguousarray(run, np.int64)).to(device)
    return torch.from_numpy(np.array(run, dtype=np.int64)).to(device)


def _to_host(run) -> np.ndarray:
    """A run as a host int64 array, where the k-way merge's heap walks it
    (a spilled run's memmap as it is: its pages load as the heap reads)."""
    if isinstance(run, torch.Tensor):
        return run.cpu().numpy()
    return run


class _Scratch:
    """Private scratch directory for one streaming or journaled build
    (serialized corpus, per-block SA spills); removed when the build
    finishes, but for a failed journaled build, whose runs are what the
    next attempt resumes from (``repro.core.superblock._Scratch``).

    ``stable_dir`` (a journaled build's ``spill_dir/scratch``) is used as it
    is, so a resumed attempt finds the previous attempt's runs; spill names
    carry a tag of their own instance, so attempts never collide.

    With an ``executor`` attached (``SuperblockConfig.pipeline_depth >= 1``)
    the spill *write* runs on the background worker: the memmap is created
    at once (so the caller keeps its disk-backed handle) but its pages are
    filled and flushed behind the next block's build.  Callers must
    :meth:`drain_spills` before the first read of any spilled run.
    """

    def __init__(self, parent: Optional[str],
                 executor: Optional[PipelineExecutor] = None,
                 stable_dir: Optional[str] = None):
        if stable_dir is not None:
            os.makedirs(stable_dir, exist_ok=True)
            self.dir = stable_dir
        else:
            self.dir = tempfile.mkdtemp(prefix="sa_superblock_", dir=parent)
        self._n = 0
        self._tag = uuid.uuid4().hex[:8]
        self.spilled_runs = 0
        self.spilled_bytes = 0
        self.executor = executor
        self._pending: List = []
        # (path, write task or None) of the last spill: the journal appends
        # the run's record once that write is observed done
        self.last_spill: Optional[Tuple[str, object]] = None
        self.journal: Optional[BuildJournal] = None  # closed by the wrapper

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    @staticmethod
    def _fill(out: np.ndarray, arr: np.ndarray) -> None:
        out[:] = arr
        out.flush()

    def spill_run(self, arr) -> np.ndarray:
        """Spill a sorted run (a host array, or a tensor copied to the host)
        to disk and hand back its memmap: only the pages the merge touches
        come resident."""
        p = self.path(f"run_{self._tag}_{self._n}.npy")
        self._n += 1
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        arr = np.ascontiguousarray(arr)
        self.spilled_runs += 1
        self.spilled_bytes += int(arr.size) * arr.dtype.itemsize
        if self.executor is not None:
            out = np.lib.format.open_memmap(
                p, mode="w+", dtype=arr.dtype, shape=arr.shape)
            task = self.executor.submit(self._fill, out, arr)
            self._pending.append(task)
            self.last_spill = (p, task)
            return out
        np.save(p, arr)
        self.last_spill = (p, None)
        return np.load(p, mmap_mode="r")

    @staticmethod
    def map_run(path: str) -> np.ndarray:
        """A read-only memmap of a run that rank 0 spilled and verified (a
        resumed build's adopted block on the other ranks)."""
        return np.load(path, mmap_mode="r")

    def drain_spills(self) -> None:
        """Wait for in-flight spill writes (re-raises a worker failure)."""
        pipeline_point("spill:drain")
        pending, self._pending = self._pending, []
        for task in pending:
            task.result()

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def _resolve_backend(corpus, cfg: SAConfig, sb: SuperblockConfig,
                     scratch: Optional[_Scratch], device,
                     ranks: Ranks = SINGLE) -> StoreBackend:
    """The store backend the whole construction streams through
    (``repro.core.superblock._resolve_backend``).

    * array + ``store_backend="memory"`` -> :class:`InMemoryBackend` on
      ``device``;
    * array + ``store_backend="chunked"`` -> the array is serialized once
      to the chunked format in ``scratch`` (in ``spill_dir`` itself when
      ``write_manifest`` is set: the index must outlive the scratch) and
      served from a :class:`ChunkedFileBackend`;
    * path -> :class:`ChunkedFileBackend` over the existing file;
    * a :class:`StoreBackend` passes through.

    The chunked backend's LRU gets **half** of ``cache_budget_bytes``; the
    other half covers the merge frontier, so ``peak_resident_bytes``
    (cache + frontier) stays under the budget as a whole.  At D ranks each
    rank opens a backend of its own at the full budget; rank 0 alone writes
    the copy in ``spill_dir``, and the other ranks open it after a barrier
    (a copy in scratch is each rank's own).
    """
    if isinstance(corpus, StoreBackend):
        return corpus
    budget = (sb.cache_budget_bytes if sb.cache_budget_bytes > 0
              else DEFAULT_CACHE_BUDGET)
    if isinstance(corpus, (str, os.PathLike)):
        return ChunkedFileBackend(os.fspath(corpus), cfg,
                                  cache_budget_bytes=budget // 2, device=device)
    if sb.store_backend == "memory":
        return InMemoryBackend(np.asarray(corpus, np.int32), cfg, device=device)
    if sb.store_backend != "chunked":
        raise ValueError(f"unknown store_backend: {sb.store_backend!r}")
    from repro_torch.data.chunk_store import chunk_items_for_budget, write_chunked_corpus

    corpus = np.asarray(corpus, np.int32)
    items = corpus.shape[0]
    row_len = 1 if corpus.ndim == 1 else corpus.shape[1]
    chunk_items = sb.chunk_records
    if chunk_items <= 0:
        # several chunks must fit the LRU half-budget or caching degenerates
        chunk_items = chunk_items_for_budget(items, row_len, budget)
    assert scratch is not None
    if sb.write_manifest and sb.spill_dir:
        path = os.path.join(sb.spill_dir, "corpus.sachunk")
        if ranks.rank == 0:
            write_chunked_corpus(corpus, path, chunk_items=chunk_items)
        barrier(ranks)
    else:
        path = scratch.path("corpus.sachunk")
        write_chunked_corpus(corpus, path, chunk_items=chunk_items)
    return ChunkedFileBackend(path, cfg, cache_budget_bytes=budget // 2,
                              device=device)


@dataclass
class _MergeFrontier:
    """Streaming merge policy (``repro.core.superblock._MergeFrontier``):
    bound the merge's resident frontier.

    ``readahead_bytes`` is split across the live runs of a merge: a k-way
    bucket merge keeps at most :meth:`per_run` depth-0 windows prefetched
    ahead of each run head, the merge-path tiles :meth:`per_run_keys` rows.
    ``drop_after_partition`` releases every cached cursor window once a
    bucket partition is located (probe windows are fetched again by the
    bucket merges that need them), and ``max_pool_windows`` bounds the
    splitter pool, whose windows stay cached through the partition (a
    smaller pool only coarsens the splitters).
    """

    readahead_bytes: int
    window_bytes: int
    drop_after_partition: bool = True
    max_pool_windows: int = 64

    def per_run(self, num_runs: int) -> int:
        return max(2, self.readahead_bytes // (max(1, num_runs) * self.window_bytes))

    def per_run_keys(self, num_runs: int, key_words: int,
                     buffers: int = 2) -> int:
        """Merge-path tile width under the read-ahead budget: tile buffers
        hold packed key rows, two levels of key words plus the flag lanes
        an element; the pipelined merge passes ``buffers=3`` for its
        pending refill rows."""
        est = buffers * (key_words + 1) * 4
        return max(2, self.readahead_bytes // (max(1, num_runs) * est))


# ---------------------------------------------------------------------------
# exact suffix comparisons against the resident store
# ---------------------------------------------------------------------------


def _rows_equal_prev(rows: torch.Tensor) -> torch.Tensor:
    """eq[i] = (row i == row i-1), eq[0] = False."""
    eq = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    eq[1:] = (rows[1:] == rows[:-1]).all(dim=1)
    return eq


def _refine_sort(store: CorpusStore, gidx: torch.Tensor,
                 cursor: Optional[WindowCursor] = None) -> torch.Tensor:
    """Rank ``gidx`` by exact suffix order with batched store fetches
    (``repro.core.superblock._refine_sort``).

    Sort by the first K-token window, then refine still-tied groups one
    window at a time; zero-padding orders shorter suffixes first and the
    global index is the last key.  A tie group advances a window only when
    every active member was served (``mget_window_host``'s capacity rule).
    ``cursor``: a :class:`WindowCursor` offered every fetched window, so
    the k-way merge that follows serves them from its cache.
    """
    m = gidx.shape[0]
    if m <= 1:
        return gidx
    k = store.k
    dev = gidx.device
    win = store.fetch_windows(gidx, 0)
    if cursor is not None:
        cursor.offer_windows(gidx, 0, win)
    order = lex_order([win[:, j] for j in range(k)] + [gidx])
    gidx, win = gidx[order], win[order]
    g = run_starts(_rows_equal_prev(win))
    exhausted = (win == 0).any(dim=1)
    depth = torch.ones(m, dtype=torch.int64, device=dev)
    # runaway guard only: every round serves at least the leading tie group
    hard_cap = m * (-(-store.max_len // k) + 2) + 8
    for _ in range(hard_cap):
        active = _tied(g) & ~exhausted
        if not bool(active.any()):
            break
        win, ok = store.mget_window_host(gidx, depth, active, g)
        if cursor is not None:
            got = active & ok
            cursor.offer_windows(gidx[got], depth[got], win[got])
        # group-synchronous advance (mirrors the device while-loop body)
        member_ok = torch.where(active, ok, True).to(torch.int32)
        starts = torch.ones(m, dtype=torch.bool, device=dev)
        starts[1:] = g[1:] != g[:-1]
        seg = torch.cumsum(starts, 0) - 1
        seg_ok = torch.ones(m, dtype=torch.int32, device=dev).scatter_reduce(
            0, seg, member_ok, "amin")
        adv = (seg_ok[seg] > 0) & active
        nk = torch.where(adv[:, None], win, 0)
        exhausted = torch.where(adv, (win == 0).any(dim=1), exhausted)
        depth = torch.where(adv, depth + 1, depth)
        order = lex_order([g] + [nk[:, j] for j in range(k)] + [gidx])
        g, nk = g[order], nk[order]
        gidx, exhausted, depth = gidx[order], exhausted[order], depth[order]
        eq = _rows_equal_prev(nk)
        eq[1:] &= g[1:] == g[:-1]
        g = run_starts(eq)
    else:
        raise RuntimeError("superblock merge refinement did not converge")
    return gidx


def _less_than(store: CorpusStore, gidx: torch.Tensor, pivot: int) -> torch.Tensor:
    """Exact ``suffix(gidx) < suffix(pivot)`` for a batch, ties by index.

    Progressive window comparison over capacity chunks; the pivot's window
    at each depth is fetched once and cached across chunks, as the JAX
    package does, so the request counts do not depend on the chunking; so
    is whether the pivot ends in it, read from the device once.
    """
    dev = gidx.device
    out = torch.zeros(gidx.shape[0], dtype=torch.bool, device=dev)
    cap = store.request_capacity
    cache = {}  # depth -> (pivot window, pivot ends in it), shared by every chunk
    for clo in range(0, gidx.shape[0], cap):
        chunk = gidx[clo : clo + cap]
        res = torch.zeros(chunk.shape[0], dtype=torch.bool, device=dev)
        sel = torch.arange(chunk.shape[0], device=dev)  # the undecided members
        depth = 0
        while sel.shape[0]:
            hit = cache.get(depth)
            if hit is None:
                wp = store.fetch_windows([pivot], depth)[0]
                hit = cache[depth] = (wp, bool((wp == 0).any()))
            wp, pivot_ended = hit
            cand = chunk[sel]
            ws = store.fetch_windows(cand, depth)
            neq = ws != wp[None, :]
            anyneq = neq.any(dim=1)
            first = neq.to(torch.uint8).argmax(dim=1)
            less = ws[torch.arange(sel.shape[0], device=dev), first] < wp[first]
            # equal windows in which the pivot ends: both suffixes ended, the
            # contents are equal and the index breaks the tie; a member still
            # undecided is written again at a deeper window
            res[sel] = torch.where(anyneq, less, cand < pivot)
            sel = sel[:0] if pivot_ended else sel[~anyneq]
            depth += 1
            assert depth <= store.max_len // store.k + 2, "comparison overran"
        out[clo : clo + cap] = res
    return out


def _partition(store: CorpusStore, gidx: torch.Tensor,
               splitters: torch.Tensor) -> List[torch.Tensor]:
    """Split ``gidx`` into true-order intervals at the splitter suffixes."""
    bucket = torch.zeros(gidx.shape[0], dtype=torch.int64, device=gidx.device)
    for pivot in splitters:
        bucket += ~_less_than(store, gidx, int(pivot))
    return [gidx[bucket == b] for b in range(splitters.shape[0] + 1)]


def _sorted_runs(
    store: CorpusStore,
    gidx: torch.Tensor,
    cap: int,
    samples_per_split: int,
    refine: Callable[[torch.Tensor], torch.Tensor],
) -> List[torch.Tensor]:
    """Fully sort an interval of the true order, in pieces of <= cap
    records: splitters are member suffixes at sample quantiles, so every
    part shrinks.  ``refine`` ranks a <= cap batch exactly."""
    n = gidx.shape[0]
    if n <= cap:
        return [refine(gidx)]
    nb = -(-n // cap) + 1
    take = min(n, cap, max(nb * samples_per_split, nb))
    pos = (torch.arange(take, dtype=torch.int64, device=gidx.device) * n) // take
    sample = refine(gidx[pos])
    picks = [(i * sample.shape[0]) // nb for i in range(1, nb)]
    splitters = sample[torch.tensor(picks, device=gidx.device)]
    out: List[torch.Tensor] = []
    for part in _partition(store, gidx, torch.unique(splitters)):
        out.extend(_sorted_runs(store, part, cap, samples_per_split, refine))
    return out


# ---------------------------------------------------------------------------
# k-way merge of sorted block runs, on the host
# ---------------------------------------------------------------------------


def _rank_in_run(cur: WindowCursor, run: np.ndarray, splitter: int,
                 drop_probes: bool = False) -> int:
    """Number of ``run`` members with suffix < splitter, by binary search:
    O(log n) exact comparisons through the cursor.  ``drop_probes``
    (streaming) releases each probed member's windows as the search leaves
    it, so only the splitter's stay cached across runs."""
    lo, hi = 0, run.size
    while lo < hi:
        mid = (lo + hi) // 2
        g = int(run[mid])
        if cur.less(g, splitter):
            lo = mid + 1
        else:
            hi = mid
        if drop_probes and g != splitter:
            cur.release(g)
    return lo


def _partition_runs(cur: WindowCursor, runs: List[np.ndarray], splitters: np.ndarray,
                    drop_probes: bool = False) -> List[List[np.ndarray]]:
    """Cut every sorted run at the splitter ranks: ``buckets[b]`` holds the
    per-run segments of merge bucket ``b``, and every member of bucket
    ``b`` precedes every member of bucket ``b + 1`` (splitters ascend)."""
    nb = splitters.size + 1
    buckets: List[List[np.ndarray]] = [[] for _ in range(nb)]
    for run in runs:
        cuts = [0]
        for s in splitters:
            cuts.append(max(_rank_in_run(cur, run, int(s), drop_probes), cuts[-1]))
        cuts.append(run.size)
        for b in range(nb):
            seg = run[cuts[b] : cuts[b + 1]]
            if seg.size:
                buckets[b].append(seg)
    return buckets


class _Head:
    """Heap entry of the k-way merge: one run and its position, ordered by
    the exact suffix order of the head member.  ``readahead`` > 0 keeps only
    the next ``readahead`` members' depth-0 windows prefetched (refilled as
    the head advances); 0 means the caller prefetched the whole run."""

    __slots__ = ("cur", "run", "pos", "readahead", "pref_end")

    def __init__(self, cur: WindowCursor, run: np.ndarray, readahead: int = 0):
        self.cur = cur
        self.run = run
        self.pos = 0
        self.readahead = readahead
        self.pref_end = 0
        self.ensure_prefetch()

    def ensure_prefetch(self) -> None:
        if self.readahead and self.pos >= self.pref_end:
            self.pref_end = min(self.pos + self.readahead, self.run.size)
            self.cur.prefetch(np.asarray(self.run[self.pos : self.pref_end], np.int64))

    @property
    def gidx(self) -> int:
        return int(self.run[self.pos])

    def __lt__(self, other: "_Head") -> bool:
        return self.cur.less(self.gidx, other.gidx)


def _kway_merge(cur: WindowCursor, runs: List[np.ndarray], release: bool = True,
                frontier: Optional[_MergeFrontier] = None) -> np.ndarray:
    """Merge exactly-sorted host runs with a heap of run heads
    (``repro.core.superblock._kway_merge``).

    Without a ``frontier`` every member's depth-0 window is prefetched in
    one batched fetch; with one, each run keeps a bounded read-ahead.
    Emitted suffixes release their windows unless ``release`` is off (a
    splitter pool, probed again by the partition right after).
    """
    runs = [r for r in runs if r.size]
    if not runs:
        return np.zeros((0,), np.int64)
    if len(runs) == 1:
        return runs[0]
    total = sum(r.size for r in runs)
    if frontier is None:
        cur.prefetch(np.concatenate(runs))
        heap = [_Head(cur, r) for r in runs]
    else:
        per_run = frontier.per_run(len(runs))
        heap = [_Head(cur, r, readahead=per_run) for r in runs]
    heapq.heapify(heap)
    out = np.empty(total, np.int64)
    i = 0
    while heap:
        h = heapq.heappop(heap)
        g = h.gidx
        out[i] = g
        i += 1
        if release:
            cur.release(g)
        h.pos += 1
        if h.pos < h.run.size:
            h.ensure_prefetch()
            heapq.heappush(heap, h)
    return out


def _merge_runs(
    cur: WindowCursor,
    runs: List[np.ndarray],
    cap: int,
    samples_per_split: int,
    rank_pool: Callable[[List[np.ndarray]], np.ndarray],
    frontier: Optional[_MergeFrontier] = None,
) -> List[np.ndarray]:
    """Merge exactly-sorted host runs into <= cap pieces of the true order
    (``repro.core.superblock._merge_runs``).

    A bucket that fits the record bound is k-way merged; a larger one
    recurses: splitters are members at per-run quantiles, ranked by
    ``rank_pool`` (the pick subsequences, each sorted as its run is) and
    located in every run by binary search.  The index tiebreak makes the
    order strict, so every split sheds a member on each side.  A
    ``frontier`` (streaming) bounds what stays cached: read-ahead bucket
    merges, a bounded pool, and the cursor dropped once a partition is
    located.
    """
    runs = [r for r in runs if r.size]
    total = sum(r.size for r in runs)
    if total == 0:
        return []
    if total <= cap:
        return [_kway_merge(cur, runs, frontier=frontier)]
    nb = -(-total // cap) + 1
    take = min(total, cap, max(nb * samples_per_split, nb))
    if frontier is not None:
        # pool windows stay cached through the partition: bound them
        take = min(take, max(nb, frontier.max_pool_windows))
    pos = (np.arange(take, dtype=np.int64) * total) // take
    # evenly spaced picks over the concatenated runs are per-run quantiles;
    # regrouped per run, each pick subsequence is itself a sorted run
    bounds = np.cumsum([0, *(r.size for r in runs)])
    pool_runs = []
    for ri, run in enumerate(runs):
        sel = pos[(pos >= bounds[ri]) & (pos < bounds[ri + 1])] - bounds[ri]
        if sel.size:
            pool_runs.append(run[sel])
    pool = rank_pool(pool_runs)
    picks = pool[[(i * pool.size) // nb for i in range(1, nb)]]
    buckets = _partition_runs(cur, runs, picks, drop_probes=frontier is not None)
    if frontier is not None and frontier.drop_after_partition:
        cur.release_all()  # probe and pool windows are fetched again on demand
    out: List[np.ndarray] = []
    for segs in buckets:
        if sum(s.size for s in segs) >= total:
            raise RuntimeError("superblock k-way partition made no progress")
        out.extend(_merge_runs(cur, segs, cap, samples_per_split, rank_pool,
                               frontier=frontier))
    return out


# ---------------------------------------------------------------------------
# merge-path: batched tile merge on the store's device
# ---------------------------------------------------------------------------


class _OutputSink:
    """Final-order SA emitter (``repro.core.superblock._OutputSink``).

    Pieces arrive in true suffix order and are written sequentially: into a
    tensor on the store's device, or, with ``memmap_path``
    (``SuperblockConfig.spill_dir``), into a disk-backed ``.npy`` memmap
    written under a unique temporary name and published when complete (the
    returned suffix array is then that memmap).  With an executor the writes
    run on its worker, in submission order.  With ``pair_lcp``
    (``SuperblockConfig.emit_lcp``) the sink also emits the LCP array, to
    ``lcp_path`` when given: ``lcp[i]`` is one compare between consecutive
    emitted suffixes, across piece seams too, in batches of ``_LCP_BATCH``
    pairs, as the JAX sink batches them (the batching decides the store's
    round count).  A piece is a tensor or a host array (a spilled run).
    """

    _LCP_BATCH = 1 << 16

    def __init__(self, total: int, device, pair_lcp=None,
                 executor: Optional[PipelineExecutor] = None,
                 memmap_path: Optional[str] = None,
                 lcp_path: Optional[str] = None):
        self.total = int(total)
        self.device = device
        self.written = 0
        self.pieces = 0
        self.max_piece = 0
        self._exec = executor
        self._tasks: List = []
        self._finalized = False
        self.path = memmap_path
        self._out = self._open(memmap_path, "_tmp")
        self._pair_lcp = pair_lcp
        self.lcp_path = lcp_path if pair_lcp is not None else None
        self._last: Optional[torch.Tensor] = None  # last emitted gidx, (1,)
        self._lcp = (self._open(self.lcp_path, "_lcp_tmp")
                     if pair_lcp is not None else None)
        self.lcp: Optional[np.ndarray] = None  # host LCP, set by result()

    def _open(self, path: Optional[str], tmp_attr: str):
        """An int64 output of ``total`` entries: a device tensor, or a
        memmap under a unique temporary name beside ``path`` (reusing a
        ``spill_dir`` must never truncate a previous build's mapping)."""
        if path is None:
            return torch.empty(self.total, dtype=torch.int64, device=self.device)
        tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex}.tmp"
        setattr(self, tmp_attr, tmp)
        return np.lib.format.open_memmap(tmp, mode="w+", dtype=np.int64,
                                         shape=(self.total,))

    def _put(self, out, lo: int, vals) -> None:
        """``out[lo:lo+len(vals)] = vals`` across the host/device split."""
        hi = lo + vals.shape[0]
        if isinstance(out, torch.Tensor):
            out[lo:hi] = _to_device(vals, out.device)
        else:
            out[lo:hi] = vals.cpu().numpy() if isinstance(vals, torch.Tensor) else vals

    def append(self, piece) -> None:
        m = int(piece.shape[0])
        if m == 0:
            return
        pipeline_point("sink:append")
        if self._pair_lcp is not None:
            self._append_lcp(piece)
        if self.path is not None and isinstance(piece, torch.Tensor):
            piece = piece.cpu().numpy()  # read back here, written by the worker
        if self._exec is not None:
            self._tasks.append(self._exec.submit(self._put, self._out,
                                                 self.written, piece))
        else:
            self._put(self._out, self.written, piece)
        self.written += m
        self.pieces += 1
        self.max_piece = max(self.max_piece, m)

    def _append_lcp(self, p) -> None:
        m = int(p.shape[0])
        dev = self.device
        base = self.written
        start = 0
        if self._last is None:
            self._lcp[base] = 0  # lcp[0] has no left neighbour
            start = 1
        for lo in range(start, m, self._LCP_BATCH):
            hi = min(lo + self._LCP_BATCH, m)
            if lo > 0:
                seg = _to_device(p[lo - 1 : hi], dev)
                left, right = seg[:-1], seg[1:]
            else:
                right = _to_device(p[:hi], dev)
                left = torch.cat([self._last, right[:-1]])
            self._put(self._lcp, base + lo, self._pair_lcp(left, right))
        self._last = _to_device(p[m - 1 : m], dev)

    def _publish(self, attr: str, tmp: str, path: str) -> np.ndarray:
        """Flush the memmap held in ``attr``, drop the write mapping, move
        its file to ``path`` and map the published file."""
        getattr(self, attr).flush()
        setattr(self, attr, None)
        publish_file(tmp, path)
        return np.load(path, mmap_mode="r+")

    def result(self) -> np.ndarray:
        assert self.written == self.total, (self.written, self.total)
        self._drain()
        self._finalized = True
        if self.lcp_path is not None:
            self.lcp = self._publish("_lcp", self._lcp_tmp, self.lcp_path)
        elif self._lcp is not None:
            self.lcp = self._lcp.cpu().numpy()
        if self.path is not None:
            return self._publish("_out", self._tmp, self.path)
        return self._out.cpu().numpy()

    def _drain(self) -> None:
        """Wait for in-flight background writes (re-raises a write failure)."""
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            t.result()

    def abort(self) -> None:
        """Failure path: wait out in-flight writes, drop the write mappings
        and unlink the temporary files.  No-op after :meth:`result`."""
        if self._finalized:
            return
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            with contextlib.suppress(BaseException):
                t.result()
        if self.path is not None:
            self._out = None
            with contextlib.suppress(OSError):
                os.unlink(self._tmp)
        if self.lcp_path is not None:
            self._lcp = None
            with contextlib.suppress(OSError):
                os.unlink(self._lcp_tmp)


class _JournalingSink:
    """Tee around the output sink (``repro.core.superblock._JournalingSink``):
    every emitted piece appends a merge watermark record to the build
    journal, with a batched fsync (the merge is redone wholesale on resume,
    so the watermark is observability, not a unit of recovery).  Everything
    else is the wrapped sink's."""

    def __init__(self, inner, journal: BuildJournal):
        self.inner = inner
        self.journal = journal
        self._emitted = 0

    def append(self, piece) -> None:
        self.inner.append(piece)
        self._emitted += int(piece.shape[0])
        self.journal.append({"t": "emit", "rows": self._emitted}, durable=False)

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class _RunTile:
    """One sorted run's buffered frontier for the merge-path tile merge
    (``repro.core.superblock._RunTile``, its buffers on the run's device).

    Holds up to ``tile`` unconsumed run members with their packed key words
    (``width`` columns, ``levels * key_words`` of them as the escalation
    widens the tile), per-member fetched-level counts and end-of-suffix
    flags, plus the depth-0 keys prefetched for the next refill.  Columns
    past a member's fetched level are zeros.  ``nbytes`` counts the buffers
    as the JAX tile's numpy arrays count them (int32 words and levels,
    one-byte flags).  The run is a tensor, or the memmap of a spilled run
    (streaming), of which only the members a round reads are copied to the
    device.
    """

    __slots__ = ("run", "dev", "pos", "count", "width", "words", "levels",
                 "ended", "kw", "pend_keys", "pend_ended")

    def __init__(self, run, kw: int, dev: torch.device):
        self.run = run
        self.dev = dev
        self.kw = kw
        self.pos = 0  # consumed members
        self.count = 0  # buffered members
        self.width = kw
        self.words = torch.zeros((0, kw), dtype=torch.int32, device=dev)
        self.levels = torch.zeros((0,), dtype=torch.int32, device=dev)
        self.ended = torch.zeros((0,), dtype=torch.bool, device=dev)
        # prefetched depth-0 keys for run[pos+count : pos+count+pending]
        self.pend_keys = torch.zeros((0, kw), dtype=torch.int32, device=dev)
        self.pend_ended = torch.zeros((0,), dtype=torch.bool, device=dev)

    @property
    def pending(self) -> int:
        return int(self.pend_keys.shape[0])

    @property
    def remaining(self) -> int:
        return int(self.run.shape[0]) - self.pos

    @property
    def buffered(self) -> int:
        return self.count

    def _members(self, lo: int, hi: int) -> torch.Tensor:
        return _to_device(self.run[lo:hi], self.dev)

    @property
    def gidx(self) -> torch.Tensor:
        return self._members(self.pos, self.pos + self.count)

    def need(self, tile: int) -> torch.Tensor:
        """Run members to fetch so the buffer covers min(tile, remaining)
        (members already in the pending buffer excluded)."""
        want = min(tile, self.remaining) - self.count - self.pending
        lo = self.pos + self.count + self.pending
        return self._members(lo, lo + max(want, 0))

    def prefetch_need(self, tile: int) -> torch.Tensor:
        """Run members whose depth-0 keys the next refill could ask for:
        the next window starts at the invariant ``pos + count``."""
        cap = min(tile, self.remaining - self.count) - self.pending
        lo = self.pos + self.count + self.pending
        return self._members(lo, lo + max(cap, 0))

    def admit_pending(self, keys: torch.Tensor, ended: torch.Tensor) -> None:
        if keys.shape[0] == 0:
            return
        self.pend_keys = torch.cat([self.pend_keys, keys])
        self.pend_ended = torch.cat([self.pend_ended, ended])

    def admit(self, keys: torch.Tensor, ended: torch.Tensor, tile: int) -> None:
        """Refill: queue freshly fetched rows behind the pending buffer,
        then move the head of the pending buffer into the live tile."""
        self.admit_pending(keys, ended)
        take = min(min(tile, self.remaining) - self.count, self.pending)
        if take > 0:
            self.extend(self.pend_keys[:take], self.pend_ended[:take])
            self.pend_keys = self.pend_keys[take:]
            self.pend_ended = self.pend_ended[take:]

    def extend(self, keys: torch.Tensor, ended: torch.Tensor) -> None:
        m = keys.shape[0]
        rows = torch.zeros((m, self.width), dtype=torch.int32, device=keys.device)
        rows[:, : self.kw] = keys
        self.count += m
        self.words = torch.cat([self.words, rows])
        self.levels = torch.cat([self.levels, torch.ones(
            m, dtype=torch.int32, device=keys.device)])
        self.ended = torch.cat([self.ended, ended])

    def consume(self, count: int) -> None:
        self.pos += count
        self.count -= count
        self.words = self.words[count:]
        self.levels = self.levels[count:]
        self.ended = self.ended[count:]

    @property
    def nbytes(self) -> int:
        return (self.count * (self.width * 4 + 4 + 1)
                + self.pending * (self.kw * 4 + 1))


def _group_ids(prev: Optional[torch.Tensor],
               cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equality-group ids of rows under (previous group, cols...), numbered
    in the rows' lexicographic order, and each group's size."""
    rows = cols.to(torch.int64)
    if prev is not None:
        rows = torch.cat([prev[:, None], rows], dim=1)
    _, gid, sizes = torch.unique(rows, dim=0, return_inverse=True,
                                 return_counts=True)
    return gid, sizes


def _widen(words: torch.Tensor, width: int) -> torch.Tensor:
    """``words`` with zero columns appended up to ``width``."""
    if words.shape[1] >= width:
        return words
    grown = torch.zeros((words.shape[0], width), dtype=words.dtype,
                        device=words.device)
    grown[:, : words.shape[1]] = words
    return grown


def _merge_path_runs(
    store: CorpusStore,
    runs: List,
    sink: _OutputSink,
    cap: int,
    merge_tile: int,
    use_pallas: bool,
    refiner: Optional[DeviceRefiner] = None,
    frontier: Optional[_MergeFrontier] = None,
    executor: Optional[PipelineExecutor] = None,
) -> int:
    """Merge exactly-sorted runs by merge-path tiles; emit in final order
    (``repro.core.superblock._merge_path_runs``).  A streaming build's
    runs are spilled memmaps and its ``frontier`` sizes the tile.

    Per round: one batched depth-0 fetch refills every run's tile; tie
    groups deeper than the fetched words escalate together, one batched
    fetch per depth (or one :class:`DeviceRefiner` call); every candidate's
    rank comes from one ``merge_path_ranks`` launch (or the plain
    ``CorpusStore.rank_windows``); every candidate below the safety
    horizon, the least last-buffered rank of a partially buffered run, is
    emitted.  With an executor the next refill's depth-0 keys are gathered
    on its worker while the tile ranks, and accounted on this thread when
    collected, so the counters equal the synchronous path's.  The
    candidates' state stays on the store's device: a round reads one
    scalar per escalation level, the fetch sizes, and the horizon.

    Returns the peak candidate count (the merge's record footprint).
    """
    runs = [r for r in runs if r.shape[0]]
    if not runs:
        return 0
    if len(runs) == 1:
        sink.append(runs[0])
        return int(runs[0].shape[0])
    dev = store.device
    kw = store.key_words
    if merge_tile > 0:  # explicit knob wins, streaming or not
        tile = merge_tile
    elif frontier is not None:
        tile = frontier.per_run_keys(
            len(runs), kw, buffers=3 if executor is not None else 2)
    else:
        tile = 4096
    tile = max(2, min(tile, cap // max(1, len(runs))))
    tiles = [_RunTile(r, kw, dev) for r in runs]
    registered = 0  # frontier bytes currently registered with the store
    peak_candidates = 0
    max_levels = store.max_window_depth
    empty_k = torch.zeros((0, kw), dtype=torch.int32, device=dev)
    empty_e = torch.zeros((0,), dtype=torch.bool, device=dev)

    def _account() -> None:
        nonlocal registered
        cur = sum(t.nbytes for t in tiles)
        store.add_frontier(cur - registered)
        registered = cur

    def _split(keys, ended, sizes):
        off = 0
        for n in sizes:
            yield keys[off : off + n], ended[off : off + n]
            off += n

    while any(t.buffered or t.remaining for t in tiles):
        # ---- refill: one batched store round for every run's new heads ----
        pipeline_point("merge:refill")
        needs = [t.need(tile) for t in tiles]
        sizes = [int(n.shape[0]) for n in needs]
        if sum(sizes):
            fetched = _split(*store.fetch_keys(torch.cat(needs), 0), sizes)
        else:
            fetched = ((empty_k, empty_e) for _ in sizes)
        for t, (keys, ended) in zip(tiles, fetched, strict=True):
            t.admit(keys, ended, tile)
        _account()
        live = [t for t in tiles if t.buffered]
        bounds = np.cumsum([0, *(t.buffered for t in live)]).tolist()
        cand_gidx = torch.cat([t.gidx for t in live])
        c = bounds[-1]
        peak_candidates = max(peak_candidates, c)

        # ---- escalate ties: whole groups per round, batched fetches -------
        # The live tiles' buffers are concatenated once and written back
        # after the loop; tile widths follow the JAX tiles' widening.
        level = 1
        width = max(t.width for t in live) // kw
        cand_words = torch.cat([_widen(t.words, width * kw) for t in live])
        cand_levels = torch.cat([t.levels for t in live])
        cand_ended = torch.cat([t.ended for t in live])
        g = None
        tie_col = None
        while True:
            cand_words = _widen(cand_words, max(level, width) * kw)
            lo = (level - 1) * kw
            g, group_sizes = _group_ids(g, cand_words[:, lo : lo + kw])
            open_cnt = torch.zeros_like(group_sizes).index_add_(
                0, g, (~cand_ended).to(torch.int64))
            amb = (group_sizes[g] >= 2) & (open_cnt[g] > 0)
            if not bool(amb.any()):
                break
            if refiner is not None:
                # one device refinement resolves every tie group at once: a
                # member's position in the refined order is decisive within
                # its group and never consulted across groups
                members = torch.nonzero(amb).squeeze(1)
                order = refiner.refine(cand_gidx[members])
                so = torch.argsort(order)
                tie_col = torch.zeros(c, dtype=torch.int32, device=dev)
                tie_col[members] = so[torch.searchsorted(
                    order[so], cand_gidx[members])].to(torch.int32)
                break
            if level >= max_levels:
                raise RuntimeError("merge-path escalation overran the window bound")
            # fetch the next window level for unfinished members of open
            # groups (finished members' deeper words are genuine zeros)
            fetch = torch.nonzero(amb & ~cand_ended & (cand_levels <= level)).squeeze(1)
            if fetch.shape[0]:
                keys, ended = store.fetch_keys(cand_gidx[fetch], level)
                cand_words = _widen(cand_words, (level + 1) * kw)
                cand_words[fetch, level * kw : (level + 1) * kw] = keys
                cand_levels[fetch] = level + 1
                cand_ended[fetch] |= ended
            level += 1
        for ti, t in enumerate(live):
            b0, b1 = bounds[ti], bounds[ti + 1]
            t.words, t.levels, t.ended = (
                cand_words[b0:b1], cand_levels[b0:b1], cand_ended[b0:b1])
            t.width = cand_words.shape[1]
        _account()

        # ---- prefetch the next refill while this tile ranks ---------------
        # the worker runs the unaccounted gather_keys; note_fetched accounts
        # it on this thread at collection, before emit touches the store
        pf_task = pf_sizes = None
        if executor is not None:
            pf_needs = [t.prefetch_need(tile) for t in tiles]
            pf_sizes = [int(n.shape[0]) for n in pf_needs]
            if sum(pf_sizes):
                pf_task = executor.submit(store.gather_keys, torch.cat(pf_needs), 0)

        # ---- rank the tile: merge-path diagonal ranks in one shot ---------
        pipeline_point("merge:rank")
        if tie_col is not None:
            cand_words = torch.cat([cand_words, tie_col[:, None]], dim=1)
        if use_pallas:
            from repro_torch.kernels import ops as kops

            idx_hi = (cand_gidx >> WORD_BITS).to(torch.int32)
            idx_lo = (cand_gidx & (WORD_MOD - 1)).to(torch.int32)
            keys_full = torch.cat(
                [cand_words, idx_hi[:, None], idx_lo[:, None]], dim=1).contiguous()
            ranks = kops.merge_path_ranks(keys_full).to(torch.int64)
        else:
            ranks = store.rank_windows(cand_words, cand_gidx)

        # ---- collect the prefetched refill (the store is ours again) ------
        if pf_task is not None:
            pipeline_point("merge:collect")
            pf_keys, pf_ended = pf_task.result()
            store.note_fetched(pf_keys.shape[0])  # main-thread accounting
            for t, (keys, ended) in zip(tiles, _split(pf_keys, pf_ended, pf_sizes),
                                        strict=True):
                t.admit_pending(keys, ended)
            _account()

        # ---- emit everything below the safety horizon ---------------------
        pipeline_point("merge:emit")
        # (scalars gathered from views on the device: no host-to-device copy)
        partial = [ranks[bounds[ti + 1] - 1] for ti, t in enumerate(live)
                   if t.remaining > t.buffered]  # partially buffered runs
        horizon = torch.full((1,), c, dtype=torch.int64, device=dev)
        if partial:
            horizon = torch.clamp(torch.stack(partial).min() + 1, max=c).reshape(1)
        take = ranks < horizon
        taken = torch.cumsum(take, 0)
        taken = torch.stack([taken[b - 1] for b in bounds[1:]])
        counts = torch.diff(taken, prepend=torch.zeros(1, dtype=taken.dtype, device=dev))
        emit_cnt, *consumed = torch.cat([horizon, counts]).tolist()
        slots = torch.empty(c + 1, dtype=torch.int64, device=dev)
        slots[torch.where(take, ranks, c)] = cand_gidx
        sink.append(slots[:emit_cnt])
        for t, n in zip(live, consumed, strict=True):
            t.consume(n)
        _account()
    store.add_frontier(-registered)
    return peak_candidates


def _split_boundary_risk(
    plan: SuperblockPlan,
    local_sas: List,
    block_stats: List[dict],
    k: int,
    device=None,
) -> Tuple[List, torch.Tensor]:
    """Text mode: split each block's run into its exactly-sorted part and
    the block-boundary risk set (on ``device``, the runs' own by default).
    A streaming build's runs are spilled memmaps, and its exact parts come
    back as host arrays.

    A block build examines at most ``rounds * K`` tokens a suffix, so a
    suffix further than that from the block end was ordered by genuine
    global tokens; the rest, and whole blocks with unresolved ties, are
    re-ranked against the store.  The last block ends at the text end.
    """
    runs: List = []
    risk: List = []
    last = len(plan.blocks) - 1
    for bi, ((_, hi), sa_b) in enumerate(zip(plan.blocks, local_sas, strict=True)):
        if bi == last:
            runs.append(sa_b)
            continue
        if block_stats[bi].get("unresolved", 0):
            risk.append(sa_b)  # block order unproven: re-rank the whole block
            continue
        reach = block_stats[bi]["rounds"] * k
        keep = (hi - sa_b) > reach
        runs.append(sa_b[keep])
        risk.append(sa_b[~keep])
    dev = device if device is not None else local_sas[0].device
    riskv = (torch.cat([_to_device(r, dev) for r in risk]) if risk
             else torch.zeros((0,), dtype=torch.int64, device=dev))
    return [r for r in runs if r.shape[0]], riskv


# ---------------------------------------------------------------------------
# the out-of-core build
# ---------------------------------------------------------------------------


def build_suffix_array_superblock(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    sb: SuperblockConfig = SuperblockConfig(),
    device=None,
    group=None,
) -> SAResult:
    """Out-of-core SA build: per-superblock pipeline runs plus the merge;
    one block runs in core, with the post-hoc LCP under ``sb.emit_lcp``.

    ``corpus`` is an array, a chunked corpus file path or a
    :class:`StoreBackend`; ``device`` places the backend of an array or a
    path (the card by default) and the build runs there.  With the chunked
    backend the build is out of host RAM: see the module docstring.  The
    build closes a backend it made, never one the caller passed in, with
    or without the retry layer of ``store_retries`` and the sanitizer.

    ``resume`` with a ``spill_dir`` is the journaled regime: the scratch
    directory is ``spill_dir/scratch``, a killed attempt's orphaned
    temporary files are swept first, and a failed build keeps its scratch
    directory and journal for the next attempt.

    ``group``: the ``torch.distributed`` process group (``None``: the
    initialized world, one rank without one).  Every rank passes the whole
    corpus, builds every block collectively, runs the whole merge on the
    same inputs and returns the same result.  Rank 0 owns ``spill_dir``
    (shared by the ranks): it alone writes the journal, the scratch runs,
    the outputs and the index files there; the other ranks keep their
    scratch in a private temporary directory, removed when they return or
    fail, and read what rank 0 wrote only after a barrier.
    """
    ranks = world(group)
    owner = ranks.rank == 0
    # a scratch directory whenever the build streams, and always when it is
    # journaled: block runs then spill on every backend, so a resumed build
    # has something durable to adopt
    journaled = sb.resume and sb.spill_dir is not None
    needs_scratch = (
        isinstance(corpus, (str, os.PathLike))
        or (isinstance(corpus, StoreBackend)
            and not isinstance(corpus, InMemoryBackend))
        or (not isinstance(corpus, StoreBackend) and sb.store_backend == "chunked")
        or journaled
    )
    private = None
    if not owner and (needs_scratch or sb.spill_dir is not None):
        private = tempfile.mkdtemp(prefix=f"sa_rank{ranks.rank}_")
    scratch = None
    backend: Optional[StoreBackend] = None
    owns_backend = True
    ok = False
    try:
        if private is not None:
            scratch = _Scratch(private) if needs_scratch else None
        elif journaled:
            os.makedirs(sb.spill_dir, exist_ok=True)
            # a killed attempt cannot clean up after itself: sweep its
            # orphaned publish temporaries (the journal and the scratch runs
            # survive)
            for orphan in os.listdir(sb.spill_dir):
                if orphan.endswith((".tmp", ".tmp.npy")):
                    with contextlib.suppress(OSError):
                        os.unlink(os.path.join(sb.spill_dir, orphan))
            scratch = _Scratch(sb.spill_dir,
                               stable_dir=os.path.join(sb.spill_dir, "scratch"))
        else:
            if sb.spill_dir is not None:
                os.makedirs(sb.spill_dir, exist_ok=True)
            scratch = _Scratch(sb.spill_dir) if needs_scratch else None
        if isinstance(corpus, StoreBackend):
            device = corpus.device
        backend = _resolve_backend(corpus, cfg, sb, scratch, resolve_device(device),
                                   ranks)
        owns_backend = backend is not corpus  # decided before any wrapping
        if sb.store_retries > 0:
            backend = RetryingBackend(backend, retries=sb.store_retries,
                                      backoff_s=sb.store_backoff_s)
        if sanitize_enabled(sb):
            backend = SanitizingBackend(backend)
        res = _build_superblock(backend, lengths, cfg, sb, scratch,
                                original_corpus=corpus, ranks=ranks,
                                out_dir=sb.spill_dir if owner else private)
        ok = True
    finally:
        if backend is not None and owns_backend:
            backend.close()
        if scratch is not None:
            if scratch.journal is not None:
                scratch.journal.close()  # flushed; kept on disk for a resume
            if ok or not journaled:
                scratch.cleanup()
        if private is not None:
            shutil.rmtree(private, ignore_errors=True)
    if sb.spill_dir is not None:
        barrier(ranks)  # rank 0's files are complete before any rank returns
    return res


def _rank0_decides(ranks: Ranks, decide: Callable):
    """``decide()`` run on rank 0 alone, and its value, or the exception it
    raised, on every rank: the ranks act on one decision, and a refusal
    raises the same exception everywhere."""
    if ranks.size == 1:
        return decide()
    out = None
    if ranks.rank == 0:
        try:
            out = ("value", decide())
        except Exception as e:  # broadcast, then raised on every rank
            out = ("raise", e)
    kind, val = broadcast_object(out, ranks)
    if kind == "raise":
        raise val
    return val


def _build_superblock(backend: StoreBackend, lengths, cfg: SAConfig,
                      sb: SuperblockConfig, scratch: Optional[_Scratch],
                      original_corpus, ranks: Ranks = SINGLE,
                      out_dir: Optional[str] = None) -> SAResult:
    """Executor lifecycle around the phased build: ``sb.pipeline_depth >=
    1`` attaches one background worker shared by the staging prefetch, the
    spill and output writes and the merge's refill prefetch; it is drained
    and joined on success and on failure alike, and a failure unlinks the
    output sink's temporary memmaps.  ``out_dir`` takes the outputs'
    memmaps: ``spill_dir`` on rank 0, a private directory on the others."""
    pipe: Optional[PipelineExecutor] = None
    if sb.pipeline_depth > 0:
        pipe = PipelineExecutor(depth=sb.pipeline_depth, name="sa-pipeline")
    if scratch is not None:
        scratch.executor = pipe
    sinks: List[_OutputSink] = []
    try:
        res = _build_superblock_phases(backend, lengths, cfg, sb, scratch,
                                       original_corpus, pipe, sinks, ranks,
                                       out_dir)
    except BaseException:
        for s in sinks:
            with contextlib.suppress(BaseException):
                s.abort()
        if pipe is not None:
            with contextlib.suppress(BaseException):
                pipe.close()
        raise
    if pipe is not None:
        pipe.close()
    return res


def _budget(sb: SuperblockConfig) -> int:
    return sb.cache_budget_bytes if sb.cache_budget_bytes > 0 else DEFAULT_CACHE_BUDGET


def _build_superblock_phases(
    backend: StoreBackend,
    lengths,
    cfg: SAConfig,
    sb: SuperblockConfig,
    scratch: Optional[_Scratch],
    original_corpus,
    pipe: Optional[PipelineExecutor],
    sinks: List[_OutputSink],
    ranks: Ranks = SINGLE,
    out_dir: Optional[str] = None,
) -> SAResult:
    if sb.write_manifest and not sb.spill_dir:
        raise ValueError(
            "write_manifest needs spill_dir: the manifest finalizes that "
            "directory as the reopenable index"
        )
    plan = plan_superblocks(backend.shape, cfg, sb)
    dev = backend.device
    if plan.num_superblocks <= 1:
        store = CorpusStore(None, cfg, backend=backend,
                            request_capacity=sb.request_capacity)
        res = build_suffix_array(store.stage_items(0, backend.n), lengths=lengths,
                                 cfg=cfg, device=dev, group=ranks.group)
        # no ordered emission to piggyback on: the LCP is computed post hoc
        # from the finished SA, and the index directory is written wholesale
        if sb.emit_lcp and res.lcp is None:
            batch = CUDA_LCP_BATCH if dev.type == "cuda" else 1 << 16
            res.lcp = lcp_from_sa(store, res.suffix_array, batch=batch)
            res.stats["emit_lcp"] = True
        if sb.write_manifest:
            _write_index_manifest(res, backend, cfg, sb, scratch, ranks)
        return res
    if sb.merge_backend not in ("host", "device"):
        raise ValueError(f"unknown merge_backend: {sb.merge_backend!r}")
    if sb.merge_algorithm not in ("merge_path", "kway", "rerank"):
        raise ValueError(f"unknown merge_algorithm: {sb.merge_algorithm!r}")
    streaming = not isinstance(unwrap_backend(backend), InMemoryBackend)
    if streaming and sb.merge_backend == "device":
        raise ValueError(
            "merge_backend='device' needs the corpus HBM-resident; "
            "use store_backend='memory' (the chunked backend exists to keep "
            "the corpus off-host, which the device refiner cannot serve)"
        )
    assert not streaming or scratch is not None  # the wrapper provides it

    # ---- the build journal: resume + spill_dir arm an fsync'd append-only
    # journal beside the stable scratch directory.  Block runs are journaled
    # as they become durable; a re-entered build replays the journal and
    # adopts every verified block.  The merge is always redone from the runs.
    # At D ranks rank 0 alone keeps the journal and decides the adoption;
    # the others adopt the same blocks from rank 0's verified runs.
    journaled = sb.resume and sb.spill_dir is not None and scratch is not None
    jr: Optional[BuildJournal] = None
    resumed: dict = {}
    journal_hits = 0
    if journaled:
        jpath = os.path.join(sb.spill_dir, JOURNAL_NAME)
        runs_seen: dict = {}

        def adoption():
            """(whether the journal had records, {block: (run path, its
            record)}), every run verified; raises a refusal."""
            fp_rec = dict(backend_fingerprint(backend))
            fp_rec.update(superblocks=int(plan.num_superblocks),
                          capacity=int(plan.capacity_records),
                          merge_algorithm=sb.merge_algorithm,
                          emit_lcp=bool(sb.emit_lcp))
            records = BuildJournal.load(jpath)  # CorruptionError on a bad interior
            if records:
                if records[0].get("t") != "begin":
                    raise CorruptionError(
                        "build journal", detail="first record is not 'begin'",
                        path=jpath)
                if records[0].get("fp") != fp_rec:
                    raise ValueError(
                        "resume refused: the journal in spill_dir belongs to a "
                        "different build (corpus/plan fingerprint mismatch) — "
                        "remove it or use a fresh spill_dir")
            adopted = {}
            for r in records:
                if r.get("t") != "block":
                    continue
                run_path = scratch.path(r["run"])
                if not os.path.exists(run_path):
                    continue  # its spill never became durable: rebuild it
                runs_seen[run_path] = verify_spilled_run(
                    run_path, r["run_crc"], f"spilled run {r['run']}")
                adopted[int(r["i"])] = (run_path, r)
            return fp_rec, bool(records), adopted

        fp_rec, had_records, adopted = _rank0_decides(ranks, adoption)
        for i, (run_path, r) in adopted.items():
            # rank 0's verified memmap; a read-only map of it elsewhere
            mm = runs_seen.get(run_path)
            resumed[i] = (_Scratch.map_run(run_path) if mm is None else mm, r)
        barrier(ranks)  # mapped on every rank before rank 0 may retire them
        if ranks.rank == 0:
            jr = BuildJournal(jpath).open()
            scratch.journal = jr  # the lifecycle wrapper closes it on exit
            if not had_records:
                jr.append({"t": "begin", "v": BuildJournal.VERSION, "fp": fp_rec})

    store = CorpusStore(
        None, cfg, backend=backend,
        request_capacity=min(sb.request_capacity, plan.capacity_records),
    )
    frontier = None
    if streaming:
        # LRU half + read-ahead eighth + splitter-pool eighth; the rest is
        # slack for tie depth (merge-path rows widen as groups escalate,
        # k-way partition probes release after each search)
        wb = store.k * 4
        frontier = _MergeFrontier(
            readahead_bytes=max(_budget(sb) // 8, 2 * plan.num_superblocks * wb),
            window_bytes=wb,
            max_pool_windows=max(4, min(64, (_budget(sb) // 8) // wb)))

    def keep_run(run):
        """A sorted run as the merge takes it: streaming or journaled,
        spilled to disk (a run that already is a spill's memmap stays as it
        is); else a tensor on the store's device."""
        if streaming or journaled:
            if run.shape[0] and not isinstance(run, np.memmap):
                return scratch.spill_run(run)
            return run
        return _to_device(run, dev)

    # ---- phase 2: local SA per superblock -------------------------------
    corpus_tokens = backend.n * max(1, backend.row_len)
    local_sas: List = []
    fp = Footprint(
        input=corpus_tokens * store.token_bytes,
        store_put=corpus_tokens * store.token_bytes,
        superblocks=plan.num_superblocks,
    )
    block_stats = []
    blocks = list(plan.blocks)
    # staging prefetch: while block i builds, the worker stages the next
    # blocks (up to pipeline_depth ahead).  Streaming builds register each
    # prefetched block's bytes as frontier, within the budget's non-LRU half
    # (idle during phase 2); a block too big for it stages synchronously.
    stage_share = _budget(sb) // 2 if streaming else 0
    prefetched: dict = {}
    pf_registered = 0

    def _submit_stages(next_i: int) -> None:
        nonlocal pf_registered
        if pipe is None:
            return
        for j in range(next_i, min(len(blocks), next_i + pipe.depth)):
            if j in prefetched or j in resumed:
                continue
            blo, bhi = blocks[j]
            reg = 0
            if streaming:
                reg = (bhi - blo) * max(1, backend.row_len) * 4
                if pf_registered + reg > stage_share:
                    break  # would overrun the budget share: stage it sync
                store.add_frontier(reg)
                pf_registered += reg
            prefetched[j] = (pipe.submit(store.stage_read, blo, bhi), reg)

    # a block's journal record waits here until its run's spill write is
    # observed done on this thread (SAL008: the journal is touched only
    # here): a journaled run is durable before the record promising it
    pending_journal: List[tuple] = []

    def _flush_journal(force: bool = False) -> None:
        while pending_journal:
            rec, task = pending_journal[0]
            if task is not None:
                if not force and not task.done():
                    return
                task.result()  # re-raises a failed spill write
            jr.append(rec)  # fsync'd: the unit of recovery
            pending_journal.pop(0)

    t_stage = t_build = 0.0
    for i, (lo, hi) in enumerate(blocks):
        pre = resumed.get(i)
        if pre is not None:
            # verified complete by an earlier attempt: adopt its run, stats
            # and footprint contributions without touching the store
            mm, rec = pre
            local_sas.append(mm)
            block_stats.append(rec["stats"])
            bfc = rec.get("fpc", {})
            fp.shuffle += bfc.get("shuffle", 0)
            fp.fetch_request += bfc.get("fetch_request", 0)
            fp.fetch_response += bfc.get("fetch_response", 0)
            fp.rounds = max(fp.rounds, bfc.get("rounds", 0))
            fp.dropped += bfc.get("dropped", 0)
            fp.peak_records = max(fp.peak_records, rec["stats"]["num_suffixes"])
            journal_hits += 1
            continue
        with span("sb.stage", dev) as stage:
            entry = prefetched.pop(i, None)
            if entry is not None:
                task, reg = entry
                pipeline_point("stage:collect")
                block = task.result()
                store.note_staged(lo, hi, block.nbytes)
                if reg:
                    store.add_frontier(-reg)
                    pf_registered -= reg
            else:
                block = store.stage_items(lo, hi)
            _submit_stages(i + 1)
        t_stage += stage.host_s
        with span("sb.block", dev) as block_span:
            pipeline_point("build:block")
            if plan.text_mode:
                res = build_suffix_array(block, cfg=cfg, device=dev, group=ranks.group)
                sa_b = res.suffix_array + lo
            else:
                lens_b = None if lengths is None else np.asarray(lengths)[lo:hi]
                res = build_suffix_array(block, lengths=lens_b, cfg=cfg, device=dev,
                                         group=ranks.group)
                sa_b = res.suffix_array + (np.int64(lo) << plan.stride_bits)
            run = keep_run(sa_b)
            local_sas.append(run)
            bf = res.footprint
            fp.shuffle += bf.shuffle
            fp.fetch_request += bf.fetch_request
            fp.fetch_response += bf.fetch_response
            fp.rounds = max(fp.rounds, bf.rounds)
            fp.dropped += bf.dropped
            fp.peak_records = max(fp.peak_records, res.stats["num_suffixes"])
            block_stats.append(res.stats)
            if jr is not None and isinstance(run, np.memmap):
                path, task = scratch.last_spill
                pending_journal.append(({
                    "t": "block", "i": i,
                    "run": os.path.basename(path),
                    "run_crc": crc32_array(sa_b),
                    "rows": int(sa_b.shape[0]),
                    "stats": res.stats,
                    "fpc": {
                        "shuffle": int(bf.shuffle),
                        "fetch_request": int(bf.fetch_request),
                        "fetch_response": int(bf.fetch_response),
                        "rounds": int(bf.rounds),
                        "dropped": int(bf.dropped),
                    },
                }, task))
                _flush_journal()
        t_build += block_span.host_s
    if scratch is not None:
        scratch.drain_spills()  # spilled runs must be on disk before reads
    if jr is not None:
        _flush_journal(force=True)  # every run is durable now

    # ---- phase 3: boundary-exact merge via the store --------------------
    with span("sb.merge", dev) as merge:
        samples = max(1, min(sb.samples_per_block,
                             plan.capacity_records // plan.num_superblocks))
        cap = plan.capacity_records
        pre_requests = store.requests
        total_suffixes = int(sum(r.shape[0] for r in local_sas))
        out_path = lcp_path = pair_lcp = None
        if out_dir is not None:
            out_path = os.path.join(out_dir, "suffix_array.npy")
        if sb.emit_lcp:
            # emit order is final order: each emitted suffix's LCP is one
            # adjacent compare against the previous one, served by the store
            def pair_lcp(a, b):
                return pairwise_lcp(store, a, b)

            if out_dir is not None:
                lcp_path = os.path.join(out_dir, "lcp.npy")
        sink = _OutputSink(total_suffixes, dev, pair_lcp=pair_lcp, executor=pipe,
                           memmap_path=out_path, lcp_path=lcp_path)
        sinks.append(sink)
        if jr is not None:
            sink = _JournalingSink(sink, jr)  # emitted-rows watermark records
        if sanitize_enabled(sb):
            # order-checks the emitted pieces through a private audit store: the
            # build store's traffic counters stay the unsanitized build's
            sink = SanitizingSink(sink, backend, cfg,
                                  request_capacity=sb.request_capacity)
        peak_candidates = 0

        cur = WindowCursor(store)
        refiner: Optional[DeviceRefiner] = None
        if sb.merge_backend == "device":
            refiner = DeviceRefiner(
                original_corpus if isinstance(original_corpus, np.ndarray)
                else store.stage_items(0, backend.n),
                cfg, lengths=lengths, device=dev, group=ranks.group,
            )
            refine = refiner.refine
        else:
            # kway: the merge cursor is offered every re-rank fetch, so the
            # k-way phase serves those windows from its cache.  Not streaming:
            # the offers would keep a window a re-ranked suffix cached, beyond
            # the frontier's bound
            warm = cur if (sb.merge_algorithm == "kway" and not streaming) else None

            def refine(g: torch.Tensor) -> torch.Tensor:
                return _refine_sort(store, g, cursor=warm)

        def risk_free_runs() -> Tuple[List, List]:
            """The exactly-sorted runs of the merge, as ``(runs, pieces)``:
            block SAs with the text-mode risk set (and blocks of unresolved
            ties) re-ranked into sorted pieces that join the merge as runs of
            their own.  No runs: every suffix was at risk, and the pieces
            already are consecutive intervals of the true order."""
            if plan.text_mode:
                runs, risk = _split_boundary_risk(plan, local_sas, block_stats, store.k,
                                                  device=dev)
                runs = [keep_run(r) for r in runs]  # re-spill the filtered runs
                bad = [risk] if risk.shape[0] else []
            else:
                # reads mode: block runs are exact, unless a block hit the
                # refinement hard cap; such blocks are re-ranked like a risk set
                runs = [r for r, st in zip(local_sas, block_stats, strict=True)
                        if st.get("unresolved", 0) == 0]
                bad = [_to_device(r, dev) for r, st in zip(local_sas, block_stats, strict=True)
                       if st.get("unresolved", 0) != 0]
            pieces = []
            if bad:
                pieces = [keep_run(p) for p in
                          _sorted_runs(store, torch.cat(bad), cap, samples, refine)
                          if p.shape[0]]
            if scratch is not None:
                scratch.drain_spills()  # the merge reads these runs next
            return runs, pieces

        if sb.merge_algorithm == "rerank":
            # every suffix re-ranked from scratch (block order only samples the
            # splitters): the traffic baseline
            every = torch.cat([_to_device(r, dev) for r in local_sas])
            for p in _sorted_runs(store, every, cap, samples, refine):
                sink.append(p)
        else:
            runs, pieces = risk_free_runs()
            if not runs:
                for p in pieces:
                    sink.append(p)
            elif sb.merge_algorithm == "merge_path":
                peak_candidates = _merge_path_runs(
                    store, runs + pieces, sink, cap, sb.merge_tile, cfg.use_pallas,
                    refiner=refiner, frontier=frontier, executor=pipe,
                )
            else:
                # the splitter pools are lists of sorted pick runs: merged through
                # the cursor, their windows are fetched once and stay cached for
                # the partition probes and the bucket merges
                def rank_pool(pool_runs: List[np.ndarray]) -> np.ndarray:
                    return _kway_merge(cur, pool_runs, release=False)

                # the heap walks host arrays: the runs come there here
                for p in _merge_runs(cur, [_to_host(r) for r in runs + pieces], cap,
                                     samples, rank_pool, frontier=frontier):
                    sink.append(p)
        sa = sink.result()
    t_merge = merge.host_s
    if sanitize_enabled(sb):
        check_footprint(store, backend)

    dev_req = refiner.requests if refiner else 0
    dev_req_bytes = refiner.request_bytes if refiner else 0
    dev_resp_bytes = refiner.response_bytes if refiner else 0
    fp.fetch_request += store.request_bytes + dev_req_bytes
    fp.fetch_response += store.response_bytes + dev_resp_bytes
    fp.output = int(sa.shape[0]) * 8
    fp.peak_records = max(fp.peak_records, store.peak_windows,
                          refiner.peak_records if refiner else 0,
                          peak_candidates, sink.max_piece)
    fp.materialized = fp.peak_records * 16
    fp.peak_resident_bytes = store.peak_resident_bytes

    stats = {
        "num_suffixes": int(sa.shape[0]),
        "emitted": int(sa.shape[0]),
        "superblocks": plan.num_superblocks,
        "capacity_records": plan.capacity_records,
        "peak_records": fp.peak_records,
        "merge_algorithm": sb.merge_algorithm,
        "merge_backend": sb.merge_backend,
        "merge_pieces": sink.pieces,
        "max_piece": int(sink.max_piece),
        "merge_fetch_requests": int(store.requests - pre_requests) + dev_req,
        "merge_fetch_bytes": int(store.request_bytes + store.response_bytes
                                 + dev_req_bytes + dev_resp_bytes),
        "merge_fetch_rounds": int(store.rounds) + (refiner.rounds if refiner else 0),
        "merge_retries": int(store.retries),
        "merge_cursor_peak_windows": cur.peak_cached_windows,
        "block_rounds": [s["rounds"] for s in block_stats],
        "dropped": fp.dropped,
        "unresolved": sum(s["unresolved"] for s in block_stats),
        "store_backend": "chunked" if streaming else "memory",
        "corpus_bytes": backend.corpus_bytes,
        "peak_resident_bytes": fp.peak_resident_bytes,
        "store_cache_hits": backend.cache_hits,
        "store_cache_misses": backend.cache_misses,
        "store_cache_hit_rate": backend.hit_rate,
        "spilled_runs": scratch.spilled_runs if scratch else 0,
        "spilled_bytes": scratch.spilled_bytes if scratch else 0,
        "emit_lcp": bool(sb.emit_lcp),
        "sanitized": sanitize_enabled(sb),
        "journaled": journaled,
        "journal_hits": int(journal_hits),
        "store_retry_attempts": int(getattr(backend, "retry_attempts", 0)),
        "store_retried_calls": int(getattr(backend, "retried_calls", 0)),
        "pipeline_depth": int(sb.pipeline_depth),
        "t_stage_s": round(t_stage, 6),
        "t_build_s": round(t_build, 6),
        "t_merge_s": round(t_merge, 6),
    }
    res = SAResult(suffix_array=sa, footprint=fp, stats=stats, lcp=sink.lcp)
    if sb.write_manifest:
        _write_index_manifest(res, backend, cfg, sb, scratch, ranks)
    if jr is not None:
        # the terminal record, then the journal retires: the build is
        # complete and its artifacts are published
        jr.append({"t": "done", "rows": int(sa.shape[0])})
        jr.finalize()
    return res


def _write_index_manifest(res: SAResult, backend: StoreBackend, cfg: SAConfig,
                          sb: SuperblockConfig, scratch: Optional[_Scratch],
                          ranks: Ranks = SINGLE) -> None:
    """Finalize ``sb.spill_dir`` as a reopenable index directory
    (``repro.core.superblock._write_index_manifest``): the corpus is
    referenced in place when the backend serves a persistent chunked file
    (the caller's own, or the copy ``_resolve_backend`` placed in
    ``spill_dir``); a scratch-resident or in-memory corpus is serialized
    into the directory, since scratch dies with the build.  At D ranks
    rank 0 writes the directory; every rank records it in its stats."""
    from repro_torch.core import index_io

    if ranks.rank != 0:
        res.stats["index_dir"] = sb.spill_dir
        return

    corpus_ref = None
    p = getattr(backend, "path", None)
    if p is not None:
        ap = os.path.abspath(p)
        in_scratch = scratch is not None and ap.startswith(
            os.path.abspath(scratch.dir) + os.sep)
        if not in_scratch:
            corpus_ref = ap
    index_io.save_index(
        sb.spill_dir, cfg, backend, res.suffix_array, res.lcp, res.stats,
        corpus_ref=corpus_ref, chunk_items=sb.chunk_records,
    )
    res.stats["index_dir"] = sb.spill_dir


def build_suffix_array_auto(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    sb: Optional[SuperblockConfig] = None,
    device=None,
    group=None,
) -> SAResult:
    """Single-pass build when the record set fits one run (the launcher's
    policy); a plan of more blocks, an LCP array or a manifest goes through
    :func:`build_suffix_array_superblock`, as in ``repro``.  ``corpus`` is
    an array, a chunked corpus file path or a :class:`StoreBackend`;
    ``device`` and ``group`` as for
    :func:`repro_torch.core.pipeline.build_suffix_array`."""
    sb = sb or SuperblockConfig()
    plan = plan_superblocks(corpus_shape_of(corpus), cfg, sb)
    if plan.num_superblocks <= 1 and not (sb.emit_lcp or sb.write_manifest):
        if isinstance(corpus, StoreBackend):
            corpus = materialize_backend(corpus)
        elif isinstance(corpus, (str, os.PathLike)):
            from repro_torch.data import chunk_store

            corpus = chunk_store.load_corpus(os.fspath(corpus))
        return build_suffix_array(corpus, lengths=lengths, cfg=cfg, device=device,
                                  group=group)
    return build_suffix_array_superblock(corpus, lengths=lengths, cfg=cfg, sb=sb,
                                         device=device, group=group)
