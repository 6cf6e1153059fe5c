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
3. **Merge via the store** (``merge_algorithm="merge_path"``): text-mode
   block tails (the risk set) are re-ranked exactly against the store and
   join the merge as runs of their own; then every run's next ``tile``
   heads are fetched in one batched store call and packed to key words,
   tie groups deeper than the fetched window are escalated together (one
   batched fetch per depth, or one :class:`DeviceRefiner` call under
   ``merge_backend="device"``), and every candidate's output rank comes
   from one ``merge_path_ranks`` launch (the hand-written CUDA kernel under
   ``cfg.use_pallas``, ``CorpusStore.rank_windows`` otherwise).  Everything
   ranked below the merge-path safety horizon is emitted, with its LCP
   under ``emit_lcp``.  The tile state lives on the store's device; a round
   reads one scalar per escalation level and one for the horizon.

The output equals the JAX package's: the suffix array, the LCP array, every
``Footprint`` field and every ``stats`` key but the wall times ``t_*_s``.
The k-way and re-rank merges, resume, the sanitizer and store retries raise
``NotImplementedError`` naming ROADMAP.md item 9b; index manifests, spill
directories, the chunked store backend and corpus files name item 8.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core.distributed import lex_order, run_starts
from repro_torch.core.lcp import lcp_from_sa, pairwise_lcp
from repro_torch.core.pipeline import DeviceRefiner, _tied, build_suffix_array
from repro_torch.core.pipeline_exec import PipelineExecutor, pipeline_point
from repro_torch.core.store import (
    CorpusStore,
    InMemoryBackend,
    StoreBackend,
    materialize_backend,
)
from repro_torch.core.types import WORD_BITS, WORD_MOD, Footprint, SAResult

# LCP pairs compared at once on the card (the default of ``lcp_from_sa`` on
# the CPU); the single-block build's LCP store is discarded, so the batch
# changes no reported number
CUDA_LCP_BATCH = 1 << 22
_PERSISTENCE = "is ROADMAP.md item 8"
_ITEM_9B = "is ROADMAP.md item 9b"


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
    :class:`StoreBackend`'s geometry.  Corpus files are item 8."""
    if isinstance(corpus, StoreBackend):
        return corpus.shape
    if isinstance(corpus, (str, os.PathLike)):
        raise NotImplementedError(f"chunked corpus files {_PERSISTENCE}")
    return np.shape(corpus)


def _refuse_unported(sb: SuperblockConfig) -> None:
    if sb.write_manifest or sb.spill_dir is not None or sb.store_backend != "memory":
        raise NotImplementedError(
            "index manifests, spill directories and the chunked store "
            f"backend {_PERSISTENCE}")
    if (sb.resume or sb.sanitize or sb.store_retries > 0
            or os.environ.get("REPRO_SANITIZE", "") not in ("", "0")):
        raise NotImplementedError(
            f"resume, the sanitizer and store retries {_ITEM_9B}")


# ---------------------------------------------------------------------------
# exact suffix comparisons against the resident store
# ---------------------------------------------------------------------------


def _rows_equal_prev(rows: torch.Tensor) -> torch.Tensor:
    """eq[i] = (row i == row i-1), eq[0] = False."""
    eq = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    eq[1:] = (rows[1:] == rows[:-1]).all(dim=1)
    return eq


def _refine_sort(store: CorpusStore, gidx: torch.Tensor) -> torch.Tensor:
    """Rank ``gidx`` by exact suffix order with batched store fetches
    (``repro.core.superblock._refine_sort`` without the cursor).

    Sort by the first K-token window, then refine still-tied groups one
    window at a time; zero-padding orders shorter suffixes first and the
    global index is the last key.  A tie group advances a window only when
    every active member was served (``mget_window_host``'s capacity rule).
    """
    m = gidx.shape[0]
    if m <= 1:
        return gidx
    k = store.k
    dev = gidx.device
    win = store.fetch_windows(gidx, 0)
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
    package does, so the request counts do not depend on the chunking.
    """
    dev = gidx.device
    out = torch.zeros(gidx.shape[0], dtype=torch.bool, device=dev)
    cap = store.request_capacity
    cache = {}  # depth -> pivot window, shared by every chunk
    for clo in range(0, gidx.shape[0], cap):
        chunk = gidx[clo : clo + cap]
        res = torch.zeros(chunk.shape[0], dtype=torch.bool, device=dev)
        undecided = torch.ones(chunk.shape[0], dtype=torch.bool, device=dev)
        depth = 0
        while bool(undecided.any()):
            wp = cache.get(depth)
            if wp is None:
                wp = store.fetch_windows([pivot], depth)[0]
                cache[depth] = wp
            sel = torch.nonzero(undecided).squeeze(1)
            ws = store.fetch_windows(chunk[sel], depth)
            neq = ws != wp[None, :]
            anyneq = neq.any(dim=1)
            first = neq.to(torch.uint8).argmax(dim=1)
            less = ws[torch.arange(sel.shape[0], device=dev), first] < wp[first]
            res[sel[anyneq]] = less[anyneq]
            undecided[sel[anyneq]] = False
            if bool((wp == 0).any()):
                # equal windows incl. padding: both suffixes ended, the
                # contents are equal and the index breaks the tie
                eq_sel = sel[~anyneq]
                res[eq_sel] = chunk[eq_sel] < pivot
                undecided[eq_sel] = False
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
# merge-path: batched tile merge on the store's device
# ---------------------------------------------------------------------------


class _OutputSink:
    """Final-order SA emitter, in memory on the store's device.

    Pieces arrive in true suffix order and are written sequentially; with an
    executor the writes run on its worker, in submission order.  With
    ``pair_lcp`` (``SuperblockConfig.emit_lcp``) the sink also emits the
    LCP array: ``lcp[i]`` is one compare between consecutive emitted
    suffixes, across piece seams too, in batches of ``_LCP_BATCH`` pairs,
    as the JAX sink batches them (the batching decides the store's round
    count).
    """

    _LCP_BATCH = 1 << 16

    def __init__(self, total: int, device, pair_lcp=None,
                 executor: Optional[PipelineExecutor] = None):
        self.total = int(total)
        self.written = 0
        self.pieces = 0
        self.max_piece = 0
        self._exec = executor
        self._tasks: List = []
        self._out = torch.empty(self.total, dtype=torch.int64, device=device)
        self._pair_lcp = pair_lcp
        self._last: Optional[torch.Tensor] = None  # last emitted gidx, (1,)
        self._lcp = (torch.empty(self.total, dtype=torch.int64, device=device)
                     if pair_lcp is not None else None)
        self.lcp: Optional[np.ndarray] = None  # host LCP, set by result()

    def append(self, piece: torch.Tensor) -> None:
        m = int(piece.shape[0])
        if m == 0:
            return
        pipeline_point("sink:append")
        if self._pair_lcp is not None:
            self._append_lcp(piece)
        if self._exec is not None:
            self._tasks.append(self._exec.submit(self._write, self.written, piece))
        else:
            self._write(self.written, piece)
        self.written += m
        self.pieces += 1
        self.max_piece = max(self.max_piece, m)

    def _write(self, lo: int, piece: torch.Tensor) -> None:
        self._out[lo : lo + piece.shape[0]] = piece

    def _append_lcp(self, p: torch.Tensor) -> None:
        m = int(p.shape[0])
        base = self.written
        start = 0
        if self._last is None:
            self._lcp[base] = 0  # lcp[0] has no left neighbour
            start = 1
        for lo in range(start, m, self._LCP_BATCH):
            hi = min(lo + self._LCP_BATCH, m)
            left = p[lo - 1 : hi - 1] if lo > 0 else torch.cat([self._last, p[: hi - 1]])
            self._lcp[base + lo : base + hi] = self._pair_lcp(left, p[lo:hi])
        self._last = p[-1:]

    def result(self) -> np.ndarray:
        assert self.written == self.total, (self.written, self.total)
        self._drain()
        if self._lcp is not None:
            self.lcp = self._lcp.cpu().numpy()
        return self._out.cpu().numpy()

    def _drain(self) -> None:
        """Wait for in-flight background writes (re-raises a write failure)."""
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            t.result()

    def abort(self) -> None:
        """Failure path: wait out in-flight writes, errors included."""
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            with contextlib.suppress(BaseException):
                t.result()


class _RunTile:
    """One sorted run's buffered frontier for the merge-path tile merge
    (``repro.core.superblock._RunTile``, its buffers on the run's device).

    Holds up to ``tile`` unconsumed run members with their packed key words
    (``width`` columns, ``levels * key_words`` of them as the escalation
    widens the tile), per-member fetched-level counts and end-of-suffix
    flags, plus the depth-0 keys prefetched for the next refill.  Columns
    past a member's fetched level are zeros.  ``nbytes`` counts the buffers
    as the JAX tile's numpy arrays count them (int32 words and levels,
    one-byte flags).
    """

    __slots__ = ("run", "pos", "count", "width", "words", "levels", "ended",
                 "kw", "pend_keys", "pend_ended")

    def __init__(self, run: torch.Tensor, kw: int):
        dev = run.device
        self.run = run
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

    @property
    def gidx(self) -> torch.Tensor:
        return self.run[self.pos : self.pos + self.count]

    def need(self, tile: int) -> torch.Tensor:
        """Run members to fetch so the buffer covers min(tile, remaining)
        (members already in the pending buffer excluded)."""
        want = min(tile, self.remaining) - self.count - self.pending
        lo = self.pos + self.count + self.pending
        return self.run[lo : lo + max(want, 0)]

    def prefetch_need(self, tile: int) -> torch.Tensor:
        """Run members whose depth-0 keys the next refill could ask for:
        the next window starts at the invariant ``pos + count``."""
        cap = min(tile, self.remaining - self.count) - self.pending
        lo = self.pos + self.count + self.pending
        return self.run[lo : lo + max(cap, 0)]

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
    runs: List[torch.Tensor],
    sink: _OutputSink,
    cap: int,
    merge_tile: int,
    use_pallas: bool,
    refiner: Optional[DeviceRefiner] = None,
    executor: Optional[PipelineExecutor] = None,
) -> int:
    """Merge exactly-sorted runs by merge-path tiles; emit in final order
    (``repro.core.superblock._merge_path_runs``, in-memory store).

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
    dev = runs[0].device
    kw = store.key_words
    tile = merge_tile if merge_tile > 0 else 4096
    tile = max(2, min(tile, cap // max(1, len(runs))))
    tiles = [_RunTile(r, kw) for r in runs]
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
    local_sas: List[torch.Tensor],
    block_stats: List[dict],
    k: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Text mode: split each block's run into its exactly-sorted part and
    the block-boundary risk set.

    A block build examines at most ``rounds * K`` tokens a suffix, so a
    suffix further than that from the block end was ordered by genuine
    global tokens; the rest, and whole blocks with unresolved ties, are
    re-ranked against the store.  The last block ends at the text end.
    """
    runs: List[torch.Tensor] = []
    risk: List[torch.Tensor] = []
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
    riskv = (torch.cat(risk) if risk
             else torch.zeros((0,), dtype=torch.int64, device=local_sas[0].device))
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
) -> SAResult:
    """Out-of-core SA build: per-superblock pipeline runs plus the merge;
    one block runs in core, with the post-hoc LCP under ``sb.emit_lcp``.

    ``corpus`` is an array or a :class:`StoreBackend`; ``device`` places an
    array's backend (the card by default) and the build runs there.
    """
    if isinstance(corpus, (str, os.PathLike)):
        raise NotImplementedError(f"chunked corpus files {_PERSISTENCE}")
    _refuse_unported(sb)
    if isinstance(corpus, StoreBackend):
        backend = corpus
    else:
        backend = InMemoryBackend(np.asarray(corpus, np.int32), cfg, device=device)
    try:
        return _build_superblock(backend, lengths, cfg, sb, original_corpus=corpus)
    finally:
        if backend is not corpus:
            backend.close()


def _build_superblock(backend: StoreBackend, lengths, cfg: SAConfig,
                      sb: SuperblockConfig, original_corpus) -> SAResult:
    """Executor lifecycle around the phased build: ``sb.pipeline_depth >=
    1`` attaches one background worker shared by the staging prefetch, the
    output writes and the merge's refill prefetch; it is drained and joined
    on success and on failure alike."""
    pipe: Optional[PipelineExecutor] = None
    if sb.pipeline_depth > 0:
        pipe = PipelineExecutor(depth=sb.pipeline_depth, name="sa-pipeline")
    sinks: List[_OutputSink] = []
    try:
        res = _build_superblock_phases(backend, lengths, cfg, sb,
                                       original_corpus, pipe, sinks)
    except BaseException:
        for s in sinks:
            s.abort()
        if pipe is not None:
            with contextlib.suppress(BaseException):
                pipe.close()
        raise
    if pipe is not None:
        pipe.close()
    return res


def _build_superblock_phases(
    backend: StoreBackend,
    lengths,
    cfg: SAConfig,
    sb: SuperblockConfig,
    original_corpus,
    pipe: Optional[PipelineExecutor],
    sinks: List[_OutputSink],
) -> SAResult:
    plan = plan_superblocks(backend.shape, cfg, sb)
    dev = backend.device
    if plan.num_superblocks <= 1:
        store = CorpusStore(None, cfg, backend=backend,
                            request_capacity=sb.request_capacity)
        res = build_suffix_array(store.stage_items(0, backend.n), lengths=lengths,
                                 cfg=cfg, device=dev)
        if sb.emit_lcp and res.lcp is None:
            batch = CUDA_LCP_BATCH if dev.type == "cuda" else 1 << 16
            res.lcp = lcp_from_sa(store, res.suffix_array, batch=batch)
            res.stats["emit_lcp"] = True
        return res
    if sb.merge_backend not in ("host", "device"):
        raise ValueError(f"unknown merge_backend: {sb.merge_backend!r}")
    if sb.merge_algorithm not in ("merge_path", "kway", "rerank"):
        raise ValueError(f"unknown merge_algorithm: {sb.merge_algorithm!r}")
    if sb.merge_algorithm != "merge_path":
        raise NotImplementedError(
            f"the {sb.merge_algorithm} merge {_ITEM_9B}")

    store = CorpusStore(
        None, cfg, backend=backend,
        request_capacity=min(sb.request_capacity, plan.capacity_records),
    )

    # ---- phase 2: local SA per superblock -------------------------------
    corpus_tokens = backend.n * max(1, backend.row_len)
    local_sas: List[torch.Tensor] = []
    fp = Footprint(
        input=corpus_tokens * store.token_bytes,
        store_put=corpus_tokens * store.token_bytes,
        superblocks=plan.num_superblocks,
    )
    block_stats = []
    blocks = list(plan.blocks)
    # staging prefetch: while block i builds, the worker stages the next
    # blocks (up to pipeline_depth ahead); staged volume is accounted on
    # this thread when a stage is collected
    prefetched: dict = {}

    def _submit_stages(next_i: int) -> None:
        if pipe is None:
            return
        for j in range(next_i, min(len(blocks), next_i + pipe.depth)):
            if j not in prefetched:
                prefetched[j] = pipe.submit(store.stage_read, *blocks[j])

    t_stage = t_build = 0.0
    for i, (lo, hi) in enumerate(blocks):
        t0 = time.perf_counter()
        task = prefetched.pop(i, None)
        if task is not None:
            pipeline_point("stage:collect")
            block = task.result()
            store.note_staged(lo, hi, block.nbytes)
        else:
            block = store.stage_items(lo, hi)
        _submit_stages(i + 1)
        t_stage += time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline_point("build:block")
        if plan.text_mode:
            res = build_suffix_array(block, cfg=cfg, device=dev)
            sa_b = res.suffix_array + lo
        else:
            lens_b = None if lengths is None else np.asarray(lengths)[lo:hi]
            res = build_suffix_array(block, lengths=lens_b, cfg=cfg, device=dev)
            sa_b = res.suffix_array + (np.int64(lo) << plan.stride_bits)
        local_sas.append(torch.from_numpy(sa_b).to(dev))
        bf = res.footprint
        fp.shuffle += bf.shuffle
        fp.fetch_request += bf.fetch_request
        fp.fetch_response += bf.fetch_response
        fp.rounds = max(fp.rounds, bf.rounds)
        fp.dropped += bf.dropped
        fp.peak_records = max(fp.peak_records, res.stats["num_suffixes"])
        block_stats.append(res.stats)
        t_build += time.perf_counter() - t0

    # ---- phase 3: boundary-exact merge via the store --------------------
    t_merge0 = time.perf_counter()
    samples = max(1, min(sb.samples_per_block,
                         plan.capacity_records // plan.num_superblocks))
    cap = plan.capacity_records
    pre_requests = store.requests
    total_suffixes = int(sum(r.shape[0] for r in local_sas))
    pair_lcp = None
    if sb.emit_lcp:
        # emit order is final order: each emitted suffix's LCP is one
        # adjacent compare against the previous one, served by the store
        def pair_lcp(a, b):
            return pairwise_lcp(store, a, b)

    sink = _OutputSink(total_suffixes, dev, pair_lcp=pair_lcp, executor=pipe)
    sinks.append(sink)
    peak_candidates = 0

    refiner: Optional[DeviceRefiner] = None
    if sb.merge_backend == "device":
        refiner = DeviceRefiner(
            original_corpus if isinstance(original_corpus, np.ndarray)
            else store.stage_items(0, backend.n),
            cfg, lengths=lengths, device=dev,
        )
        refine = refiner.refine
    else:
        def refine(g: torch.Tensor) -> torch.Tensor:
            return _refine_sort(store, g)

    if plan.text_mode:
        runs, risk = _split_boundary_risk(plan, local_sas, block_stats, store.k)
        bad = [risk] if risk.shape[0] else []
    else:
        # reads mode: block runs are exact, unless a block hit the
        # refinement hard cap; such blocks are re-ranked like a risk set
        runs = [r for r, st in zip(local_sas, block_stats, strict=True)
                if st.get("unresolved", 0) == 0]
        bad = [r for r, st in zip(local_sas, block_stats, strict=True)
               if st.get("unresolved", 0) != 0]
    pieces = []
    if bad:
        pieces = [p for p in _sorted_runs(store, torch.cat(bad), cap, samples, refine)
                  if p.shape[0]]
    if runs:
        peak_candidates = _merge_path_runs(
            store, runs + pieces, sink, cap, sb.merge_tile, cfg.use_pallas,
            refiner=refiner, executor=pipe,
        )
    else:
        # every suffix was at risk: the re-ranked pieces already are
        # consecutive intervals of the true order
        for p in pieces:
            sink.append(p)
    sa = sink.result()
    t_merge = time.perf_counter() - t_merge0

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
        # the k-way merge's cursor (item 9b) is not on this path
        "merge_cursor_peak_windows": 0,
        "block_rounds": [s["rounds"] for s in block_stats],
        "dropped": fp.dropped,
        "unresolved": sum(s["unresolved"] for s in block_stats),
        "store_backend": "memory",
        "corpus_bytes": backend.corpus_bytes,
        "peak_resident_bytes": fp.peak_resident_bytes,
        "store_cache_hits": backend.cache_hits,
        "store_cache_misses": backend.cache_misses,
        "store_cache_hit_rate": backend.hit_rate,
        # spills, the sanitizer, the journal and store retries are off on
        # this path (items 8 and 9b)
        "spilled_runs": 0,
        "spilled_bytes": 0,
        "emit_lcp": bool(sb.emit_lcp),
        "sanitized": False,
        "journaled": False,
        "journal_hits": 0,
        "store_retry_attempts": 0,
        "store_retried_calls": 0,
        "pipeline_depth": int(sb.pipeline_depth),
        "t_stage_s": round(t_stage, 6),
        "t_build_s": round(t_build, 6),
        "t_merge_s": round(t_merge, 6),
    }
    return SAResult(suffix_array=sa, footprint=fp, stats=stats, lcp=sink.lcp)


def build_suffix_array_auto(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    sb: Optional[SuperblockConfig] = None,
    device=None,
) -> SAResult:
    """Single-pass build when the record set fits one run (the launcher's
    policy); a plan of more blocks, an LCP array or a manifest goes through
    :func:`build_suffix_array_superblock`, as in ``repro``.  ``device`` as
    for :func:`repro_torch.core.pipeline.build_suffix_array`."""
    sb = sb or SuperblockConfig()
    plan = plan_superblocks(corpus_shape_of(corpus), cfg, sb)
    if plan.num_superblocks <= 1 and not (sb.emit_lcp or sb.write_manifest):
        if isinstance(corpus, StoreBackend):
            corpus = materialize_backend(corpus)
        return build_suffix_array(corpus, lengths=lengths, cfg=cfg, device=device)
    return build_suffix_array_superblock(corpus, lengths=lengths, cfg=cfg, sb=sb,
                                         device=device)
