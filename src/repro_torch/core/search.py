"""Pattern matching over the constructed suffix array (``repro.core.search``).

The host-serial reference of the query path: suffix content is served by the
:class:`~repro_torch.core.store.CorpusStore` and compared as packed key words
(:func:`~repro_torch.core.store.pack_keys`), one pattern at a time.  The
batched, LCP-accelerated path is ``repro_torch.serve.sa_engine``; its compare
without the kernel is :func:`masked_cmp`, a window level of it
:func:`compare_level`.

The JAX package's raw-array signatures (``search_text``,
``count_occurrences``, ``find_occurrences``, ``align_reads``) remain as thin
deprecated wrappers that build a transient in-memory store per call, with
its ``DeprecationWarning``; they take the store's ``device`` (the card by
default).  No other module of the port calls them (salint SAL007).
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core.store import CorpusStore, lex_less_rows, pack_keys


def suffix_pattern_cmp(store: CorpusStore, gidx, pattern) -> torch.Tensor:
    """Batched trichotomy of suffixes against a pattern prefix.

    Returns (m,) int8 on the store's device: -1 suffix < pattern, +1 suffix
    > pattern, 0 the pattern is a prefix of the suffix.  Window levels are
    compared as packed key words, the suffix window masked to the pattern's
    remaining length; decided suffixes drop out of deeper fetch rounds.
    Pattern tokens must lie in ``1..cfg.vocab_size``.
    """
    dev = store.device
    gidx = torch.as_tensor(gidx, dtype=torch.int64, device=dev).reshape(-1)
    pat = np.asarray(pattern, np.int64).ravel()
    m = gidx.shape[0]
    res = torch.zeros(m, dtype=torch.int8, device=dev)
    if pat.size == 0 or m == 0:
        return res
    k = store.k
    undecided = torch.arange(m, device=dev)
    for lv in range(-(-pat.size // k)):
        if undecided.numel() == 0:
            break
        rem = min(k, pat.size - lv * k)
        pw = torch.zeros(k, dtype=torch.int64, device=dev)
        pw[:rem] = torch.from_numpy(pat[lv * k : lv * k + rem]).to(dev)
        pkey = pack_keys(pw[None, :], store.cfg)
        win = store.fetch_windows(gidx[undecided], lv)
        if rem < k:
            win = win.clone()
            win[:, rem:] = 0  # compare only the pattern's remaining tokens
        skey = pack_keys(win, store.cfg)
        lt, eq = lex_less_rows(skey, pkey.expand_as(skey))
        res[undecided[lt]] = -1
        res[undecided[~lt & ~eq]] = 1
        undecided = undecided[eq]
    return res


def masked_cmp(sfx: torch.Tensor, pat: torch.Tensor, start: torch.Tensor,
               stop: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise compare of suffix vs pattern windows over ``[start, stop)``.

    The tensor counterpart of ``repro.core.search.masked_cmp_np`` (the same
    function as the ``pattern_cmp`` kernel, in int64): ``(cmp, matched)``,
    int32 and int64.  The engine's compare when ``use_pallas`` is off.
    """
    sfx = sfx.to(torch.int64)
    pat = pat.to(torch.int64)
    b, k = sfx.shape
    start = start.to(torch.int64).expand(b)
    stop = stop.to(torch.int64).expand(b)
    iota = torch.arange(k, dtype=torch.int64, device=sfx.device)[None, :]
    in_rng = (iota >= start[:, None]) & (iota < stop[:, None])
    eq = torch.where(in_rng, sfx == pat, True)
    first = torch.where(eq, stop[:, None], iota).amin(dim=1)
    matched = first - start
    cols = torch.clamp(first, 0, k - 1)[:, None]
    sv = torch.take_along_dim(sfx, cols, dim=1)[:, 0]
    pv = torch.take_along_dim(pat, cols, dim=1)[:, 0]
    neq = first < stop
    cmp = torch.where(neq & (sv < pv), -1, torch.where(neq & (sv > pv), 1, 0))
    return cmp.to(torch.int32), matched


def compare_level(win: torch.Tensor, pos: torch.Tensor, t_in: torch.Tensor,
                  t: torch.Tensor, pi: torch.Tensor, pat_len: torch.Tensor,
                  pat_rows: torch.Tensor, cmp: torch.Tensor, nxt: torch.Tensor,
                  levels: Optional[torch.Tensor] = None,
                  pat_dtype: torch.dtype = torch.int64) -> None:
    """One window level of :func:`compare_levels`, in place on its row
    tensors.  A row ``i`` in play (``pos[i] >= 0``) compares its suffix
    window ``win[pos[i]]`` (level ``t_in[i] // K``) with pattern row
    ``pi[i]``'s window at that level over ``[start, stop)``
    (:func:`masked_cmp`); then ``t[i]`` is ``t_in[i]`` and the matched
    tokens, ``cmp[i]`` the result, ``nxt[i]`` is ``t[i]`` while the row is
    undecided (a tie short of ``pat_len[pi[i]]``: the next level's start)
    and -1 once decided, and ``levels[i]`` (when given) gains one.  When
    ``t_in`` is not ``t`` (the first level), every row out of play takes
    ``t = t_in``, ``cmp = 0`` and ``nxt = -1``; a later level passes ``t``
    as ``t_in`` and leaves such rows alone.  The pattern window is compared
    in ``pat_dtype``: int32 on the kernel route, which cuts the tokens as
    ``repro``'s kernel route does."""
    k = win.shape[1]
    idx = torch.nonzero(pos >= 0).squeeze(1)
    ti, pli = t_in[idx], pat_len[pi[idx]]
    if t_in is not t:
        t.copy_(t_in)
        cmp.zero_()
        nxt.fill_(-1)
    lv = ti // k
    start = ti - lv * k
    stop = torch.clamp(pli - lv * k, max=k)
    cols = lv[:, None] * k + torch.arange(k, dtype=torch.int64, device=win.device)[None, :]
    cc = torch.clamp(cols, max=pat_rows.shape[1] - 1)
    pw = torch.where(cols < pli[:, None], pat_rows[pi[idx][:, None], cc], 0)
    c, m_in = masked_cmp(win[pos[idx].long()], pw.to(pat_dtype), start, stop)
    tn = ti + m_in
    t[idx] = tn
    cmp[idx] = c
    nxt[idx] = torch.where((c == 0) & (tn < pli), tn, -1)
    if levels is not None:
        levels[idx] += 1


def compare_levels(fetch, level, gidx: torch.Tensor, pat_rows: torch.Tensor,
                   pat_len: torch.Tensor, t0: torch.Tensor, pi: torch.Tensor,
                   k: int, max_levels: int,
                   levels: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trichotomy of suffix ``gidx[i]`` against pattern row ``pi[i]``,
    ``t0[i]`` tokens already matched: one ``fetch(g, lv)`` of (m, k)
    windows (``g`` and ``lv`` (m,) int64 host arrays, the level's suffixes
    and window levels) and one ``level(win, pos, t_in, t, pi, pat_len,
    pat_rows, cmp, nxt, levels)`` (:func:`compare_level`'s contract) a
    window level still in play, at most ``max_levels`` levels.

    Returns ``(cmp, t)``: cmp in {-1, 0, +1}, 0 when the pattern is a
    prefix of the suffix, and t the matched tokens (at most the pattern's
    length).  ``levels``, when given, gains one for every level row i
    compares (the engine's ``pattern_search`` record).

    The rows in play are chosen on the host, where the fetch wants them:
    the call's suffixes, prefixes and pattern rows and lengths come over in
    one copy, and each level after the first reads back ``nxt``.  Every
    length in ``pat_len`` is at most ``pat_rows``' width, so no row compares
    more levels than that width spans: the last of those levels reads
    nothing back.
    """
    dev = gidx.device
    q = gidx.shape[0]
    host = torch.cat([gidx, t0, pi, pat_len]).cpu().numpy()
    g, start, pi_h = host[:q], host[q : 2 * q], host[2 * q : 3 * q]
    start = np.where(start < host[3 * q :][pi_h], start, -1)  # t0 == plen: matched
    t, nxt = torch.empty_like(t0), torch.empty_like(t0)
    cmp = torch.empty(q, dtype=torch.int32, device=dev)
    t_in = t0
    reach = -(-pat_rows.shape[1] // k)  # the window levels a pattern row spans
    n_levels = min(max_levels, reach)
    for n in range(n_levels):
        live = np.flatnonzero(start >= 0)
        if live.size == 0:
            break
        pos = np.full(q, -1, np.int32)
        pos[live] = np.arange(live.size, dtype=np.int32)
        win = fetch(g[live], start[live] // k)
        level(win, torch.from_numpy(pos).to(dev), t_in, t, pi, pat_len, pat_rows,
              cmp, nxt, levels)
        t_in = t
        if n + 1 < n_levels:
            start = nxt.to("cpu", copy=True).numpy()  # a copy on the CPU too
    else:
        if reach > max_levels:
            raise RuntimeError("batched compare overran the window bound")
    if t_in is t0:  # no row in play: every pattern matched already
        return torch.zeros(q, dtype=torch.int32, device=dev), t0.clone()
    return cmp, t


def bound_rounds(sa: torch.Tensor, llcp: Optional[torch.Tensor],
                 rlcp: Optional[torch.Tensor], lo: torch.Tensor, hi: torch.Tensor,
                 upper: bool, compare,
                 record: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, int]:
    """The Manber–Myers rounds of ``repro.serve.sa_engine.ShardedSAEngine.
    _bound_batch`` for every row at once, from the open ranges ``(lo, hi)``
    (updated in place).

    Open-endpoint invariant per row: ``l = lcp(P, sa[lo])``, ``r = lcp(P,
    sa[hi])``.  A round takes every row with ``hi - lo > 1``; LLCP/RLCP
    (when given) decide what they can and the rest go to one
    ``compare(gidx, t0, rows, lv) -> (cmp, t)`` (``lv`` the level counts of
    :func:`compare_levels`, or None).  ``record = (levels (q, R), rounds
    (q,))``, int32 zeros, is filled with each row's levels a round and its
    rounds.  Returns ``(hi, rounds)``: the bounds and the rounds made.
    """
    dev = sa.device
    l = torch.zeros_like(lo)
    r = torch.zeros_like(lo)
    use_lr = llcp is not None
    rnd = 0
    while True:
        act = torch.nonzero(hi - lo > 1).squeeze(1)
        if act.numel() == 0:
            return hi, rnd
        mid = (lo[act] + hi[act]) >> 1
        la, ra = l[act], r[act]
        right = torch.zeros(act.shape[0], dtype=torch.bool, device=dev)
        newl, newr = la.clone(), ra.clone()
        if use_lr:
            ne = la != ra
            x = torch.where(la > ra, llcp[mid], rlcp[mid])
            mx = torch.maximum(la, ra)
            gt, ltm = ne & (x > mx), ne & (x < mx)
            c1, c2 = la > ra, ra > la
            # x beyond the deeper endpoint's agreement: mid sides with
            # that endpoint (l/r carry over); x short of it: mid sides
            # against it and its own lcp is exactly x.
            right |= c1 & gt
            newr = torch.where(c1 & ltm, x, newr)
            right |= c2 & ltm
            newl = torch.where(c2 & ltm, x, newl)
            need = ~(gt | ltm)
            t0 = torch.where(ne, mx, la)  # proven-equal prefix at the mid
        else:
            need = torch.ones(act.shape[0], dtype=torch.bool, device=dev)
            t0 = torch.minimum(la, ra)
        ni = torch.nonzero(need).squeeze(1)
        if ni.numel():
            lv = None if record is None else torch.zeros(
                ni.shape[0], dtype=torch.int32, device=dev)
            c, t = compare(sa[mid[ni]], t0[ni], act[ni], lv)
            if record is not None:
                record[0][act[ni], rnd] = lv
            re = (c <= 0) if upper else (c < 0)
            right[ni] = re
            newl[ni] = torch.where(re, t, newl[ni])
            newr[ni] = torch.where(re, newr[ni], t)
        lo[act] = torch.where(right, mid, lo[act])
        hi[act] = torch.where(right, hi[act], mid)
        l[act] = torch.where(right, newl, la)
        r[act] = torch.where(right, ra, newr)
        if record is not None:
            record[1][act] += 1
        rnd += 1


def search_store(store: CorpusStore, sa, pattern) -> Tuple[int, int]:
    """[lo, hi) range of SA rows whose suffixes start with ``pattern``.

    Out-of-vocab pattern tokens match nothing: the search runs on the
    longest in-vocab prefix and collapses to an empty range at the right
    insertion point.
    """
    pat = np.asarray(pattern, np.int64).ravel()
    n = len(sa)
    if pat.size == 0:
        return 0, n
    bad = np.flatnonzero((pat < 1) | (pat > store.cfg.vocab_size))
    if bad.size:
        j = int(bad[0])
        prefix = pat[:j]
        if pat[j] > store.cfg.vocab_size:
            # every suffix extending `prefix` continues with a smaller token
            hi = _bound(store, sa, prefix, upper=True) if j else n
            return hi, hi
        lo = _bound(store, sa, prefix, upper=False) if j else 0
        return lo, lo
    return (_bound(store, sa, pat, upper=False),
            _bound(store, sa, pat, upper=True))


def _bound(store: CorpusStore, sa, pat: np.ndarray, upper: bool) -> int:
    lo, hi = 0, len(sa)
    while lo < hi:
        mid = (lo + hi) // 2
        c = int(suffix_pattern_cmp(store, sa[mid : mid + 1], pat)[0])
        if c < 0 or (upper and c == 0):
            lo = mid + 1
        else:
            hi = mid
    return lo


def count_store(store: CorpusStore, sa, pattern) -> int:
    lo, hi = search_store(store, sa, pattern)
    return hi - lo


def locate_store(store: CorpusStore, sa, pattern) -> np.ndarray:
    """Sorted (ascending) global indexes of every occurrence (host int64)."""
    lo, hi = search_store(store, sa, pattern)
    occ = sa[lo:hi]
    if isinstance(occ, torch.Tensor):
        occ = occ.cpu().numpy()
    return np.sort(np.asarray(occ, np.int64))


# ---------------------------------------------------------------------------
# deprecated raw-array wrappers (build a transient in-memory store per call)
# ---------------------------------------------------------------------------


def _wrapper_store(corpus: np.ndarray, device) -> CorpusStore:
    vocab = int(corpus.max()) if corpus.size else 1
    return CorpusStore(np.asarray(corpus, np.int32),
                       SAConfig(vocab_size=max(vocab, 1)), device=device)


def _warn_deprecated(name: str, alt: str) -> None:
    # stacklevel=3: _warn_deprecated -> wrapper -> the caller's frame
    warnings.warn(
        f"{name} is deprecated: it rebuilds a transient in-memory store per "
        f"call (accounting-invisible, O(corpus) per query). Use {alt} or "
        f"SuffixArrayIndex instead.",
        DeprecationWarning, stacklevel=3)


def search_text(text: np.ndarray, sa: np.ndarray, pattern,
                device=None) -> Tuple[int, int]:
    """Deprecated: use :func:`search_store` (or ``SuffixArrayIndex``)."""
    _warn_deprecated("search_text", "search_store")
    return search_store(_wrapper_store(np.asarray(text), device), sa, pattern)


def count_occurrences(text: np.ndarray, sa: np.ndarray, pattern,
                      device=None) -> int:
    """Deprecated: use :func:`count_store` (or ``SuffixArrayIndex``)."""
    _warn_deprecated("count_occurrences", "count_store")
    lo, hi = search_store(_wrapper_store(np.asarray(text), device), sa, pattern)
    return hi - lo


def find_occurrences(text: np.ndarray, sa: np.ndarray, pattern,
                     device=None) -> List[int]:
    """Deprecated: use :func:`locate_store` (or ``SuffixArrayIndex``)."""
    _warn_deprecated("find_occurrences", "locate_store")
    lo, hi = search_store(_wrapper_store(np.asarray(text), device), sa, pattern)
    return sorted(int(p) for p in np.asarray(sa)[lo:hi])


def align_reads(
    reads: np.ndarray,
    sa_gidx: np.ndarray,
    stride_bits: int,
    pattern,
    device=None,
) -> List[Tuple[int, int]]:
    """Seed-alignment lookup over a read-set SA (the paper's bioinformatics
    application): all (read_id, offset) whose suffix starts with pattern.

    Deprecated wrapper: builds a transient store; the caller's
    ``stride_bits`` packing is translated to the store's own when they
    differ, so pre-existing SAs keep working unchanged.
    """
    _warn_deprecated("align_reads", "search_store over a reads-mode store")
    reads = np.asarray(reads, np.int32)
    store = _wrapper_store(reads, device)
    sa = np.asarray(sa_gidx, np.int64)
    mask = (1 << stride_bits) - 1
    row, off = sa >> stride_bits, sa & mask
    sa_cmp = sa if stride_bits == store.stride_bits else (
        (row << store.stride_bits) | off)
    lo, hi = search_store(store, sa_cmp, pattern)
    return sorted((int(r), int(o)) for r, o in zip(row[lo:hi], off[lo:hi],
                                                   strict=True))
