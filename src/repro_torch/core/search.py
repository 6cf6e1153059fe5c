"""Pattern matching over the constructed suffix array (``repro.core.search``).

The host-serial reference of the query path: suffix content is served by the
:class:`~repro_torch.core.store.CorpusStore` and compared as packed key words
(:func:`~repro_torch.core.store.pack_keys`), one pattern at a time.  The
batched, LCP-accelerated path is ``repro_torch.serve.sa_engine``; its compare
without the kernel is :func:`masked_cmp`.  The JAX package's deprecated
raw-array wrappers are ROADMAP.md item 11.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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
