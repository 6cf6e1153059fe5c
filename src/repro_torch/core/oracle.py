"""Host-side reference suffix-array constructions (numpy test oracles).

A copy of ``naive_sa_reads``, ``naive_sa_text``, ``doubling_sa_text`` and
``lcp_kasai`` from ``repro.core.oracle``, so the port and ``chip_smoke.py``
check results without importing the JAX package.

* :func:`naive_sa_reads` — exact paper semantics (Table I): every suffix of
  every read (including the ``$``-only suffix), sorted lexicographically with
  shorter-prefix-first tie order, stable by global index.
* :func:`naive_sa_text` — all suffixes of one token stream.
* :func:`doubling_sa_text` — O(n log^2 n) Manber–Myers with np.lexsort, for
  medium-size inputs where the naive oracle is too slow.
* :func:`lcp_kasai` — Kasai's LCP array of a token stream's SA (the dedup
  application's LCP).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def naive_sa_reads(
    reads: np.ndarray, lengths: Optional[np.ndarray] = None, stride_bits: int = 0
) -> np.ndarray:
    """Returns int64 global indexes ``(read_id << stride_bits) | offset`` in
    sorted suffix order."""
    reads = np.asarray(reads)
    r, l = reads.shape
    if lengths is None:
        lengths = np.full((r,), l, np.int64)
    if stride_bits == 0:
        stride_bits = int(np.ceil(np.log2(l + 1)))
    entries = []
    for i in range(r):
        n = int(lengths[i])
        row = reads[i, :n]
        for o in range(n + 1):  # include the $-only suffix (paper Table I)
            entries.append((tuple(int(t) for t in row[o:]), (i << stride_bits) | o))
    entries.sort()
    return np.array([g for _, g in entries], np.int64)


def naive_sa_text(text: np.ndarray) -> np.ndarray:
    text = np.asarray(text)
    n = len(text)
    entries = sorted((tuple(int(t) for t in text[o:]), o) for o in range(n))
    return np.array([o for _, o in entries], np.int64)


def doubling_sa_text(text: np.ndarray) -> np.ndarray:
    """Classic prefix-doubling with numpy lexsort."""
    text = np.asarray(text, np.int64)
    n = len(text)
    rank = text.copy()
    k = 1
    while True:
        # pad with -1, not 0: re-ranking is 0-based, so a 0 pad collides
        # with the smallest suffix's rank and two suffixes can tie forever
        rank2 = np.full(n, -1, np.int64)
        if k < n:
            rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        new = np.zeros(n, np.int64)
        r_o, r2_o = rank[order], rank2[order]
        neq = np.ones(n, bool)
        neq[1:] = (r_o[1:] != r_o[:-1]) | (r2_o[1:] != r2_o[:-1])
        new[order] = np.cumsum(neq) - 1
        rank = new
        if rank.max() == n - 1:
            return np.argsort(rank, kind="stable").astype(np.int64)
        k *= 2
        if k >= 2 * n:  # safety
            return np.argsort(rank, kind="stable").astype(np.int64)


def lcp_kasai(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai's LCP construction: lcp[i] = LCP(suffix sa[i-1], suffix sa[i])."""
    text = np.asarray(text)
    n = len(text)
    rank = np.zeros(n, np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, np.int64)
    h = 0
    for i in range(n):
        if rank[i] > 0:
            j = sa[rank[i] - 1]
            while i + h < n and j + h < n and text[i + h] == text[j + h]:
                h += 1
            lcp[rank[i]] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp
