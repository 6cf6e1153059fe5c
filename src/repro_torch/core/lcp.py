"""LCP arrays served by the corpus store (``repro.core.lcp``).

``lcp[i] = LCP(suffix SA[i-1], suffix SA[i])``, the companion array the query
engine derives its LLCP/RLCP bounds from.  Both functions fetch K-token
windows from the :class:`~repro_torch.core.store.CorpusStore` on its device,
one batched fetch per window depth still in play, and stop at the first token
mismatch or the first position where both windows carry the padding ``0``.
The store's traffic counters grow exactly as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.store import CorpusStore


def pairwise_lcp(store: CorpusStore, a, b) -> torch.Tensor:
    """Elementwise LCP of suffix pairs ``(a[i], b[i])`` (global indexes).

    Pairs that resolved drop out of deeper rounds.  Returns (m,) int64 token
    counts on the store's device.
    """
    dev = store.device
    a = torch.as_tensor(a, dtype=torch.int64, device=dev).reshape(-1)
    b = torch.as_tensor(b, dtype=torch.int64, device=dev).reshape(-1)
    assert a.shape == b.shape, (tuple(a.shape), tuple(b.shape))
    m = a.shape[0]
    out = torch.zeros(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    live = torch.arange(m, device=dev)
    k = store.k
    for depth in range(store.max_window_depth):
        if live.numel() == 0:
            return out
        wa = store.fetch_windows(a[live], depth)
        wb = store.fetch_windows(b[live], depth)
        stop = (wa != wb) | ((wa == 0) & (wb == 0))
        resolved = stop.any(dim=1)
        first = stop.to(torch.uint8).argmax(dim=1)
        out[live] += torch.where(resolved, first, k)
        live = live[~resolved]
    if live.numel():
        raise RuntimeError("pairwise LCP overran the window bound")
    return out


def lcp_from_sa(store: CorpusStore, sa, batch: int = 1 << 16) -> np.ndarray:
    """Full LCP array of a sorted SA: ``lcp[0] = 0``,
    ``lcp[i] = LCP(sa[i-1], sa[i])``, computed over ``batch``-sized slices
    of adjacent pairs.  Returns a host int64 array, as the JAX package does;
    the pairs are compared on the store's device."""
    sa = torch.as_tensor(sa, dtype=torch.int64, device=store.device)
    n = sa.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=store.device)
    for lo in range(1, n, batch):
        hi = min(lo + batch, n)
        out[lo:hi] = pairwise_lcp(store, sa[lo - 1 : hi - 1], sa[lo:hi])
    return out.cpu().numpy()
