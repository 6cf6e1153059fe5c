"""Plain PyTorch versions of the ported kernels.

Each is the function its CUDA kernel computes, written with tensor ops;
``ops`` routes CPU tensors here, and ``chip_smoke.py`` holds every kernel to
its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.search import bound_rounds, compare_level, compare_levels, masked_cmp
from repro_torch.core.store import padded_windows


def prefix_pack_ref(tokens: torch.Tensor, cfg: SAConfig) -> torch.Tensor:
    """tokens (N,) -> keys (N, key_words); window i = tokens[i:i+K] 0-padded."""
    return encoding.pack_shifted(tokens, tokens.shape[0], cfg)


def window_gather_ref(corpus, rows, offs, k):
    """corpus (R, L), rows/offs (M,) -> (M, k) windows (``window_at``)."""
    return encoding.window_at(corpus, rows, offs, k)


def _fold(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32 key words -> one int64 whose order is their lexicographic
    order: ``hi`` in the high word, ``lo`` with its sign bit flipped in the
    low word (the kernels' ``fold``)."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + (1 << 31))


def bucket_hist_ref(key_hi, key_lo, split_hi, split_lo):
    """keys (N,), splitters (D-1,) int32 -> (bucket (N,), hist (D,)) int32:
    ``bucket = #{splitters lexicographically < key}`` and its histogram
    (``repro.kernels.ref.bucket_hist_ref``).  One pass over the keys per
    splitter, so no (N, D-1) matrix is built."""
    keys = _fold(key_hi, key_lo)
    bucket = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    for s in _fold(split_hi, split_lo):
        bucket += keys > s
    hist = torch.bincount(bucket, minlength=split_hi.shape[0] + 1)
    return bucket, hist.to(torch.int32)


def bitonic_sort_tiles_ref(key_hi, key_lo, val, tile: int):
    """Each ``tile`` rows of (key_hi, key_lo, val) int32 sorted by the keys,
    ascending (``repro.kernels.ref.bitonic_sort_tiles_ref``): a stable sort
    of the tiles, the short last one padded with the largest key, so real
    rows keep the front of their tile and ties keep their input order."""
    n = key_hi.shape[0]
    ntiles = max(1, -(-n // tile))
    keys = torch.full((ntiles * tile,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=key_hi.device)
    keys[:n] = _fold(key_hi, key_lo)
    order = torch.sort(keys.view(ntiles, tile), dim=1, stable=True).indices
    order = (order + torch.arange(ntiles, device=keys.device)[:, None] * tile)
    order = order.reshape(-1)[:n]
    return tuple(t[order] for t in (key_hi, key_lo, val))


def pattern_cmp_ref(sfx, pat, start, stop):
    """(B, K) suffix/pattern windows + (B,) [start, stop) token ranges ->
    (B, 2) int32 ``[cmp, matched]``, in int32 arithmetic as the JAX kernel
    (``repro.kernels.ref.pattern_cmp_ref``): the engine's plain compare on
    int32 inputs, ``matched`` cast back to int32 (the same wrap)."""
    cmp, matched = masked_cmp(*(t.to(torch.int32) for t in (sfx, pat, start, stop)))
    return torch.stack([cmp, matched.to(torch.int32)], dim=1)


def pattern_cmp_level_ref(win, pos, t_in, t, pi, pat_len, pat_rows, cmp, nxt,
                          levels=None) -> None:
    """One window level of the engine's round loop, in place (the function
    of the ``pattern_cmp_level`` kernel): ``core.search.compare_level`` with
    the pattern tokens cut to int32, as the kernel cuts them and as
    ``repro``'s engine does on its kernel route (``pw.astype(np.int32)``)."""
    compare_level(win, pos, t_in, t, pi, pat_len, pat_rows, cmp, nxt, levels,
                  pat_dtype=torch.int32)


def _window_levels(padded: torch.Tensor, k: int) -> int:
    """The most K-token window levels one compare can take in a corpus
    zero-padded by K tokens (``CorpusStore.max_window_depth`` + 1)."""
    max_len = padded.shape[0] - k if padded.dim() == 1 else padded.shape[1] - k + 1
    return -(-max_len // k) + 3


def pattern_search_ref(padded, stride_bits, k, sa, llcp, rlcp, pat, plen, lo, hi,
                       upper: bool, rounds: int):
    """One Manber–Myers bound for every pattern row, as the engine's round
    loop finds it over ``compare_level``: the corpus zero-padded by K tokens
    (``InMemoryBackend.padded``; its dimension says text or reads), the SA and
    its LLCP/RLCP (both None: no LCP) int64, pattern rows (q, lmax) and
    lengths (q,) int64, the open ranges ``lo``/``hi`` (q,) int64 from the
    engine's routing, ``rounds`` the most search rounds a row can take.

    Returns ``(bound (q,) int64, levels (q, rounds) int32, active (q,)
    int32)``: ``levels[i, r]`` is the window levels row i compared in round
    r (0 where LLCP/RLCP decided it or the row was done), ``active[i]`` the
    rounds row i took.
    """
    q = pat.shape[0]
    levels = torch.zeros((q, rounds), dtype=torch.int32, device=sa.device)
    active = torch.zeros((q,), dtype=torch.int32, device=sa.device)
    max_levels = _window_levels(padded, k)

    def compare(gidx, t0, rows, lv):
        return compare_levels(
            lambda g, d: padded_windows(padded, stride_bits, k, *(
                torch.from_numpy(a).to(padded.device) for a in (g, d))),
            compare_level, gidx, pat, plen, t0, rows, k, max_levels, levels=lv)

    bound, _ = bound_rounds(sa, llcp, rlcp, lo.clone(), hi.clone(), upper, compare,
                            record=(levels, active))
    return bound, levels, active


# rows whose ranks merge_path_ranks_ref counts at once
RANK_CHUNK = 1024


def merge_path_ranks_ref(keys: torch.Tensor) -> torch.Tensor:
    """keys (C, W) int32 -> (C,) int32: ``rank(e) = #{c : row c < row e}``,
    lexicographic and strictly less (``repro.kernels.ref.merge_path_ranks_ref``).

    Counted over ``RANK_CHUNK`` rows at a time, so a full-size tile never
    builds a C x C matrix per word.
    """
    c, w = keys.shape
    out = torch.empty((c,), dtype=torch.int32, device=keys.device)
    for lo in range(0, c, RANK_CHUNK):
        mine = keys[lo : lo + RANK_CHUNK]
        lt = torch.zeros((mine.shape[0], c), dtype=torch.bool, device=keys.device)
        eq = torch.ones_like(lt)
        for j in range(w):
            a = mine[:, j][:, None]
            other = keys[:, j][None, :]
            lt |= eq & (other < a)
            eq &= other == a
        out[lo : lo + RANK_CHUNK] = lt.sum(dim=1).to(torch.int32)
    return out


def run_starts_ref(eq_prev: torch.Tensor) -> torch.Tensor:
    """Given eq_prev[i] = (row i equals row i-1), return start index of each
    run (``group id``): g[i] = i at run starts, propagated by cumulative max."""
    n = eq_prev.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=eq_prev.device)
    cand = torch.where(eq_prev, -1, idx)
    return torch.cummax(cand, dim=0).values


def run_groups_ref(keys, valid: torch.Tensor) -> torch.Tensor:
    """Group ids of runs of equal ``keys`` rows (padding rows stand alone)."""
    eq = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    same = valid[1:].clone()
    for key in keys:
        same &= key[1:] == key[:-1]
    eq[1:] = same
    return run_starts_ref(eq)
