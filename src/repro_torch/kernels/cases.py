"""The kernel-test shapes and inputs, in one place.

The shapes are those of ``tests/test_kernels.py``.  The port's CPU tests,
its ``gpu``-marked tests and ``chip_smoke.py`` all draw their small kernel
cases from here, so the three sweeps cannot drift apart.
"""
from __future__ import annotations

import numpy as np

PACK_CFGS = [  # SAConfig keyword sets
    dict(vocab_size=4, packing="base"),
    dict(vocab_size=4, packing="bits"),
    dict(vocab_size=4, chars_per_word=3, key_words=2, packing="base"),
    dict(vocab_size=255, packing="bits"),
]
PACK_IDS = [f"{c['packing']}-v{c['vocab_size']}-cpw{c.get('chars_per_word', 0)}"
            for c in PACK_CFGS]
PACK_LENGTHS = [1, 63, 512, 1300]
PACK_BLOCK = 256
# prefix_pack's edges: lengths that are no multiple of a thread's 8
# positions or of a tile (PACK_BLOCK or 512 positions), tokens as views that
# start 1 and 2 tokens into their storage, tokens outside [0, 2^bits)
PACK_EDGE = ("n7", "n9", "n2047", "n2049", "n6151", "view1", "view2", "wide")
GATHER_SHAPES = [(8, 16, 5, 4), (32, 200, 64, 26), (3, 7, 17, 7)]  # (r, l, m, k)
GATHER_EDGE = ("m257", "m1000", "m1", "k1", "k40", "k100", "k1000", "rows-out",
               "offs-at-l", "last-row-end", "r0", "l0", "view-odd-l",
               "view-misaligned")
CMP_SHAPES = [(1, 4, 8), (100, 8, 32), (700, 6, 256)]  # (n, k, block)
CMP_EDGE_K = (6, 40)  # window widths of the edge-row cases
# pattern_cmp_level: the cases (random rows, and the edge rows of
# ``level_case``) and the window widths they run at (40: two 32-column chunks)
LEVEL_CASES = ("random", "edge")
LEVEL_K = (4, 6, 40)
MERGE_SHAPES = [(5, 2, 8), (100, 4, 32), (700, 3, 256), (256, 6, 128)]  # (c, w, block)
MERGE_EDGE = ("duplicates", "w1", "w64", "c1", "ragged", "negative", "int32-max")
# merge tiles built as sorted runs, as the merge builds them: R runs (20
# fills a warp with one row's searches, 33 is past that branch), and edge
# tiles
MERGE_RUNS = (1, 2, 4, 8, 20, 33)
MERGE_RUN_EDGE = ("c-1-runs", "deep-ties", "equal-across-runs", "ragged-runs")
HIST_SHAPES = [(100, 4), (2048, 64), (999, 256), (7, 2)]  # (n, d)
HIST_BLOCK = 256
HIST_EDGE = ("unsorted", "repeated", "d1", "max-splitters", "one-hot")
SORT_SHAPES = [(16, 16), (100, 64), (1024, 256), (5, 8)]  # (n, tile)
INT32_MAX = int(np.iinfo(np.int32).max)
# the smallest inputs on which the Pallas kernels differ from
# ``repro.kernels.ref`` (ROADMAP.md section 3): keys at int32 max, where
# their int32-max padding collides with real data
HIST_FAULT = dict(  # bucket_hist, block 8
    key_hi=[1, 5, INT32_MAX, 3, INT32_MAX], key_lo=[2, 0, INT32_MAX, 1, INT32_MAX],
    split_hi=[2, INT32_MAX], split_lo=[0, INT32_MAX], block=8)
SORT_FAULT = dict(  # bitonic_sort_tiles, tile 8
    key_hi=[INT32_MAX, 1, INT32_MAX], key_lo=[INT32_MAX, 0, INT32_MAX],
    val=[7, 8, 9], tile=8)
# bitonic_sort_tiles' edge cases: name -> (n, tile, keys, offset).  keys:
# "small" in [0, 50) as ``sort_inputs`` draws them, "wide" over all of
# int32, "equal" one key for every row, "extremes" from int32 min, -1, 0, 1
# and int32 max with the last rows real (int32 max, int32 max) rows of a
# short tile; an offset puts every column that many elements into its
# storage (a view the 16-byte path cannot take)
SORT_EDGE = {
    "tile1": (1000, 1, "small", 0),
    "tile2": (1001, 2, "small", 0),
    "tile4": (1003, 4, "small", 0),
    "tile4096-ragged": (3 * 4096 + 1234, 4096, "wide", 0),
    "tile2^16-ragged": (2 * 65536 + 777, 1 << 16, "wide", 0),
    "tile2^20-ragged": ((1 << 20) + 4099, 1 << 20, "wide", 0),
    "tile-above-n": (3, 1 << 16, "small", 0),
    "tile-above-n-large": (100_000, 1 << 20, "wide", 0),
    "all-equal": (5000, 1024, "equal", 0),
    "extremes-short": (2 * 1024 + 700, 1024, "extremes", 0),
    "extremes-short-8192": (3 * 8192 + 100, 8192, "extremes", 0),
    "view1": (3000, 1024, "small", 1),
    "view3-tile2^16": (70_001, 1 << 16, "wide", 3),
}
# tiles above the old 2048 limit that the CPU tests hold to the JAX package
SORT_LARGE = [(5000, 4096), (3, 65536), (70000, 65536)]  # (n, tile)


def pack_tokens(kw: dict, n: int) -> np.ndarray:
    """(n,) int32 tokens in [1, vocab_size], seeded by ``n``."""
    rng = np.random.default_rng(n)
    return rng.integers(1, kw["vocab_size"] + 1, size=(n,)).astype(np.int32)


def pack_edge_tokens(kw: dict, name: str):
    """(tokens, offset) of a ``PACK_EDGE`` case: the tokens to pack are
    ``tokens[offset:]`` (a view past the storage's first ``offset``)."""
    if name.startswith("n"):
        return pack_tokens(kw, int(name[1:])), 0
    if name.startswith("view"):
        return pack_tokens(kw, 4099), int(name[4:])
    toks = pack_tokens(kw, 5000)  # wide: in a few tiles, the rest without
    toks[[7, 100, 2050]] = (-5, kw["vocab_size"] + 9, 1 << 30)
    return toks, 0


def gather_inputs(r: int, l: int, m: int):
    """corpus (r, l) and rows/offs (m,) int32, out-of-range rows and offsets
    included, seeded by ``r * l``."""
    rng = np.random.default_rng(r * l)
    corpus = rng.integers(1, 5, size=(r, l)).astype(np.int32)
    rows = rng.integers(-1, r + 1, size=(m,)).astype(np.int32)
    offs = rng.integers(0, l + 2, size=(m,)).astype(np.int32)
    return corpus, rows, offs


def gather_edge_inputs(name: str, device="cpu"):
    """corpus (R, L), rows, offs (M,) int32 tensors on ``device`` and k,
    beyond ``gather_inputs``' shapes (the kernel gathers a tile of 64
    requests a block, 16 bytes a load where the corpus allows):

    - m257 / m1000 / m1: M not a multiple of the tile, and one request;
    - k1 / k40 / k100 / k1000: one column, windows wider than 32 and 64
      tokens, and one so wide that a tile holds only 28 requests;
    - rows-out: every row outside [0, R), int32's ends among them;
    - offs-at-l: offsets at L and L + 1, negative and int32 max;
    - last-row-end: every window in the corpus's last row, near its end;
    - r0 / l0: R = 0 and L = 0 (R·L = 0);
    - view-odd-l: rows 1.. of a (40, 7) corpus, a view whose base lies 28
      bytes into its storage;
    - view-misaligned: a (30, 8) corpus that starts one token into a flat
      tensor: L % 4 == 0, but the base is not 16-byte aligned.

    Seeded by the case."""
    import torch

    rng = np.random.default_rng(6000 + GATHER_EDGE.index(name))
    r, l, m, k = {"m257": (50, 200, 257, 26), "m1000": (64, 200, 1000, 26),
                  "m1": (8, 200, 1, 26), "k1": (16, 200, 300, 1),
                  "k40": (16, 200, 300, 40), "k100": (16, 200, 300, 100),
                  "k1000": (16, 200, 100, 1000),
                  "rows-out": (10, 200, 300, 26), "offs-at-l": (10, 200, 300, 26),
                  "last-row-end": (12, 200, 300, 26), "r0": (0, 200, 40, 26),
                  "l0": (16, 0, 40, 26), "view-odd-l": (39, 7, 300, 10),
                  "view-misaligned": (30, 8, 300, 26)}[name]
    corpus = rng.integers(1, 5, size=(r, l)).astype(np.int32)
    rows = rng.integers(-1, r + 1, size=(m,)).astype(np.int32)
    offs = rng.integers(0, l + 2, size=(m,)).astype(np.int32)
    if name == "rows-out":
        rows = rng.choice(np.array([-1, r, r + 1, -INT32_MAX - 1, INT32_MAX]),
                          size=m).astype(np.int32)
    if name == "offs-at-l":
        offs = rng.choice(np.array([l, l + 1, -1, -7, INT32_MAX, l - 1]),
                          size=m).astype(np.int32)
    if name == "last-row-end":
        rows[:] = r - 1
        offs = rng.integers(l - k - 4, l + 2, size=(m,)).astype(np.int32)
    c = torch.from_numpy(corpus).to(device)
    if name == "view-odd-l":
        c = torch.from_numpy(np.concatenate([corpus[:1], corpus])).to(device)[1:]
    if name == "view-misaligned":
        flat = np.concatenate([[9], corpus.reshape(-1)]).astype(np.int32)
        c = torch.from_numpy(flat).to(device)[1:].view(r, l)
    return c, torch.from_numpy(rows).to(device), torch.from_numpy(offs).to(device), k


GATHER_CASES = [*GATHER_SHAPES, *GATHER_EDGE]
GATHER_LARGE = (4096, 200, 1 << 20, 26)  # random requests, on the card only
GATHER_IDS = ["-".join(map(str, c)) if isinstance(c, tuple) else c
              for c in GATHER_CASES]


def gather_case(case, device="cpu"):
    """(corpus, rows, offs, k) tensors of a ``GATHER_CASES`` entry."""
    if isinstance(case, str):
        return gather_edge_inputs(case, device)
    import torch

    r, l, m, k = case
    return (*(torch.from_numpy(a).to(device) for a in gather_inputs(r, l, m)), k)


def cmp_inputs(n: int, k: int):
    """sfx, pat (n, k) and start, stop (n,) int32 as ``tests/test_kernels.py``
    draws them: random [start, stop) ranges within the window, empty and
    full ones included, and pattern rows that mostly agree with the suffix
    rows so the first mismatch lands mid-range.  Seeded by ``n + k``."""
    rng = np.random.default_rng(n + k)
    sfx = rng.integers(0, 5, size=(n, k)).astype(np.int32)
    pat = rng.integers(0, 5, size=(n, k)).astype(np.int32)
    pat = np.where(rng.random((n, k)) < 0.6, sfx, pat)
    start = rng.integers(0, k, size=(n,)).astype(np.int32)
    stop = np.minimum(start + rng.integers(0, k + 1, size=(n,)), k).astype(np.int32)
    return sfx, pat, start, stop


def cmp_edge_inputs(k: int):
    """Rows outside the kernel test's ``0 <= start <= stop <= k``: start >
    stop, stop > k, negative start and stop, padding rows, and negative,
    zero and large tokens; k = 40 needs two 32-column chunks.  Seeded by
    ``k``."""
    rng = np.random.default_rng(1000 + k)
    n = 64
    sfx = rng.integers(-3, 3, size=(n, k)).astype(np.int32)
    sfx[::7] = rng.integers(-(2**31), 2**31 - 1, size=(len(sfx[::7]), k))
    pat = np.where(rng.random((n, k)) < 0.8, sfx,
                   rng.integers(-3, 3, size=(n, k))).astype(np.int32)
    pat[3] = sfx[3]  # a row with no mismatch at all
    lo = rng.integers(-k, 2 * k, size=(n,))
    hi = rng.integers(-k, 2 * k, size=(n,))
    start, stop = lo.astype(np.int32), hi.astype(np.int32)
    start[:4], stop[:4] = 0, 0  # padding rows
    start[4], stop[4] = k - 1, k + 9  # stop past the window
    start[5], stop[5] = 5, 2  # start > stop
    start[6], stop[6] = -4, k  # negative start
    start[7], stop[7] = 0, k  # whole window
    pat[7, k - 1] = sfx[7, k - 1] + 1  # a mismatch in the last column
    return sfx, pat, start, stop


def level_case(name: str, k: int, q: int = 300):
    """Suffixes and patterns for the engine's window levels
    (``ops.pattern_cmp_level``): ``suffix`` (q, 3k) int32, row g the tokens
    of suffix g (0 past its end; a window level at or past 3 is all 0),
    pattern rows ``pat_rows`` (q_pat, lmax) and lengths ``plen`` (q_pat,)
    int64, and per row its pattern ``pi`` and proven-equal prefix ``t0``
    (q,) int64.  Patterns mostly copy their suffix from ``t0`` on, so first
    mismatches land at every level.  ``"random"`` draws ``q`` rows; ``"edge"``
    is 17 rows: ``t0 == plen`` (at and off a level boundary), patterns
    ending mid-level and at a level's end, a pattern longer than the deepest
    window level (its suffix's windows end in 0s), ``t0`` at a level
    boundary and at a level's last column, pattern tokens of 2^31 and up (cut
    to int32: 2^31 + 5 below every suffix token, 2^32 + 3 equal to a 3), a
    pattern as long as ``lmax``, a negative suffix token, an empty pattern,
    two rows sharing a pattern, a pattern no row compares, a suffix that
    ends inside the deepest level, and a row tied at every level its
    pattern spans (0s past the suffix's end).  Seeded by ``k`` and ``q``."""
    rng = np.random.default_rng(4000 + 7 * k + q)
    depth = 3 * k
    if name == "random":
        suffix = rng.integers(1, 5, size=(q, depth)).astype(np.int32)
        ends = rng.integers(1, depth + 1, size=q)
        suffix[np.arange(depth)[None, :] >= ends[:, None]] = 0
        plen = rng.integers(1, depth + k, size=q).astype(np.int64)
        t0 = (rng.random(q) * (plen + 1)).astype(np.int64)  # t0 == plen too
        lmax = int(plen.max())
        pat = np.zeros((q, lmax), np.int64)
        for g in range(q):
            src = np.concatenate([suffix[g], np.zeros(k, np.int32)])
            row = rng.integers(1, 5, size=lmax)
            run = rng.integers(0, depth + k)  # how far the copy runs
            upto = min(plen[g], depth + k, run + t0[g] + 1)
            row[:upto] = np.where(src[:upto] > 0, src[:upto], row[:upto])
            pat[g, : plen[g]] = row[: plen[g]]
        pi = rng.permutation(q).astype(np.int64)
        # row i compares suffix pi[i] with pattern pi[i]: rows and patterns
        # in different orders
        return dict(suffix=suffix[pi], pat_rows=pat, plen=plen, pi=pi, t0=t0[pi])
    rows = 17
    suffix = rng.integers(1, 5, size=(rows, depth)).astype(np.int32)
    pats, t0, pi = [], np.zeros(rows, np.int64), np.arange(rows, dtype=np.int64)

    def copy(g, n, tail=()):
        return np.concatenate([suffix[g, :n].astype(np.int64), tail]).astype(np.int64)

    pats.append(copy(0, 2 * k))
    t0[0] = 2 * k  # t0 == plen at a level boundary
    pats.append(copy(1, k + 1))
    t0[1] = k + 1  # t0 == plen off it
    pats.append(copy(2, k + k // 2))  # ends mid-level: a prefix of its suffix
    pats.append(copy(3, 2 * k))  # ends at a level's end
    t0[3] = k - 1
    pats.append(copy(4, 3 * k, [1] * (k + 3)))  # runs past every level
    t0[4] = 2 * k
    pats.append(copy(5, 3 * k))
    t0[5] = k  # a level boundary: start 0 on level 1
    pats.append(copy(6, 2 * k))
    t0[6] = 2 * k - 1  # the level's last column
    pats.append(copy(7, 1, [2**31 + 5]))  # cut to int32: below every token
    suffix[8, 1] = 3
    pats.append(copy(8, 1, [2**32 + 3, 9]))  # cut to 3: matches, then 9 > it
    pats.append(copy(9, 3 * k, [2]))  # the longest pattern: lmax columns
    suffix[10, 0] = -7
    pats.append(np.array([(-7) + 2**32, 1], np.int64))  # cut to -7: equal
    pats.append(np.zeros(0, np.int64))  # empty: plen 0 == t0
    pats.append(copy(12, k // 2 + 1))
    suffix[13], pi[13] = suffix[12], 12  # row 13 shares row 12's pattern
    pats.append(np.array([3], np.int64))  # a pattern no row compares
    pats.append(copy(14, 2 * k, [4, 4]))
    t0[14] = 1
    suffix[15, 3 * k - 1] = 0  # suffix 15 ends inside the deepest level
    pats.append(copy(15, 3 * k - 1))
    pats[-1][-1] = 5  # a mismatch at its last token, above every token
    t0[15] = 2 * k + 1
    pats.append(copy(16, 3 * k, [0] * (k + 3)))  # tied at every level, lmax long
    plen = np.array([p.size for p in pats], np.int64)
    pat = np.zeros((len(pats), max(1, int(plen.max()))), np.int64)
    for i, p in enumerate(pats):
        pat[i, : p.size] = p
    return dict(suffix=suffix, pat_rows=pat, plen=plen, pi=pi, t0=t0)


def level_windows(suffix: np.ndarray, gidx: np.ndarray, lv: np.ndarray,
                  k: int) -> np.ndarray:
    """(m, k) int32 windows of ``level_case`` suffixes ``gidx`` at levels
    ``lv``: 0 past a suffix's tokens."""
    width = suffix.shape[1]
    cols = np.asarray(lv, np.int64)[:, None] * k + np.arange(k)[None, :]
    rows = np.asarray(gidx, np.int64)[:, None]
    return np.where(cols < width, suffix[rows, np.minimum(cols, width - 1)],
                    0).astype(np.int32)


def level_args(case: dict, k: int):
    """One ``ops.pattern_cmp_level`` call's arguments, numpy, from a
    ``level_case``, as a compare's first level: every row in play at level
    ``t0 // k`` (``t0 == plen`` rows too) but every seventh, which is out of
    play (``pos`` -1), the windows in a shuffled order; ``t``, ``cmp`` and
    ``nxt`` start as junk.  Returns ``(win, pos, t_in, t, pi, pat_len,
    pat_rows, cmp, nxt, levels)``; a later level passes ``t`` as ``t_in``."""
    q = case["t0"].shape[0]
    rng = np.random.default_rng(q + k)
    live = np.flatnonzero(np.arange(q) % 7 != 3)
    pos = np.full(q, -1, np.int32)
    pos[live] = rng.permutation(live.size)
    t_in = case["t0"].copy()
    win = np.zeros((live.size, k), np.int32)
    win[pos[live]] = level_windows(case["suffix"], live, t_in[live] // k, k)
    return (win, pos, t_in, rng.integers(0, 9, size=q), case["pi"], case["plen"],
            case["pat_rows"], rng.integers(-2, 3, size=q).astype(np.int32),
            rng.integers(-1, 9, size=q), rng.integers(0, 5, size=q).astype(np.int32))


def merge_inputs(c: int, w: int) -> np.ndarray:
    """(c, w) int32 keys as ``tests/test_kernels.py`` draws them: heavy ties
    in words 0..w-2, a permutation in the last word (strictly unique rows).
    Seeded by ``c + w``."""
    rng = np.random.default_rng(c + w)
    keys = rng.integers(0, 4, size=(c, w)).astype(np.int32)
    keys[:, -1] = rng.permutation(c).astype(np.int32)
    return keys


def merge_edge_inputs(name: str) -> np.ndarray:
    """Key matrices beyond the kernel test's unique rows (any int32 input:
    ranks count the rows strictly less, duplicates included):

    - duplicates: many equal rows;
    - w1 / w64: one word, and 64 words that tie deep;
    - c1: a single row;
    - ragged: C = 1000, not a multiple of any CTA size;
    - negative: negative words mixed with positive ones;
    - int32-max: words of ``int32`` max and min (the JAX kernel's padding
      value appears as real data).
    """
    rng = np.random.default_rng(2000 + MERGE_EDGE.index(name))
    if name == "duplicates":
        base = rng.integers(0, 3, size=(40, 3)).astype(np.int32)
        return np.concatenate([base, base, base[:17]])
    if name == "w1":
        return rng.integers(-5, 5, size=(300, 1)).astype(np.int32)
    if name == "w64":
        keys = np.ones((200, 64), np.int32)
        keys[:, 40:] = rng.integers(0, 2, size=(200, 24))
        return keys
    if name == "c1":
        return rng.integers(0, 9, size=(1, 5)).astype(np.int32)
    if name == "ragged":
        return rng.integers(0, 3, size=(1000, 4)).astype(np.int32)
    if name == "negative":
        return rng.integers(-3, 3, size=(500, 3)).astype(np.int32)
    big = np.iinfo(np.int32)
    keys = rng.choice(np.array([big.min, -1, 0, 1, big.max], np.int32),
                      size=(333, 4))
    return keys.astype(np.int32)


def merge_runs(keys: np.ndarray) -> int:
    """The number of runs of a key matrix: row i starts one when i = 0 or
    row i is lexicographically below row i-1 (the kernel's rule)."""
    if keys.shape[0] == 0:
        return 0
    a, b = keys[1:].astype(np.int64), keys[:-1].astype(np.int64)
    diff = a != b
    first = np.argmax(diff, axis=1)  # first differing word (0 if none)
    rows = np.arange(a.shape[0])
    below = diff.any(axis=1) & (a[rows, first] < b[rows, first])
    return 1 + int(below.sum())


def _sorted_runs(rows: np.ndarray, lengths) -> np.ndarray:
    """``rows`` cut into consecutive runs of ``lengths``, each sorted."""
    out, at = [], 0
    for n in lengths:
        run = rows[at : at + n]
        out.append(run[np.lexsort(run.T[::-1])])
        at += n
    return np.concatenate(out).astype(np.int32)


def merge_runs_inputs(r: int) -> np.ndarray:
    """A merge tile of ``r`` sorted runs of uneven length (about 150 rows
    each, 40 for r = 33): heavy ties in words 0..2, a zero index-high word
    and a permutation in the last word (unique rows).  Seeded by ``r``."""
    rng = np.random.default_rng(3000 + r)
    per = 40 if r > 8 else 150
    lengths = rng.integers(per // 2, per * 3 // 2, size=r)
    c = int(lengths.sum())
    rows = np.zeros((c, 5), np.int64)
    rows[:, :3] = rng.integers(0, 4, size=(c, 3))
    rows[:, 4] = rng.permutation(c)
    keys = _sorted_runs(rows, lengths)
    assert merge_runs(keys) == r
    return keys


def merge_run_edge_inputs(name: str) -> np.ndarray:
    """Tiles of sorted runs at their edges:

    - c-1-runs: 300 rows, descending but for one ascending pair (299 runs,
      the kernel's many-runs branch);
    - deep-ties: 4 runs whose rows tie on words 0..8 across runs, as the
      neighbouring suffixes of a real reads tile do (W = 12);
    - equal-across-runs: 3 runs drawn from a pool of 20 rows, so equal rows
      sit within and across runs (duplicates: ranks count strictly less);
    - ragged-runs: C = 1001 in runs of 1, 2, 37, 500 and 461 rows.
    """
    rng = np.random.default_rng(4000 + MERGE_RUN_EDGE.index(name))
    if name == "c-1-runs":
        rows = rng.permutation(300)[:, None] * np.array([1, 0, 1]) + np.array([0, 7, 0])
        keys = rows[np.lexsort(rows.T[::-1])][::-1].astype(np.int32)
        keys[[0, 1]] = keys[[1, 0]]
        runs = 299
    elif name == "deep-ties":
        lengths = (200, 180, 220, 190)
        rows = np.full((sum(lengths), 12), 1234567, np.int64)
        rows[:, 9:11] = rng.integers(0, 3, size=(sum(lengths), 2))
        rows[:, 10] -= 1  # a negative word among them
        rows[:, 11] = rng.permutation(sum(lengths))
        keys, runs = _sorted_runs(rows, lengths), len(lengths)
    elif name == "equal-across-runs":
        pool = rng.integers(-2, 3, size=(20, 3))
        lengths = (100, 90, 110)
        keys = _sorted_runs(pool[rng.integers(0, 20, size=sum(lengths))], lengths)
        runs = len(lengths)
    else:
        lengths = (1, 2, 37, 500, 461)
        rows = np.zeros((sum(lengths), 4), np.int64)
        rows[:, :2] = rng.integers(0, 5, size=(sum(lengths), 2))
        rows[:, 3] = rng.permutation(sum(lengths))
        rows[0, :2] = 9  # the one-row run lies above the next run's first row
        keys, runs = _sorted_runs(rows, lengths), len(lengths)
    assert merge_runs(keys) == runs
    return keys


def hist_inputs(n: int, d: int):
    """key_hi, key_lo (n,) and split_hi, split_lo (d-1,) int32 as
    ``tests/test_kernels.py`` draws them: 20-bit words, splitters sorted by
    their high word only.  Seeded by ``n + d``."""
    rng = np.random.default_rng(n + d)
    kh = rng.integers(0, 1 << 20, size=(n,)).astype(np.int32)
    kl = rng.integers(0, 1 << 20, size=(n,)).astype(np.int32)
    sh = np.sort(rng.integers(0, 1 << 20, size=(d - 1,))).astype(np.int32)
    sl = rng.integers(0, 1 << 20, size=(d - 1,)).astype(np.int32)
    return kh, kl, sh, sl


def hist_edge_inputs(name: str):
    """key_hi, key_lo (n,) and split_hi, split_lo (d-1,) int32 beyond the
    sorted splitters of ``hist_inputs`` (the kernels take any splitters):

    - unsorted: 63 splitters in random order;
    - repeated: 31 splitters drawn from 5 values, keys on them too;
    - d1: no splitter (D = 1), every key in bucket 0;
    - max-splitters: ``MAX_SPLITTERS`` splitters (D = 4096);
    - one-hot: every key equal, so one bucket holds them all.

    n is odd throughout (no multiple of 4).  Seeded by the case."""
    from repro_torch.kernels.bucket_hist import MAX_SPLITTERS

    rng = np.random.default_rng(5000 + HIST_EDGE.index(name))
    n, d = {"unsorted": (1001, 64), "repeated": (999, 32), "d1": (101, 1),
            "max-splitters": (5003, MAX_SPLITTERS + 1), "one-hot": (3001, 16)}[name]
    kh = rng.integers(-(1 << 20), 1 << 20, size=(n,))
    kl = rng.integers(-(1 << 20), 1 << 20, size=(n,))
    sh = rng.integers(-(1 << 20), 1 << 20, size=(d - 1,))
    sl = rng.integers(-(1 << 20), 1 << 20, size=(d - 1,))
    if name == "repeated":
        vals = rng.integers(-3, 3, size=(5, 2))
        sh, sl = vals[rng.integers(0, 5, size=d - 1)].T
        kh, kl = vals[rng.integers(0, 5, size=n)].T
        kl = kl + rng.integers(-1, 2, size=n)  # on, just below and above them
    if name == "one-hot":
        kh, kl = np.full(n, sh[3]), np.full(n, sl[3] + 1)
    return tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (kh, kl, sh, sl))


def sort_inputs(n: int, tile: int):
    """key_hi, key_lo, val (n,) int32 as ``tests/test_kernels.py`` draws
    them: keys in [0, 50) (many ties), values a permutation.  Seeded by
    ``n + tile``."""
    rng = np.random.default_rng(n + tile)
    kh = rng.integers(0, 50, size=(n,)).astype(np.int32)
    kl = rng.integers(0, 50, size=(n,)).astype(np.int32)
    v = rng.permutation(n).astype(np.int32)
    return kh, kl, v


def sort_edge_inputs(name: str):
    """key_hi, key_lo, val (n,) int32 of a ``SORT_EDGE`` case, its tile and
    offset; values a permutation.  Seeded by the case's n + tile."""
    n, tile, keys, offset = SORT_EDGE[name]
    rng = np.random.default_rng(n + tile)
    if keys == "small":
        return (*sort_inputs(n, tile), tile, offset)
    if keys == "wide":
        kh, kl = (rng.integers(-2**31, 2**31, size=(n,)).astype(np.int32)
                  for _ in range(2))
    elif keys == "equal":
        kh, kl = np.full(n, 7, np.int32), np.full(n, -7, np.int32)
    else:
        ext = np.array([-INT32_MAX - 1, -1, 0, 1, INT32_MAX], np.int32)
        kh, kl = rng.choice(ext, size=n), rng.choice(ext, size=n)
        kh[-5:] = kl[-5:] = INT32_MAX
    return kh, kl, rng.permutation(n).astype(np.int32), tile, offset


def fault_arrays(case: dict):
    """The int32 arrays of a fault case, and its block/tile."""
    arrays = {k: np.asarray(v, np.int32) for k, v in case.items()
              if k not in ("block", "tile")}
    return arrays, case.get("block", case.get("tile"))


def sorted_rows(kh, kl, v):
    """(n, 3) rows in (key_hi, key_lo, val) order, on the tensors' device:
    two outputs of a tile sort that agree on the keys row for row hold the
    same values within each key group exactly when their ``sorted_rows``
    are equal."""
    import torch

    rows = torch.stack([kh, kl, v], 1)
    for col in (2, 1, 0):  # a lexsort as chained stable sorts
        rows = rows[torch.sort(rows[:, col], stable=True).indices]
    return rows


# pattern_search: corpora, patterns and a config with K = 4 tokens a window
# level, so that short corpora take many levels
SEARCH_CFG = dict(vocab_size=3, chars_per_word=2, key_words=2)
SEARCH_K = 4
SEARCH_CORPORA = ("random text", "repetitive text", "variable reads")


def search_corpus(name: str):
    """(corpus, SA) of a ``SEARCH_CORPORA`` kind; a suffix in each ends
    exactly at a window boundary (the text's length and two reads' lengths
    are multiples of K), and the reads hold a duplicate."""
    from repro_torch.core.oracle import naive_sa_reads, naive_sa_text

    rng = np.random.default_rng(17)
    if name == "random text":
        text = rng.integers(1, 4, 240).astype(np.int32)
        return text, naive_sa_text(text)
    if name == "repetitive text":
        text = np.tile(rng.integers(1, 3, 6).astype(np.int32), 30)[:176]
        return text, naive_sa_text(text)
    lens = rng.integers(1, 14, 20)
    lens[:3] = (13, 8, 4)
    reads = np.zeros((20, 13), np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.integers(1, 4, n)
    reads[3] = reads[0]
    return reads, naive_sa_reads(reads, lengths=lens)


def search_patterns(corpus: np.ndarray, seed: int = 3):
    """Random substrings and the boundary patterns: lengths 0, 1, K-1, K,
    K+1, 2K and longer than any suffix, a suffix that ends at a window
    boundary with the pattern running on, tokens below 1 and above the
    vocabulary, a pattern twice in the batch."""
    k = SEARCH_K
    rng = np.random.default_rng(seed)
    flat = corpus.reshape(-1)
    rows = corpus if corpus.ndim == 2 else corpus[None, :]
    pats = [flat[s : s + m].astype(np.int64)
            for s, m in zip(rng.integers(0, flat.size - 3 * k, 24),
                            rng.integers(1, 3 * k, 24), strict=True)]
    for m in (1, k - 1, k, k + 1, 2 * k):
        start = int(rng.integers(0, rows.shape[1] - m + 1))
        pats.append(rows[0, start : start + m].astype(np.int64))
    if corpus.ndim == 1:
        ends = flat[flat.size - 2 * k :]  # the suffix ending on a boundary
    else:
        ends = corpus[1, :8]  # read 1 holds 8 tokens: two whole levels
    pats += [
        np.concatenate([ends, [1]]).astype(np.int64),
        ends.astype(np.int64),
        np.zeros(0, np.int64),
        np.array([9], np.int64),
        np.array([0], np.int64),
        np.array([-2, 1], np.int64),
        np.concatenate([flat, [1]]).astype(np.int64),
        np.concatenate([flat[flat > 0], [1]]).astype(np.int64),
        pats[0].copy(),
    ]
    return pats


def padded_patterns(pats):
    """The live patterns as the engine pads them (tokens >= 1, or empty):
    (rows (q, lmax), lengths (q,)) int64."""
    live = [p for p in pats if p.size == 0 or p.min() >= 1]
    lmax = max(1, max(p.size for p in live))
    rows = np.zeros((len(live), lmax), np.int64)
    for i, p in enumerate(live):
        rows[i, : p.size] = p
    return rows, np.array([p.size for p in live], np.int64)


def search_args(engine, pats, upper: bool):
    """``ops.pattern_search``'s arguments for one bound of the live ``pats``
    on a ``ShardedSAEngine`` over an in-memory store: its padded corpus, SA,
    LLCP/RLCP and round bound, and each row's range from the engine's
    routing."""
    import torch

    rows, plen = (torch.from_numpy(a).to(engine.device)
                  for a in padded_patterns(pats))
    shard = engine._route(rows, plen, upper)
    st = engine.store
    return (st.backend.padded, st.stride_bits, st.k, engine.sa, engine._llcp,
            engine._rlcp, rows, plen, engine._bounds[shard] - 1,
            engine._bounds[shard + 1], upper, engine._max_rounds)


# run_groups: the kernel scans tiles of RUN_TILE rows, 16 a thread (the
# wrapper's TILE_ROWS).  Each case runs in every mode: 0 to 3 key columns
# with a valid mask ("w0"-"w3", ``run_groups``), or given flags
# (``run_starts``): "eq" with eq[0] false, as its callers give it, and
# "eq-lead" with eq[0] true, so that the rows before the first start read -1
RUN_TILE = 4096
RUN_GROUPS_LENGTHS = {
    "n0": 0, "n1": 1, "n2": 2,
    "tile-1": RUN_TILE - 1, "tile": RUN_TILE, "tile+1": RUN_TILE + 1,
    "ragged": 3 * RUN_TILE + 2055,  # no multiple of a thread's 16 rows
    "one-run": 300 * RUN_TILE + 5,  # one run over every tile
    "distinct": 5 * RUN_TILE + 3,  # every row a run of its own
    "pad-end": 4 * RUN_TILE + 9,  # invalid rows at the end
    "pad-middle": 4 * RUN_TILE + 9,  # and in the middle
    "view1": 2 * RUN_TILE + 5,  # arrays 1 element into their storage
    "view3": 2 * RUN_TILE + 5,  # and 3
}
RUN_GROUPS_CASES = tuple(RUN_GROUPS_LENGTHS)
RUN_GROUPS_MODES = ("w0", "w1", "w2", "w3", "eq", "eq-lead")
RUN_GROUPS_LARGE = 1 << 27  # rows of the card's large case, in mode "w3"


def run_keys(r, w: int, to_int32):
    """w int32 key columns of rows with run ids ``r`` (int64, numpy or
    torch): column c hashes ``r >> (w - 1 - c)`` (an odd multiplier mod
    2^32 is a bijection), so the rows of a run are equal in every column,
    and neighbouring runs may differ in the last column alone."""
    return [to_int32(((r >> (w - 1 - c)) * 2654435761 + 7 * c) & 0xFFFFFFFF)
            for c in range(w)]


def run_groups_arrays(name: str, mode: str):
    """(keys, flags, offset) of a ``RUN_GROUPS_CASES`` case in a mode:
    numpy int32 key columns (none in the eq modes), the bool valid mask or eq
    flags, and the offset into their storage at which the tests view them."""
    n = RUN_GROUPS_LENGTHS[name]
    rng = np.random.default_rng(RUN_GROUPS_CASES.index(name))
    if name == "one-run":
        r = np.zeros(n, np.int64)
    elif name == "distinct":
        r = np.arange(n, dtype=np.int64)
    else:  # runs of mean length 4, and a few of several tiles
        start = rng.random(n) < 0.25
        for a in rng.integers(0, max(n, 1), size=max(n // (2 * RUN_TILE), 1)):
            start[a + 1 : a + int(rng.integers(RUN_TILE, 3 * RUN_TILE))] = False
        r = np.cumsum(start).astype(np.int64)
    valid = rng.random(n) >= 0.02 if name != "one-run" else np.ones(n, bool)
    if name.startswith("pad"):  # padding rows: equal keys, each its own run
        pad = slice(n - 1000, n) if name == "pad-end" else slice(n // 3, n // 3 + 1000)
        r[pad], valid[pad] = r[pad.start], False
        if name == "pad-end":
            r[pad] = r.max() + 1
    offset = int(name[4:]) if name.startswith("view") else 0
    if mode.startswith("eq"):
        eq = np.zeros(n, bool)
        eq[1:] = (r[1:] == r[:-1]) & valid[1:]
        if n and mode == "eq-lead":
            eq[0] = True
        return [], eq, offset
    return run_keys(r, int(mode[1:]), lambda a: a.astype(np.int32)), valid, offset


def run_groups_tensors(name: str, mode: str, device="cpu"):
    """``run_groups_arrays`` as tensors on ``device``, each a view
    ``offset`` elements into its storage."""
    import torch

    keys, flags, off = run_groups_arrays(name, mode)

    def view(a):
        t = torch.from_numpy(a).to(device)
        return torch.cat([t.new_zeros(off), t])[off:] if off else t

    return [view(k) for k in keys], view(flags)


def run_groups_eq(keys, flags, mode: str) -> np.ndarray:
    """The eq flags a case's ids are the run starts of, by numpy: the flags
    themselves in the eq modes, else ``eq[0]`` false and ``eq[i] = valid[i]
    &`` every column equal to row i - 1's."""
    flags = np.asarray(flags)
    if mode.startswith("eq"):
        return flags
    eq = np.zeros(flags.shape[0], bool)
    eq[1:] = flags[1:]
    for k in keys:
        k = np.asarray(k)
        eq[1:] &= k[1:] == k[:-1]
    return eq
