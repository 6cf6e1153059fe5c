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
GATHER_SHAPES = [(8, 16, 5, 4), (32, 200, 64, 26), (3, 7, 17, 7)]  # (r, l, m, k)
CMP_SHAPES = [(1, 4, 8), (100, 8, 32), (700, 6, 256)]  # (n, k, block)
CMP_EDGE_K = (6, 40)  # window widths of the edge-row cases
MERGE_SHAPES = [(5, 2, 8), (100, 4, 32), (700, 3, 256), (256, 6, 128)]  # (c, w, block)
MERGE_EDGE = ("duplicates", "w1", "w64", "c1", "ragged", "negative", "int32-max")


def pack_tokens(kw: dict, n: int) -> np.ndarray:
    """(n,) int32 tokens in [1, vocab_size], seeded by ``n``."""
    rng = np.random.default_rng(n)
    return rng.integers(1, kw["vocab_size"] + 1, size=(n,)).astype(np.int32)


def gather_inputs(r: int, l: int, m: int):
    """corpus (r, l) and rows/offs (m,) int32, out-of-range rows and offsets
    included, seeded by ``r * l``."""
    rng = np.random.default_rng(r * l)
    corpus = rng.integers(1, 5, size=(r, l)).astype(np.int32)
    rows = rng.integers(-1, r + 1, size=(m,)).astype(np.int32)
    offs = rng.integers(0, l + 2, size=(m,)).astype(np.int32)
    return corpus, rows, offs


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

