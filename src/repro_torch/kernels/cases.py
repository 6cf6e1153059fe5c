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
