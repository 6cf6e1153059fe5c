"""The plain reference: a suffix array by prefix doubling, in plain PyTorch.

It imports nothing of the program under test.  It gives the suffix array
the program promises (the paper's Table I semantics):

* a read set (R, L) of tokens 1..V has R * (L + 1) suffixes, each read's
  suffixes at every offset and its ``$``-only suffix; suffix ``(i, o)`` is
  named ``i << stride_bits | o`` with ``stride_bits = ceil(log2(L + 1))``;
* a text (n,) has n suffixes, named by their position;
* suffixes sort lexicographically, ``$`` (and the end of a text) before
  every token, a proper prefix first; equal suffixes by name.

Method: every suffix's rank among its first ``h`` tokens, doubled each pass
from the rank of its first token by one sort of (rank, rank ``h`` further)
pairs, until the ranks cover the longest suffix or are all distinct; then a
stable sort of the ranks in name order.  Rank 0 stands for "past the end".

:func:`first_key_order` is the control: the same order taken over the first
``tokens`` tokens alone (a single 31-bit key word holds 13 tokens of a
4-letter alphabet with ``$``), ties by name, the way a build that skipped
every refinement round would order them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _grid(corpus: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens, names): the corpus as a (rows, width) int64 grid, a read's
    ``$`` a 0 in its last column, and each cell's suffix name."""
    t = torch.from_numpy(np.ascontiguousarray(corpus, dtype=np.int32)).to(device)
    if t.dim() == 1:
        n = t.shape[0]
        return t.long()[None, :], torch.arange(n, dtype=torch.int64, device=device)[None, :]
    r, l = t.shape
    grid = torch.zeros((r, l + 1), dtype=torch.int64, device=device)
    grid[:, :l] = t
    del t
    stride_bits = max(1, math.ceil(math.log2(l + 1)))
    names = ((torch.arange(r, dtype=torch.int64, device=device)[:, None] << stride_bits)
             | torch.arange(l + 1, dtype=torch.int64, device=device)[None, :])
    return grid, names


def _shifted(x: torch.Tensor, h: int) -> torch.Tensor:
    """``x`` moved ``h`` columns left within each row, 0 past the row end."""
    out = torch.zeros_like(x)
    if h < x.shape[1]:
        out[:, : x.shape[1] - h] = x[:, h:]
    return out


def _dense_rank(key: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Ranks 1, 2, ... of ``key``'s distinct values in order, and the
    largest."""
    flat = key.reshape(-1)
    skey, perm = torch.sort(flat)
    del flat
    step = torch.ones_like(skey)
    step[1:] = skey[1:] != skey[:-1]
    del skey
    ranks = torch.cumsum(step, 0)
    del step
    top = int(ranks[-1])
    out = torch.empty_like(ranks)
    out[perm] = ranks
    return out.reshape(key.shape), top


def _order(rank: torch.Tensor, names: torch.Tensor) -> torch.Tensor:
    """Names sorted by rank, equal ranks by name (names ascend in the
    grid's row-major order)."""
    perm = torch.sort(rank.reshape(-1), stable=True).indices
    return names.reshape(-1)[perm]


def suffix_array(corpus: np.ndarray, device="cpu") -> torch.Tensor:
    """The suffix array of ``corpus`` as int64 names on ``device``."""
    rank, names = _grid(corpus, device)
    width = rank.shape[1]
    count = rank.numel()
    rank, top = _dense_rank(rank)
    covered = 1
    while covered < width and top < count:
        key = rank * (top + 1) + _shifted(rank, covered)
        del rank
        rank, top = _dense_rank(key)
        del key
        covered *= 2
    return _order(rank, names)


def first_key_order(corpus: np.ndarray, device="cpu", tokens: int = 13) -> torch.Tensor:
    """The control: suffixes ordered by their first ``tokens`` tokens only,
    ties by name."""
    grid, names = _grid(corpus, device)
    base = int(grid.max()) + 1
    key = torch.zeros_like(grid)
    for c in range(tokens):
        key = key * base + _shifted(grid, c)
    del grid
    return _order(key, names)
