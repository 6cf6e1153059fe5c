"""Plain PyTorch versions of the ported kernels.

Each is the function its CUDA kernel computes, written with tensor ops;
``ops`` routes CPU tensors here, and ``chip_smoke.py`` holds every kernel to
its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.search import masked_cmp


def prefix_pack_ref(tokens: torch.Tensor, cfg: SAConfig) -> torch.Tensor:
    """tokens (N,) -> keys (N, key_words); window i = tokens[i:i+K] 0-padded."""
    return encoding.pack_shifted(tokens, tokens.shape[0], cfg)


def window_gather_ref(corpus, rows, offs, k):
    """corpus (R, L), rows/offs (M,) -> (M, k) windows (``window_at``)."""
    return encoding.window_at(corpus, rows, offs, k)


def pattern_cmp_ref(sfx, pat, start, stop):
    """(B, K) suffix/pattern windows + (B,) [start, stop) token ranges ->
    (B, 2) int32 ``[cmp, matched]``, in int32 arithmetic as the JAX kernel
    (``repro.kernels.ref.pattern_cmp_ref``): the engine's plain compare on
    int32 inputs, ``matched`` cast back to int32 (the same wrap)."""
    cmp, matched = masked_cmp(*(t.to(torch.int32) for t in (sfx, pat, start, stop)))
    return torch.stack([cmp, matched.to(torch.int32)], dim=1)


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

