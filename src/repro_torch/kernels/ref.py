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
