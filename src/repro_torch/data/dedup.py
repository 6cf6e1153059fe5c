"""Exact-substring deduplication through the suffix array (the port of
``repro.data.dedup``).

The flagship application of the pipeline inside an LM framework (Lee et al.
2021 style): build the SA over the tokenized corpus, derive the LCP array,
and every LCP >= threshold names a repeated substring; later occurrences
get masked out of the training loss (or removed).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import SAConfig
from repro_torch.core.oracle import lcp_kasai
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.core.prefix_doubling import build_suffix_array_doubling


def find_duplicate_spans(
    tokens: np.ndarray,
    min_len: int = 32,
    cfg: Optional[SAConfig] = None,
    device=None,
    mode: str = "scheme",
) -> List[Tuple[int, int, int]]:
    """Repeated substrings of length >= min_len.

    Returns [(pos_a, pos_b, length)] for adjacent SA entries with
    LCP >= min_len (pos_a = earlier occurrence).  ``mode`` is ``"scheme"``
    or ``"doubling"``; ``device`` as for the builders (``None`` is the card).
    """
    cfg = cfg or SAConfig(vocab_size=int(tokens.max()))
    if mode == "doubling":
        res = build_suffix_array_doubling(tokens, cfg=cfg, device=device)
    else:
        res = build_suffix_array(tokens, cfg=cfg, device=device)
    sa = res.suffix_array
    lcp = lcp_kasai(tokens, sa)
    out = []
    for i in range(1, len(sa)):
        if lcp[i] >= min_len:
            a, b = int(sa[i - 1]), int(sa[i])
            if a > b:
                a, b = b, a
            out.append((a, b, int(lcp[i])))
    return out


def dedup_corpus(
    tokens: np.ndarray,
    min_len: int = 32,
    cfg: Optional[SAConfig] = None,
    device=None,
    mode: str = "scheme",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Mask later occurrences of repeated substrings.

    Returns (tokens, keep_mask, stats).  keep_mask[i] = False where position
    i belongs to a duplicated span whose earlier copy survives.
    """
    spans = find_duplicate_spans(tokens, min_len, cfg, device, mode)
    keep = np.ones(len(tokens), bool)
    masked = 0
    # greedy: keep the earlier occurrence, mask the later one
    for _src, b, l in sorted(spans, key=lambda s: s[1]):
        if keep[b : b + l].any():
            masked += int(keep[b : b + l].sum())
            keep[b : b + l] = False
    stats = {
        "num_spans": len(spans),
        "masked_tokens": masked,
        "masked_fraction": masked / max(len(tokens), 1),
    }
    return tokens, keep, stats
