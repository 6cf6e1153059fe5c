"""Corpus synthesis (numpy copies of ``repro.data.corpus``).

Two corpus kinds mirror the two SA pipeline modes:
  * DNA read sets (the paper's grouper-genome workload): (R, L) int32 with
    A=1 C=2 G=3 T=4, 0 = $/padding — includes paired-end generation;
  * token streams with planted duplicates for the dedup application.

The same seed gives the same corpus as the JAX package's synthesizers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DNA_VOCAB = 4  # A,C,G,T (0 reserved for $)


def synth_dna_reads(
    num_reads: int,
    read_len: int = 200,
    seed: int = 0,
    paired_end: bool = False,
    genome_len: Optional[int] = None,
) -> np.ndarray:
    """Reads sampled from one synthetic genome (overlapping suffixes, like
    real sequencing data).  paired_end=True returns both directions
    concatenated — the paper's two input files."""
    rng = np.random.default_rng(seed)
    g = genome_len or max(4 * read_len, num_reads * read_len // 16)
    genome = rng.integers(1, DNA_VOCAB + 1, size=(g,)).astype(np.int32)
    starts = rng.integers(0, g - read_len, size=(num_reads,))
    idx = starts[:, None] + np.arange(read_len)[None, :]
    fwd = genome[idx]
    if not paired_end:
        return fwd
    rev = fwd[:, ::-1].copy()
    return np.concatenate([fwd, rev], axis=0)


def synth_token_corpus(
    length: int,
    vocab: int,
    seed: int = 0,
    dup_fraction: float = 0.0,
    dup_span: int = 64,
) -> Tuple[np.ndarray, list]:
    """Token stream in [1, vocab] with planted duplicate spans.

    Returns (tokens, planted) where planted = [(src, dst, span), ...]:
    tokens[dst:dst+span] was copied from tokens[src:src+span].
    """
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab + 1, size=(length,)).astype(np.int32)
    planted = []
    n_dups = int(length * dup_fraction / max(dup_span, 1))
    for _ in range(n_dups):
        src = int(rng.integers(0, length - dup_span))
        dst = int(rng.integers(0, length - dup_span))
        if abs(dst - src) < dup_span:
            continue
        toks[dst : dst + dup_span] = toks[src : src + dup_span]
        planted.append((src, dst, dup_span))
    return toks, planted

