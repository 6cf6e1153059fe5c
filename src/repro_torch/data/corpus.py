"""Corpus synthesis (numpy copies of ``repro.data.corpus``).

Two corpus kinds mirror the two SA pipeline modes:
  * DNA read sets (the paper's grouper-genome workload): (R, L) int32 with
    A=1 C=2 G=3 T=4, 0 = $/padding — includes paired-end generation;
  * token streams with planted duplicates for the dedup application.

The same seed gives the same corpus as the JAX package's synthesizers;
``flatten_reads_with_separators`` and ``pack_sequences`` are copied too.
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


def flatten_reads_with_separators(
    reads: np.ndarray, lengths: Optional[np.ndarray] = None
) -> np.ndarray:
    """Flatten an (R, L) read set into one token stream with a ``0`` ($)
    separator after every read.

    Text-mode SA builders (prefix doubling) construct the SA of one token
    stream; a bare ``reads.reshape(-1)`` would let suffixes run across read
    boundaries.  The separator sorts before every real token (tokens are
    ``>= 1``), so no pattern of real tokens can match across a boundary and
    substring queries agree with the read-set semantics.
    """
    reads = np.asarray(reads, np.int32)
    r, l = reads.shape
    if lengths is None:
        out = np.zeros((r, l + 1), np.int32)
        out[:, :l] = reads
        return out.reshape(-1)
    parts = []
    for i in range(r):
        parts.append(reads[i, : int(lengths[i])])
        parts.append(np.zeros(1, np.int32))
    return np.concatenate(parts)


def pack_sequences(tokens: np.ndarray, seq_len: int, batch: int) -> np.ndarray:
    """Pack a token stream into (num_batches, batch, seq_len) LM examples."""
    per = seq_len * batch
    n = len(tokens) // per
    return tokens[: n * per].reshape(n, batch, seq_len)
