"""The benchmark's one corpus generator, frozen.

``synth_dna_reads`` and ``synth_token_corpus`` are copies of the program's
generators (``repro_torch.data.corpus``) as they stood when this benchmark
was written, so a later change to the program cannot move the yardstick;
``sa_bench/tests`` holds the two equal at small sizes.  :func:`make_corpus`
reads a configuration's corpus keys and draws the cell's one corpus from
the run's seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

DNA_VOCAB = 4  # A, C, G, T as 1..4; 0 is $ / padding


def synth_dna_reads(num_reads: int, read_len: int = 200, seed: int = 0,
                    genome_len: Optional[int] = None) -> np.ndarray:
    """(num_reads, read_len) int32 reads sampled from one random genome of
    ``genome_len`` bases (default: 16x coverage)."""
    rng = np.random.default_rng(seed)
    g = genome_len or max(4 * read_len, num_reads * read_len // 16)
    genome = rng.integers(1, DNA_VOCAB + 1, size=(g,)).astype(np.int32)
    starts = rng.integers(0, g - read_len, size=(num_reads,))
    idx = starts[:, None] + np.arange(read_len)[None, :]
    return genome[idx]


def synth_token_corpus(length: int, vocab: int, seed: int = 0,
                       dup_fraction: float = 0.0, dup_span: int = 64):
    """(tokens, planted): a token stream in [1, vocab] with planted
    duplicate spans; ``tokens[dst:dst+span]`` is a copy of
    ``tokens[src:src+span]`` for each ``(src, dst, span)`` in ``planted``."""
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


def rng_seed(seed: int) -> int:
    """A run's ``--seed`` as numpy takes it: any whole number, negative ones
    folded into 64 bits."""
    return seed % (1 << 64)


def make_corpus(conf: dict, seed: int) -> np.ndarray:
    """The corpus a configuration describes, from ``seed``:
    ``corpus_kind`` ``"dna_reads"`` (``num_reads``, ``read_len``,
    ``coverage``) gives (R, L) reads, ``"text"`` (``length``, ``vocab``,
    ``dup_fraction`` and ``dup_span`` optional) a 1-D token stream."""
    seed = rng_seed(seed)
    kind = conf["corpus_kind"]
    if kind == "dna_reads":
        r, l = int(conf["num_reads"]), int(conf["read_len"])
        genome = max(4 * l, r * l // int(conf["coverage"]))
        return synth_dna_reads(r, l, seed=seed, genome_len=genome)
    if kind == "text":
        toks, _ = synth_token_corpus(int(conf["length"]), int(conf["vocab"]), seed=seed,
                                     dup_fraction=float(conf.get("dup_fraction", 0.0)),
                                     dup_span=int(conf.get("dup_span", 64)))
        return toks
    raise ValueError(f"unknown corpus_kind {kind!r}")


def suffix_count(corpus: np.ndarray) -> int:
    """Suffixes a build of ``corpus`` sorts: every position of a text; every
    offset of every read and its ``$``-only suffix."""
    if corpus.ndim == 1:
        return int(corpus.shape[0])
    r, l = corpus.shape
    return int(r * (l + 1))
