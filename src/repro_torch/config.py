"""Suffix-array configuration of the port.

Copies of ``repro.config.SAConfig`` and ``repro.config.SuperblockConfig``
with the same fields, defaults and derived values
(``tests/test_torch_config.py`` holds them together).
``use_pallas`` keeps its name: in the port it selects the hand-written
CUDA kernels instead of their plain PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional


@dataclass(frozen=True)
class SAConfig:
    """Configuration for suffix-array construction (see ``repro.config``).

    ``mode``: ``"scheme"`` (the paper's index-only shuffle with on-demand
    window fetches), ``"terasort"`` (the paper's baseline,
    ``core/terasort.py``) or ``"doubling"`` (prefix doubling over the rank
    store, ``core/prefix_doubling.py``); each mode is its own builder.
    """

    mode: str = "scheme"
    vocab_size: int = 5  # $,A,C,G,T
    # tokens packed per 31-bit key word; 0 => derive max from vocab
    chars_per_word: int = 0
    key_words: int = 2
    packing: str = "base"  # base (paper-faithful) | bits
    samples_per_shard: int = 256  # paper: 10000 per reducer
    # shuffle bucket capacity = ceil(n_local) * slack
    shuffle_slack: float = 2.0
    # per-round fetch capacity as a fraction of local records (1.0 = all)
    fetch_fraction: float = 1.0
    max_rounds: int = 0  # 0 => derive from read length
    # paper's trick: suffixes shorter than the resolved prefix are final
    skip_exhausted: bool = True
    # server-side packing: respond with packed key words (8B) instead of raw
    # token windows (K bytes).  False = paper-faithful (raw suffix windows).
    server_pack: bool = True
    sort_group_threshold: int = 1 << 20  # paper: 1.6e6
    use_pallas: bool = False  # use the hand-written CUDA kernels
    read_stride_bits: int = 0  # 0 => derive ceil(log2(L+1))
    # two-phase planning: size the shuffle capacity exactly from a bucket
    # histogram (zero drops).  False = static heuristic capacity.
    adaptive: bool = True

    def resolved_chars_per_word(self) -> int:
        if self.chars_per_word:
            return self.chars_per_word
        if self.packing == "base":
            # max k with (vocab+1)^k < 2^31   (tokens shifted to 1..vocab, 0=$)
            k, cap = 0, 1
            while cap * (self.vocab_size + 1) < (1 << 31):
                cap *= self.vocab_size + 1
                k += 1
            return k
        bits = max(1, (self.vocab_size).bit_length())
        return max(1, 31 // bits)

    @property
    def prefix_len(self) -> int:
        return self.resolved_chars_per_word() * self.key_words


@dataclass(frozen=True)
class SuperblockConfig:
    """Out-of-core superblock construction (see ``repro.config``).

    The port runs one block in core (with the post-hoc LCP array under
    ``emit_lcp``) and a plan of more blocks through any ``merge_algorithm``
    (``"merge_path"``, ``"kway"``, ``"rerank"``) on either
    ``merge_backend``, at any ``merge_tile`` and ``pipeline_depth``, with
    the LCP array emitted by the merge, on the in-memory or the chunked
    store (``store_backend``, ``chunk_records``, ``cache_budget_bytes``),
    into a ``spill_dir`` and, with ``write_manifest``, an index directory;
    ``store_retries > 0`` retries transient store faults
    (``store_backoff_s``), ``resume`` with a ``spill_dir`` journals the
    build and resumes a killed one, and ``sanitize`` runs the runtime
    sanitizer.  The fields are kept whole so a JAX run's configuration
    carries across unchanged.
    """

    max_records_per_run: int = 0
    num_superblocks: int = 0
    samples_per_block: int = 32
    request_capacity: int = 4096
    merge_algorithm: str = "merge_path"
    merge_tile: int = 0
    merge_backend: str = "host"
    store_backend: str = "memory"
    chunk_records: int = 0
    cache_budget_bytes: int = 0
    spill_dir: Optional[str] = None
    emit_lcp: bool = False
    write_manifest: bool = False
    sanitize: bool = False
    pipeline_depth: int = 1
    resume: bool = False
    store_retries: int = 0
    store_backoff_s: float = 0.01


def _from_reference(cls, d: dict):
    names = {f.name for f in fields(cls)}
    if set(d) != names:
        raise ValueError(
            f"{cls.__name__} fields differ: missing {sorted(names - set(d))}, "
            f"unknown {sorted(set(d) - names)}")
    return cls(**d)


def sa_config_from_reference(d: dict) -> SAConfig:
    """``dataclasses.asdict`` of a ``repro.config.SAConfig`` -> the port's.

    The configuration plus a numpy corpus is all the state a build has, so
    this is how a run of the JAX package is carried across.  Raises
    ``ValueError`` when the field sets differ.
    """
    return _from_reference(SAConfig, d)


def superblock_config_from_reference(d: dict) -> SuperblockConfig:
    """``dataclasses.asdict`` of a ``repro.config.SuperblockConfig`` -> the
    port's; raises ``ValueError`` when the field sets differ."""
    return _from_reference(SuperblockConfig, d)
