"""Suffix-array configuration of the port.

A copy of ``repro.config.SAConfig`` with the same fields, defaults and
derived values (``tests/test_torch_config.py`` holds the two together).
``use_pallas`` keeps its name: in the port it selects the hand-written
CUDA kernels instead of their plain PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass(frozen=True)
class SAConfig:
    """Configuration for suffix-array construction (see ``repro.config``).

    ``mode``: only ``"scheme"`` (the paper's index-only shuffle with
    on-demand window fetches) is ported so far.
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


def sa_config_from_reference(d: dict) -> SAConfig:
    """``dataclasses.asdict`` of a ``repro.config.SAConfig`` -> the port's.

    The configuration plus a numpy corpus is all the state a build has, so
    this is how a run of the JAX package is carried across.  Raises
    ``ValueError`` when the field sets differ.
    """
    names = {f.name for f in fields(SAConfig)}
    if set(d) != names:
        raise ValueError(
            f"SAConfig fields differ: missing {sorted(names - set(d))}, "
            f"unknown {sorted(set(d) - names)}")
    return SAConfig(**d)
