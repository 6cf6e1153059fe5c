"""Record / index types shared by the suffix-array pipelines.

Same layout as ``repro.core.types``: a suffix's global index
``read_id << stride_bits | offset`` is split into two non-negative int31
words, so a record is four int32 lanes (16 bytes):

    [key_hi, key_lo, idx_hi, idx_lo]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# Sentinel key value: sorts after every real key (keys are < 2^31 - 1).
KEY_SENTINEL = int(np.iinfo(np.int32).max)
# int31 word size used for index packing.
WORD_BITS = 31
WORD_MOD = 1 << WORD_BITS


def pack_index(read_id: torch.Tensor, offset: torch.Tensor, stride_bits: int):
    """(read_id, offset) -> (idx_hi, idx_lo) int32 words.

    The same int32 arithmetic as the jnp path of ``repro.core.types``:
    hi = read_id >> (31 - stride_bits); lo = low bits of read_id
    concatenated with offset.
    """
    read_id = read_id.to(torch.int32)
    lo_bits = WORD_BITS - stride_bits
    hi = read_id >> lo_bits
    lo = ((read_id & ((1 << lo_bits) - 1)) << stride_bits) | offset.to(torch.int32)
    return hi, lo


def unpack_index(idx_hi: torch.Tensor, idx_lo: torch.Tensor, stride_bits: int):
    """(idx_hi, idx_lo) -> (read_id, offset), int32."""
    lo_bits = WORD_BITS - stride_bits
    offset = idx_lo & ((1 << stride_bits) - 1)
    read_lo = idx_lo >> stride_bits
    read_id = (idx_hi << lo_bits) | read_lo
    return read_id.to(torch.int32), offset.to(torch.int32)


def global_index(idx_hi: np.ndarray, idx_lo: np.ndarray) -> np.ndarray:
    """Numpy only: combine words into one int64 global index."""
    return (idx_hi.astype(np.int64) << WORD_BITS) | idx_lo.astype(np.int64)


@dataclass
class Footprint:
    """Data-store footprint (paper §III): deterministic byte accounting.

    Field for field the ``repro.core.types.Footprint`` of the JAX package.
    """

    input: int = 0
    store_put: int = 0
    shuffle: int = 0
    fetch_request: int = 0
    fetch_response: int = 0
    materialized: int = 0
    output: int = 0
    rounds: int = 0
    dropped: int = 0
    superblocks: int = 1
    peak_records: int = 0
    peak_resident_bytes: int = 0

    def total_traffic(self) -> int:
        return self.shuffle + self.fetch_request + self.fetch_response

    def units(self) -> dict:
        """Everything normalized to input size = 1 unit (paper's tables)."""
        ref = max(self.input, 1)
        return {
            "input": 1.0,
            "store_put": self.store_put / ref,
            "shuffle": self.shuffle / ref,
            "fetch_request": self.fetch_request / ref,
            "fetch_response": self.fetch_response / ref,
            "materialized": self.materialized / ref,
            "output": self.output / ref,
            "rounds": self.rounds,
            "dropped": self.dropped,
            "superblocks": self.superblocks,
            "peak_record_bytes": self.peak_records * 16 / ref,
            "peak_resident": self.peak_resident_bytes / ref,
        }


@dataclass
class SAResult:
    """Result of a suffix-array build."""

    # (n,) int64 global suffix indexes in sorted suffix order (numpy, host)
    suffix_array: np.ndarray
    footprint: Footprint
    stats: dict
    lcp: Optional[np.ndarray] = None

    def read_offset(self, stride_bits: int) -> Tuple[np.ndarray, np.ndarray]:
        sa = self.suffix_array
        return (sa >> stride_bits).astype(np.int64), (
            sa & ((1 << stride_bits) - 1)
        ).astype(np.int64)
