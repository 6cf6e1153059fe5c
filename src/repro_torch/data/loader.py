"""Deterministic, resumable, shard-aware batch loader (a numpy copy of
``repro.data.loader``).

Exact-resume semantics: the loader's position is just the step counter —
batch ``i`` is a pure function of (seed, i, topology), so a restarted job
replays the identical data order with nothing but the step from the
checkpoint.  Works per host in a multi-host deployment (each host
materializes only its slice: ``host_slice``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class DeterministicLoader:
    def __init__(
        self,
        tokens: np.ndarray,
        batch: int,
        seq_len: int,
        seed: int = 0,
        mask: Optional[np.ndarray] = None,
        num_hosts: int = 1,
        host_id: int = 0,
    ):
        self.tokens = tokens
        self.mask = mask
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        n_windows = (len(tokens) - 1) // seq_len
        if n_windows < 1:
            raise ValueError("corpus shorter than one sequence")
        self.n_windows = n_windows

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The full global batch for ``step`` (pure function)."""
        rng = np.random.default_rng((self.seed, step))
        win = rng.integers(0, self.n_windows, size=(self.batch,))
        starts = win * self.seq_len
        idx = starts[:, None] + np.arange(self.seq_len)[None, :]
        toks = self.tokens[idx].astype(np.int32)
        labels = self.tokens[idx + 1].astype(np.int32)
        out = {"tokens": toks, "labels": labels}
        if self.mask is not None:
            out["mask"] = self.mask[idx + 1].astype(np.float32)
        return out

    def host_slice(self, step: int) -> Dict[str, np.ndarray]:
        b = self.batch // self.num_hosts
        full = self.batch_at(step)
        lo = self.host_id * b
        return {k: v[lo : lo + b] for k, v in full.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
