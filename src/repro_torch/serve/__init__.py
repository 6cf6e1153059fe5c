"""Suffix-array serving of the port (``repro.serve``'s query half)."""
from repro_torch.serve.sa_engine import ShardedSAEngine, SuffixArrayIndex

__all__ = ["ShardedSAEngine", "SuffixArrayIndex"]
