"""Serving of the port: suffix-array queries (``repro.serve``'s query half)
and the LM's continuous-batching engine."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sa_engine import ShardedSAEngine, SuffixArrayIndex

__all__ = ["Request", "ServeEngine", "ShardedSAEngine", "SuffixArrayIndex"]
