"""PyTorch/CUDA port of the suffix-array builder (one NVIDIA H100).

Public surface::

    from repro_torch import SAConfig, SuffixArrayIndex, build_suffix_array_auto

    res = build_suffix_array_auto(reads, cfg=SAConfig(vocab_size=4))
    res.suffix_array; res.footprint; res.stats

    idx = SuffixArrayIndex.build(reads, cfg=SAConfig(vocab_size=4))
    idx.count(pattern); idx.locate(pattern); idx.align(pattern)

The port mirrors the ``repro`` package module by module and gives the same
suffix array, ``Footprint``, ``stats``, LCP array and query answers.  Its LM
serving path (``repro_torch.models``, ``repro_torch.serve.engine``,
``python -m repro_torch.launch.lm_serve --arch ...``) gives ``repro``'s
logits, caches and engine schedule on the same weights.  It imports ``torch`` and numpy,
never ``jax`` or ``repro``.  Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``.

Imports are lazy (PEP 562) so ``import repro_torch`` stays cheap.
"""
from __future__ import annotations

__all__ = [
    "SAConfig",
    "SuperblockConfig",
    "SuffixArrayIndex",
    "ShardedSAEngine",
    "build_suffix_array",
    "build_suffix_array_auto",
]

_LAZY = {
    "SAConfig": ("repro_torch.config", "SAConfig"),
    "SuperblockConfig": ("repro_torch.config", "SuperblockConfig"),
    "SuffixArrayIndex": ("repro_torch.serve.sa_engine", "SuffixArrayIndex"),
    "ShardedSAEngine": ("repro_torch.serve.sa_engine", "ShardedSAEngine"),
    "build_suffix_array": ("repro_torch.core.pipeline", "build_suffix_array"),
    "build_suffix_array_auto": ("repro_torch.core.superblock",
                                "build_suffix_array_auto"),
}


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(__all__))
