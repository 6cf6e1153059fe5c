"""CUDA kernel: Map-phase numeric prefix encoding (paper §IV-B).

Replaces the Pallas kernel ``repro/kernels/prefix_pack.py::prefix_pack``.
For every position i it packs ``tokens[i:i+K]`` (0 past the end) into
``key_words`` int31 words.  Source: ``csrc/prefix_pack.cu``.

Bound: memory (reads 4N bytes, writes 4·N·key_words bytes).  One CTA per
block of ``block`` positions stages its tokens plus the K-1 token halo in
shared memory once, so device memory sees each token about once instead of
K times; see the source for the rest of the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.config import SAConfig
from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def prefix_pack(tokens: torch.Tensor, cfg: SAConfig,
                block: int = 512) -> torch.Tensor:
    """tokens (N,) int32 on a CUDA device -> keys (N, key_words) int32."""
    if not (tokens.is_cuda and tokens.dtype == torch.int32
            and tokens.dim() == 1 and tokens.is_contiguous()):
        raise ValueError(
            "prefix_pack takes a contiguous 1-D int32 CUDA tensor, got "
            f"{tokens.dtype} {tuple(tokens.shape)} on {tokens.device}")
    k = cfg.prefix_len
    if not k <= block <= 1024:
        raise ValueError(f"need prefix_len {k} <= block {block} <= 1024")
    n = tokens.shape[0]
    out = torch.empty((n, cfg.key_words), dtype=torch.int32,
                      device=tokens.device)
    if n == 0:
        return out
    fn = _build.launcher("prefix_pack", "prefix_pack_launch", _ARGTYPES)
    err = fn(tokens.data_ptr(), out.data_ptr(), n, k,
             cfg.resolved_chars_per_word(), cfg.key_words, cfg.vocab_size + 1,
             max(1, int(cfg.vocab_size).bit_length()),
             int(cfg.packing != "base"), block,
             torch.cuda.current_stream(tokens.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefix_pack launch failed: cudaError {err}")
    prefix_pack.launches += 1
    return out


prefix_pack.launches = 0
