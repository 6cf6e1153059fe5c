"""CUDA kernel: Map-phase numeric prefix encoding (paper §IV-B).

Replaces the Pallas kernel ``repro/kernels/prefix_pack.py::prefix_pack``.
For every position i it packs ``tokens[i:i+K]`` (0 past the end) into
``key_words`` int31 words.  Source: ``csrc/prefix_pack.cu``.

Bound: memory (reads 4N bytes, writes 4·N·key_words bytes).  ``block``
keeps the JAX signature and meaning, the positions a tile: a persistent
grid of CTAs of ``block / 8`` threads stages a tile plus the K-1 token halo
in shared memory, 16 bytes a load where the tokens start on a 16-byte
boundary (read from the pointer, as ``window_gather`` does), and a thread
packs 8 consecutive positions, rolling each word one token a position; see
the source for the rest of the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.config import SAConfig
from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _vector_path(tokens: torch.Tensor) -> bool:
    """16-byte loads are safe: the tokens start on a 16-byte boundary (a
    view such as ``tokens[1:]`` may start anywhere, so the pointer is
    checked, not assumed)."""
    return tokens.data_ptr() % 16 == 0


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
             int(cfg.packing != "base"), block, int(_vector_path(tokens)),
             torch.cuda.current_stream(tokens.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefix_pack launch failed: cudaError {err}")
    prefix_pack.launches += 1
    return out


prefix_pack.launches = 0
