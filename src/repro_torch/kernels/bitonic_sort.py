"""CUDA kernel: the reducer's sorting-group sorter (paper §IV-C).

Replaces the Pallas kernel ``repro/kernels/bitonic_sort.py::bitonic_sort_tiles``.
Each power-of-two ``tile`` of (key_hi, key_lo, val) int32 rows is sorted on
its own by (key_hi, key_lo), ascending; ``val`` rides along and rows with
equal keys come out in no fixed order.  ``kernels.ref.bitonic_sort_tiles_ref``
is the plain version.  Source: ``csrc/bitonic_sort.cu``.

Bound: bytes (12 bytes read and 12 written a row).  One CTA a tile runs the
bitonic network in shared memory over order-preserving int64 keys.  The
short last tile is filled with rows flagged as padding, which compare above
every key, so no real row is ever cut off (the TPU kernel's int32-max
padding can sort ahead of a real (int32 max, int32 max) row and drop it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p)
# widest tile the kernel takes: 13 bytes a row of shared memory
MAX_TILE = 2048


def bitonic_sort_tiles(key_hi: torch.Tensor, key_lo: torch.Tensor,
                       val: torch.Tensor, tile: int = 1024):
    """(N,) int32 keys and values on one CUDA device -> the three columns
    with every ``tile`` rows sorted by (key_hi, key_lo)."""
    for name, t in (("key_hi", key_hi), ("key_lo", key_lo), ("val", val)):
        if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == 1
                and t.is_contiguous() and t.device == key_hi.device
                and t.shape == key_hi.shape):
            raise ValueError(
                f"bitonic_sort_tiles: {name} must be a contiguous 1-D int32 "
                f"CUDA tensor shaped and placed as key_hi, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if tile < 1 or tile & (tile - 1) or tile > MAX_TILE:
        raise ValueError(
            f"bitonic_sort_tiles: tile must be a power of two <= {MAX_TILE}, "
            f"got {tile}")
    n = key_hi.shape[0]
    outs = tuple(torch.empty_like(key_hi) for _ in range(3))
    if n == 0:
        return outs
    fn = _build.launcher("bitonic_sort", "bitonic_sort_launch", _ARGTYPES)
    err = fn(key_hi.data_ptr(), key_lo.data_ptr(), val.data_ptr(),
             *(o.data_ptr() for o in outs), n, tile,
             torch.cuda.current_stream(key_hi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitonic_sort_tiles launch failed: cudaError {err}")
    bitonic_sort_tiles.launches += 1
    return outs


bitonic_sort_tiles.launches = 0
