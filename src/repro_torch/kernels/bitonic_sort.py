"""CUDA kernel: the reducer's sorting-group sorter (paper §IV-C).

Replaces the Pallas kernel ``repro/kernels/bitonic_sort.py::bitonic_sort_tiles``.
Each power-of-two ``tile`` of (key_hi, key_lo, val) int32 rows is sorted on
its own by (key_hi, key_lo), ascending; ``val`` rides along and rows with
equal keys come out in no fixed order.  ``kernels.ref.bitonic_sort_tiles_ref``
is the plain version.  Source: ``csrc/bitonic_sort.cu``.

Bound: bytes (12 bytes read and 12 written a row), with the network's
integer instructions close behind.  The all-ascending bitonic network runs in
registers over order-preserving int64 keys: a CTA holds its rows R a thread
and every compare-exchange runs inside a thread, the rows moving through
shared memory between chunks of stages; the stages are unrolled per
log2(tile).  The short last tile is filled in registers with keys no real row exceeds, so no
real row is ever cut off (the TPU kernel's int32-max padding can sort ahead
of a real (int32 max, int32 max) row and drop it).  Any power-of-two tile is
taken: past ``2**LOG_TC`` rows the tile is sorted in blocks of that size and
merged by global passes (``plan``); a tile above n sorts the n rows as one
tile of the next power of two.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build

_SORT_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p)
_PASS_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)
# T_c = 2^LOG_TC, the most rows one CTA sorts, and 2^MIN_SEG, the contiguous
# rows a thread keeps in a global pass: the source's kBigLogC and kMinSeg,
# which the wrapper reads from the library and holds to these
LOG_TC = 12
MIN_SEG = 4


def plan(n: int, tile: int) -> List[Tuple]:
    """The launches that sort every ``tile`` rows of ``n`` (n >= 1):
    ``("sort", lt)`` sorts every 2^lt rows in a CTA; ``("pass", lo, g,
    flip)`` runs, in place, the stages at bits lo + g - 1 ... lo of the
    current merge, a flip first when ``flip`` (then the merge is
    2^(lo + g)).  A tile above n is cut to the power of two at or above n."""
    lt = min(tile, 1 << (n - 1).bit_length()).bit_length() - 1
    if lt <= LOG_TC:
        return [("sort", lt)]
    flip_max, half_max = LOG_TC - 1 - MIN_SEG, LOG_TC - MIN_SEG
    steps: List[Tuple] = [("sort", LOG_TC)]
    for s in range(LOG_TC + 1, lt + 1):
        g = min(s - LOG_TC, flip_max)
        steps.append(("pass", s - g, g, True))
        top = s - g
        while top > LOG_TC:
            g = min(top - LOG_TC, half_max)
            steps.append(("pass", top - g, g, False))
            top -= g
        steps.append(("pass", 0, LOG_TC, False))
    return steps


@functools.cache
def _library_shape() -> Tuple[int, int]:
    """(kBigLogC, kMinSeg) as the built library reports them."""
    fn = _build.launcher("bitonic_sort", "bitonic_sort_config",
                         (ctypes.POINTER(ctypes.c_int),) * 2)
    log_tc, min_seg = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(log_tc), ctypes.byref(min_seg))
    return log_tc.value, min_seg.value


def _vector_path(*cols: torch.Tensor) -> bool:
    """16-byte loads and stores are safe: every column starts on a 16-byte
    boundary (a view may start anywhere, so the pointers are checked)."""
    return all(t.data_ptr() % 16 == 0 for t in cols)


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
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"bitonic_sort_tiles: tile must be a power of two, got {tile}")
    n = key_hi.shape[0]
    outs = tuple(torch.empty_like(key_hi) for _ in range(3))
    if n == 0:
        return outs
    if _library_shape() != (LOG_TC, MIN_SEG):
        raise RuntimeError(f"bitonic_sort_tiles: the library's (log2 T_c, log2 run) is "
                           f"{_library_shape()}, plan assumes {(LOG_TC, MIN_SEG)}")
    vec = int(_vector_path(key_hi, key_lo, val, *outs))
    stream = torch.cuda.current_stream(key_hi.device).cuda_stream
    ptrs = [o.data_ptr() for o in outs]
    for step in plan(n, tile):
        if step[0] == "sort":
            fn = _build.launcher("bitonic_sort", "bitonic_sort_launch", _SORT_ARGTYPES)
            err = fn(key_hi.data_ptr(), key_lo.data_ptr(), val.data_ptr(), *ptrs,
                     n, step[1], vec, stream)
        else:
            fn = _build.launcher("bitonic_sort", "bitonic_pass_launch", _PASS_ARGTYPES)
            _, lo, g, flip = step
            err = fn(*ptrs, n, lo, g, int(flip), vec, stream)
        if err != 0:
            raise RuntimeError(f"bitonic_sort_tiles launch {step} failed: cudaError {err}")
        bitonic_sort_tiles.cuda_launches += 1
    bitonic_sort_tiles.launches += 1
    return outs


bitonic_sort_tiles.launches = 0  # calls, as every op counts them
bitonic_sort_tiles.cuda_launches = 0  # kernel launches, one or more a call
