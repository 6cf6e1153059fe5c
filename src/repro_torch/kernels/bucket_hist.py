"""CUDA kernel: the TeraSort range partition (paper §IV-A).

Replaces the Pallas kernel ``repro/kernels/bucket_hist.py::bucket_hist``.
``bucket(key)`` is the number of the D-1 splitters lexicographically below
the two-word int32 key, so equal keys land in one bucket; the histogram
counts the N keys per bucket.  ``kernels.ref.bucket_hist_ref`` is the plain
version.  Source: ``csrc/bucket_hist.cu``.

Bound: bytes (8N read, 4N + 4D written).  Every CTA sorts the splitters,
folded to order-preserving int64s, in shared memory with a bitonic network
(the count below a key does not depend on their order, so any splitters
are taken) and lays them out as a breadth-first search tree, whose top
levels fall in distinct banks; a key then takes log2(D) branchless steps
down it, and a shared atomic into a per-CTA histogram.  The tail is
bounds-checked, not padded, so the histogram equals ``bucket_hist_ref`` for
every input (the TPU kernel's padding lands in the wrong bucket once a
splitter equals (int32 max, int32 max)).  ``block`` keeps the JAX signature and default:
here it is the CTA's thread count (at most 1024).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p)
# most splitters the kernel takes: padded to 4096, sorted and as a tree,
# they fill 64 KB of shared memory
MAX_SPLITTERS = 4095


def bucket_hist(key_hi: torch.Tensor, key_lo: torch.Tensor,
                split_hi: torch.Tensor, split_lo: torch.Tensor,
                block: int = 1024):
    """keys (N,), splitters (D-1,) int32 on one CUDA device ->
    (bucket (N,) int32, hist (D,) int32)."""
    for name, t in (("key_hi", key_hi), ("key_lo", key_lo),
                    ("split_hi", split_hi), ("split_lo", split_lo)):
        if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == 1
                and t.is_contiguous() and t.device == key_hi.device):
            raise ValueError(
                f"bucket_hist: {name} must be a contiguous 1-D int32 CUDA "
                f"tensor on the keys' device, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if key_hi.shape != key_lo.shape or split_hi.shape != split_lo.shape:
        raise ValueError("bucket_hist: hi and lo words must match in shape")
    n, s = key_hi.shape[0], split_hi.shape[0]
    if s > MAX_SPLITTERS:
        raise ValueError(f"bucket_hist: at most {MAX_SPLITTERS} splitters, got {s}")
    if not 1 <= block <= 1024:
        raise ValueError(f"bucket_hist: block {block} not in [1, 1024]")
    bucket = torch.empty((n,), dtype=torch.int32, device=key_hi.device)
    hist = torch.zeros((s + 1,), dtype=torch.int32, device=key_hi.device)
    if n == 0:
        return bucket, hist
    fn = _build.launcher("bucket_hist", "bucket_hist_launch", _ARGTYPES)
    err = fn(key_hi.data_ptr(), key_lo.data_ptr(), split_hi.data_ptr(),
             split_lo.data_ptr(), bucket.data_ptr(), hist.data_ptr(), n, s,
             block, torch.cuda.current_stream(key_hi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bucket_hist launch failed: cudaError {err}")
    bucket_hist.launches += 1
    return bucket, hist


bucket_hist.launches = 0
