"""CUDA kernel: merge-path ranks of one out-of-core merge tile.

Replaces the Pallas kernel ``repro/kernels/merge_path.py::merge_path_ranks``.
For a (C, W) int32 row matrix it computes ``rank(e) = #{c : row c < row e}``
under lexicographic compare, strictly less; the merge's rows end in the two
global-index words, so the ranks are the merged order
(``kernels.ref.merge_path_ranks_ref`` is the plain version).  Source:
``csrc/merge_path.cu``.

Bound: bytes (C·W·4 read, C·4 written; the searches need C·log2(R) word-0
compares for R runs).  The TPU kernel compares all C² pairs; a merge tile is
the frontiers of a few sorted runs, so the kernel finds the runs on the
device (row i starts one when it is below row i-1) and sums one lower bound
a run: ``rank(e) = Σ_r lower_bound(run r, row e)``, equal to the all-pairs
count for any input.  Up to 32 runs, one row's searches share a warp and
start in shared memory; more runs (unsorted tiles) search 32 runs a thread
and add with atomics.  Three launches, no host read.  ``block`` keeps the
JAX signature and default: here it is the rank kernel's CTA size (at most
1024, rounded up to whole warps).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def merge_path_ranks(keys: torch.Tensor, block: int = 256) -> torch.Tensor:
    """keys (C, W) int32 on a CUDA device -> (C,) int32 ranks."""
    if not (keys.is_cuda and keys.dtype == torch.int32 and keys.dim() == 2
            and keys.is_contiguous()):
        raise ValueError(
            "merge_path_ranks takes a contiguous 2-D int32 CUDA tensor, got "
            f"{keys.dtype} {tuple(keys.shape)} on {keys.device}")
    c, w = keys.shape
    if w < 1:
        raise ValueError(f"merge_path_ranks: need W >= 1, got {w}")
    if c >= 1 << 31:
        raise ValueError("merge_path_ranks: ranks are int32, so C < 2^31")
    if not 1 <= block <= 1024:
        raise ValueError(f"merge_path_ranks: block {block} not in [1, 1024]")
    out = torch.empty((c,), dtype=torch.int32, device=keys.device)
    if c == 0:
        return out
    # run marks, per-CTA run counts, run starts and R
    scratch = torch.empty((3 * c + 2,), dtype=torch.int32, device=keys.device)
    fn = _build.launcher("merge_path", "merge_path_ranks_launch", _ARGTYPES)
    err = fn(keys.data_ptr(), out.data_ptr(), scratch.data_ptr(), c, w, block,
             torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merge_path_ranks launch failed: cudaError {err}")
    merge_path_ranks.launches += 1
    return out


merge_path_ranks.launches = 0
