"""CUDA kernel: merge-path ranks of one out-of-core merge tile.

Replaces the Pallas kernel ``repro/kernels/merge_path.py::merge_path_ranks``.
For a (C, W) int32 row matrix it computes ``rank(e) = #{c : row c < row e}``
under lexicographic compare, strictly less; the merge's rows end in the two
global-index words, so the ranks are the merged order
(``kernels.ref.merge_path_ranks_ref`` is the plain version).  Source:
``csrc/merge_path.cu``.

Bound: operations (every pair is compared on word 0, C² compares against
C·W·4 bytes read).  One thread per row; all rows stream through shared
memory in chunks, since a full-size tile does not fit a CTA's shared memory
as it fits the TPU's VMEM.  ``block`` keeps the JAX signature and default:
here it is the CTA's thread count (at most 1024).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)
# widest row the kernel takes: one row must fit its shared-memory chunk
MAX_WORDS = 12288


def merge_path_ranks(keys: torch.Tensor, block: int = 256) -> torch.Tensor:
    """keys (C, W) int32 on a CUDA device -> (C,) int32 ranks."""
    if not (keys.is_cuda and keys.dtype == torch.int32 and keys.dim() == 2
            and keys.is_contiguous()):
        raise ValueError(
            "merge_path_ranks takes a contiguous 2-D int32 CUDA tensor, got "
            f"{keys.dtype} {tuple(keys.shape)} on {keys.device}")
    c, w = keys.shape
    if not 1 <= w <= MAX_WORDS:
        raise ValueError(f"merge_path_ranks: need 1 <= W <= {MAX_WORDS}, got {w}")
    if c >= 1 << 31:
        raise ValueError("merge_path_ranks: ranks are int32, so C < 2^31")
    if not 1 <= block <= 1024:
        raise ValueError(f"merge_path_ranks: block {block} not in [1, 1024]")
    out = torch.empty((c,), dtype=torch.int32, device=keys.device)
    if c == 0:
        return out
    fn = _build.launcher("merge_path", "merge_path_ranks_launch", _ARGTYPES)
    err = fn(keys.data_ptr(), out.data_ptr(), c, w, block,
             torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merge_path_ranks launch failed: cudaError {err}")
    merge_path_ranks.launches += 1
    return out


merge_path_ranks.launches = 0
