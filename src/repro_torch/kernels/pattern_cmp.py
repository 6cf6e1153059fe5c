"""CUDA kernel: the query engine's masked suffix-vs-pattern compare.

Replaces the Pallas kernel ``repro/kernels/pattern_cmp.py::pattern_cmp``.
Per row of the (B, K) suffix and pattern windows it reports ``[cmp,
matched]`` at the first mismatch over the token range ``[start, stop)``
(``kernels.ref.pattern_cmp_ref`` is the plain version).  Source:
``csrc/pattern_cmp.cu``.

Bound: memory (2·B·K·4 window bytes and 8B range bytes read, 8B written);
at the engine's batches of at most a few thousand rows the launch latency
dominates.  One warp per row with a ballot over 32 columns at a time; see
the source for the rest of the design.  ``block`` keeps the JAX signature
and default: here it is the CTA's thread count, ``block // 32`` warps
(at least 1, at most 32), one row each.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def _check(name: str, t: torch.Tensor, dim: int) -> None:
    if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == dim
            and t.is_contiguous()):
        raise ValueError(
            f"pattern_cmp: {name} must be a contiguous {dim}-D int32 CUDA "
            f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def pattern_cmp(sfx: torch.Tensor, pat: torch.Tensor, start: torch.Tensor,
                stop: torch.Tensor, block: int = 256) -> torch.Tensor:
    """(B, K) sfx/pat + (B,) start/stop, int32 on one CUDA device ->
    (B, 2) int32 ``[cmp, matched]``."""
    _check("sfx", sfx, 2)
    _check("pat", pat, 2)
    _check("start", start, 1)
    _check("stop", stop, 1)
    b, k = sfx.shape
    if (pat.shape != sfx.shape or start.shape != (b,) or stop.shape != (b,)
            or not (sfx.device == pat.device == start.device == stop.device)):
        raise ValueError("pattern_cmp: sfx/pat must match in shape, start/stop "
                         "have one entry per row, all on one device")
    if k < 1:
        raise ValueError("pattern_cmp: windows need at least one column")
    out = torch.empty((b, 2), dtype=torch.int32, device=sfx.device)
    if b == 0:
        return out
    warps = min(max(int(block) // 32, 1), 32)
    fn = _build.launcher("pattern_cmp", "pattern_cmp_launch", _ARGTYPES)
    err = fn(sfx.data_ptr(), pat.data_ptr(), start.data_ptr(), stop.data_ptr(),
             out.data_ptr(), b, k, warps,
             torch.cuda.current_stream(sfx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pattern_cmp launch failed: cudaError {err}")
    pattern_cmp.launches += 1
    return out


pattern_cmp.launches = 0
