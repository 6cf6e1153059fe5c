"""CUDA kernel: server side of ``mgetsuffix`` (paper §IV-B).

Replaces the Pallas kernel ``repro/kernels/window_gather.py::window_gather``.
Given the resident corpus (R, L) and a batch of (row, offset) requests it
gathers the k-token suffix windows: rows outside ``[0, R)`` give zeros,
offsets are clamped to ``[0, L]``, windows are zero-padded past the row end.
Source: ``csrc/window_gather.cu``.

Bound: memory (8M index bytes and at most min(M·k, R·L)·4 corpus bytes read,
M·k·4 bytes written).  One thread per output token keeps the stores
coalesced; see the source for the rest of the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def _check(name: str, t: torch.Tensor, dim: int) -> None:
    if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == dim
            and t.is_contiguous()):
        raise ValueError(
            f"window_gather: {name} must be a contiguous {dim}-D int32 CUDA "
            f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def window_gather(corpus: torch.Tensor, rows: torch.Tensor,
                  offs: torch.Tensor, k: int) -> torch.Tensor:
    """corpus (R, L), rows/offs (M,) int32 on one CUDA device -> (M, k)."""
    _check("corpus", corpus, 2)
    _check("rows", rows, 1)
    _check("offs", offs, 1)
    if rows.shape != offs.shape or not (rows.device == offs.device
                                        == corpus.device):
        raise ValueError("window_gather: rows and offs must match in shape "
                         "and lie on the corpus's device")
    r, l = corpus.shape
    m = rows.shape[0]
    out = torch.empty((m, k), dtype=torch.int32, device=corpus.device)
    if m * k == 0:
        return out
    fn = _build.launcher("window_gather", "window_gather_launch", _ARGTYPES)
    err = fn(corpus.data_ptr(), rows.data_ptr(), offs.data_ptr(),
             out.data_ptr(), m, k, r, l,
             torch.cuda.current_stream(corpus.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_gather launch failed: cudaError {err}")
    window_gather.launches += 1
    return out


window_gather.launches = 0
