"""CUDA kernel: server side of ``mgetsuffix`` (paper §IV-B).

Replaces the Pallas kernel ``repro/kernels/window_gather.py::window_gather``.
Given the resident corpus (R, L) and a batch of (row, offset) requests it
gathers the k-token suffix windows: rows outside ``[0, R)`` give zeros,
offsets are clamped to ``[0, L]``, windows are zero-padded past the row end.
Source: ``csrc/window_gather.cu``.

Bound: bytes (8M index bytes and the corpus tokens the windows hold read,
M·k·4 bytes written); random 104-byte windows touch 4-5 32-byte sectors
each, so the DRAM bytes read exceed that count.  A thread per output word
lost its time to a 64-bit division a word, a reload of the request's row
and offset a word and 4-byte loads.  Here a CTA gathers a tile of 64
requests into shared memory, 16 bytes a load where the corpus is 16-byte
aligned and L % 4 == 0 (``_vector_path``; otherwise 4 bytes a load in the
same kernel), and the tile leaves contiguous, by 16-byte stores; see the
source for the rest of the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _check(name: str, t: torch.Tensor, dim: int) -> None:
    if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == dim
            and t.is_contiguous()):
        raise ValueError(
            f"window_gather: {name} must be a contiguous {dim}-D int32 CUDA "
            f"tensor, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _vector_path(corpus: torch.Tensor) -> bool:
    """16-byte loads are safe: the corpus starts on a 16-byte boundary and
    its rows are whole 16-byte chunks (a row-slice view may start anywhere,
    so the pointer is checked, not assumed)."""
    return corpus.data_ptr() % 16 == 0 and corpus.shape[1] % 4 == 0


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
             out.data_ptr(), m, k, r, l, int(_vector_path(corpus)),
             torch.cuda.current_stream(corpus.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_gather launch failed: cudaError {err}")
    window_gather.launches += 1
    return out


window_gather.launches = 0
