"""CUDA kernel: run-start group ids of sorted rows, in one pass.

Replaces no Pallas kernel.  The JAX package computes these ids with
``lax.cummax`` (``repro/core/distributed.py::run_starts``); the port's plain
version (``ref.run_starts_ref``, ``ref.run_groups_ref``) with
``torch.cummax``, which on the card scans a single row with almost no
parallelism and writes an int64 index output that nobody reads.  For n rows,
``g[i] = max over j <= i of (eq[j] ? -1 : j)`` as int32, with the eq flags
either computed in the kernel from 0 to 3 int32 key columns and a bool
``valid`` mask (:func:`run_groups`: ``eq[0]`` false, ``eq[i] = valid[i] &``
every column equal to row i - 1's), or given (:func:`run_starts`).
Source: ``csrc/run_groups.cu``.

Bound: bytes, (4w + 1 + 4) a row for w columns: the columns and the flag
byte read, the id written; the flags, the candidate ids and the index output
never reach device memory.  One CTA scans a tile of ``TILE_ROWS`` rows, and
the tiles chain by a single-pass decoupled look-back: a tile that holds a
run start publishes its prefix before it looks back, and a look-back passes
only tiles that have not yet published theirs, which are tiles still
running.  So one run over every tile stays linear: no tile walks back over
all the tiles before it (see the source for the rest of the design).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE_ROWS = 4096  # rows a tile (``kTile`` in the source)

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not (t.is_cuda and t.dtype == dtype and t.dim() == 1 and t.is_contiguous()):
        raise ValueError(
            f"run_groups: {name} must be a contiguous 1-D {dtype} CUDA tensor, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _launch(cols, flags: torch.Tensor, from_flags: bool) -> torch.Tensor:
    cols = list(cols)
    if len(cols) > 3:
        raise ValueError(f"run_groups: at most 3 key columns, got {len(cols)}")
    for i, c in enumerate(cols):
        _check(f"key column {i}", c, torch.int32)
    _check("eq_prev" if from_flags else "valid", flags, torch.bool)
    if any(c.shape != flags.shape or c.device != flags.device for c in cols):
        raise ValueError("run_groups: every key column must match valid in "
                         "length and device")
    n = flags.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"run_groups: at most 2^31 - 1 rows, got {n}")
    out = torch.empty(n, dtype=torch.int32, device=flags.device)
    if n == 0:
        return out
    scratch = torch.empty(-(-n // TILE_ROWS) + 1, dtype=torch.int32, device=flags.device)
    ptrs = [c.data_ptr() for c in cols] + [0] * (3 - len(cols))
    vec = all(p % 16 == 0 for p in [*ptrs[:len(cols)], flags.data_ptr()])
    fn = _build.launcher("run_groups", "run_groups_launch", _ARGTYPES)
    err = fn(*ptrs, len(cols), flags.data_ptr(), int(from_flags), out.data_ptr(), n,
             scratch.data_ptr(), scratch.shape[0], int(vec),
             torch.cuda.current_stream(flags.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"run_groups launch failed: cudaError {err}")
    run_groups.launches += 1
    return out


def run_groups(keys, valid: torch.Tensor) -> torch.Tensor:
    """Group ids of runs of equal ``keys`` rows (0 to 3 int32 columns), a
    row with ``valid`` false starting a run of its own: ``(n,)`` int32."""
    return _launch(keys, valid, from_flags=False)


def run_starts(eq_prev: torch.Tensor) -> torch.Tensor:
    """Given ``eq_prev[i]`` = (row i equals row i-1), the start index of each
    row's run (-1 before the first row whose flag is false)."""
    return _launch((), eq_prev, from_flags=True)


run_groups.launches = 0  # both modes launch the one kernel
