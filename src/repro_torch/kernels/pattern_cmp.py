"""CUDA kernels: the query engine's masked suffix-vs-pattern compare, and
its whole search.

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

:func:`pattern_cmp_level` is the compare as the engine's round loop runs it:
one window level of ``core.search.compare_levels`` (the compare and the
level's bookkeeping on the engine's row tensors, pattern tokens and lengths
read in place) in one launch (``kernels.ref.pattern_cmp_level_ref`` is the
plain version).

:func:`pattern_search` runs one bound of the engine's Manber–Myers search
for every row of a batch in one launch (``kernels.ref.pattern_search_ref``
is the plain version): no host read a round, no window gather.  Bound:
latency, a row's 30-90 dependent loads (a warp a row); see the source.
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


_LEVEL_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def _check_arg(fn: str, name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t``, argument ``name`` of ``fn``, is a contiguous CUDA
    tensor of ``dtype`` and ``shape`` on ``device``."""
    if not (t.is_cuda and t.dtype == dtype and tuple(t.shape) == tuple(shape)
            and t.is_contiguous() and t.device == device):
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def pattern_cmp_level(win: torch.Tensor, pos: torch.Tensor, t_in: torch.Tensor,
                      t: torch.Tensor, pi: torch.Tensor, pat_len: torch.Tensor,
                      pat_rows: torch.Tensor, cmp: torch.Tensor, nxt: torch.Tensor,
                      levels=None, block: int = 256) -> None:
    """One window level of ``core.search.compare_levels`` on one CUDA
    device, in place: ``win`` (m, K) int32 the level's windows; per engine
    row ``pos`` (q,) int32 (its row of ``win``, -1 out of play), ``t_in``,
    ``t`` and ``pi`` (q,) int64; pattern lengths (q_pat,) and rows (q_pat,
    lmax) int64; ``cmp`` (q,) int32, ``nxt`` (q,) int64 and ``levels`` (q,)
    int32 or None, written as ``kernels.ref.pattern_cmp_level_ref`` writes
    them (``t_in`` may be ``t``: a level after the first)."""
    dev = win.device
    if win.dim() != 2 or pat_rows.dim() != 2:
        raise ValueError("pattern_cmp_level: win and pat_rows must be 2-D, got "
                         f"{tuple(win.shape)} and {tuple(pat_rows.shape)}")
    (m, k), q = win.shape, pos.shape[0]
    if k < 1 or pat_rows.shape[1] < 1:
        raise ValueError("pattern_cmp_level: windows and pattern rows need at "
                         "least one column")
    args = [("win", win, torch.int32, (m, k)), ("pos", pos, torch.int32, (q,)),
            ("t_in", t_in, torch.int64, (q,)), ("t", t, torch.int64, (q,)),
            ("pi", pi, torch.int64, (q,)),
            ("pat_len", pat_len, torch.int64, pat_rows.shape[:1]),
            ("pat_rows", pat_rows, torch.int64, pat_rows.shape),
            ("cmp", cmp, torch.int32, (q,)), ("nxt", nxt, torch.int64, (q,))]
    if levels is not None:
        args.append(("levels", levels, torch.int32, (q,)))
    for name, x, dtype, shape in args:
        _check_arg("pattern_cmp_level", name, x, dtype, shape, dev)
    if q == 0:
        return
    warps = min(max(int(block) // 32, 1), 32)
    fn = _build.launcher("pattern_cmp", "pattern_cmp_level_launch", _LEVEL_ARGTYPES)
    err = fn(win.data_ptr(), k, pos.data_ptr(), q, t_in.data_ptr(), t.data_ptr(),
             pi.data_ptr(), pat_len.data_ptr(), pat_rows.data_ptr(),
             pat_rows.shape[1], cmp.data_ptr(), nxt.data_ptr(),
             None if levels is None else levels.data_ptr(), warps,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pattern_cmp_level launch failed: cudaError {err}")
    pattern_cmp_level.launches += 1


pattern_cmp_level.launches = 0


_SEARCH_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def pattern_search(padded: torch.Tensor, stride_bits: int, k: int,
                   sa: torch.Tensor, llcp, rlcp, pat: torch.Tensor,
                   plen: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   upper: bool, rounds: int, block: int = 256):
    """One bound of every pattern row on one CUDA device: the corpus
    zero-padded by ``k`` tokens, int32 ``(n + k,)`` (text) or ``(rows,
    row_len + k)`` (reads); ``sa`` and ``llcp``/``rlcp`` (both None: no LCP)
    int64 (n_sa,); ``pat`` (q, lmax), ``plen``, ``lo``, ``hi`` (q,) int64;
    ``rounds`` the most search rounds a row can take.  Returns ``(bound (q,)
    int64, levels (q, rounds) int32, active (q,) int32)``, as
    ``kernels.ref.pattern_search_ref``."""
    dev = padded.device
    if not (padded.is_cuda and padded.dtype == torch.int32
            and padded.dim() in (1, 2) and padded.is_contiguous()):
        raise ValueError(
            "pattern_search: the corpus must be a contiguous 1-D or 2-D int32 "
            f"CUDA tensor, got {padded.dtype} {tuple(padded.shape)} on {dev}")
    text = padded.dim() == 1
    if not 1 <= k <= padded.shape[-1] or rounds < 1:
        raise ValueError(f"pattern_search: k = {k} must be in [1, {padded.shape[-1]}] "
                         f"and rounds = {rounds} at least 1")
    if pat.dim() != 2:
        raise ValueError(f"pattern_search: pat must be (q, lmax), got {tuple(pat.shape)}")
    q, lmax = pat.shape
    n_sa = sa.shape[0]
    _check_arg("pattern_search", "sa", sa, torch.int64, (n_sa,), dev)
    if (llcp is None) != (rlcp is None):
        raise ValueError("pattern_search: give both llcp and rlcp, or neither")
    if llcp is not None:
        _check_arg("pattern_search", "llcp", llcp, torch.int64, (n_sa,), dev)
        _check_arg("pattern_search", "rlcp", rlcp, torch.int64, (n_sa,), dev)
    _check_arg("pattern_search", "pat", pat, torch.int64, (q, lmax), dev)
    for name, t in (("plen", plen), ("lo", lo), ("hi", hi)):
        _check_arg("pattern_search", name, t, torch.int64, (q,), dev)
    bound = torch.empty((q,), dtype=torch.int64, device=dev)
    levels = torch.empty((q, rounds), dtype=torch.int32, device=dev)
    active = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return bound, levels, active
    if text:
        n, row_len, row_stride = padded.shape[0] - k, 0, 0
    else:
        n, row_len, row_stride = 0, padded.shape[1] - k, padded.shape[1]
    warps = min(max(int(block) // 32, 1), 32)
    fn = _build.launcher("pattern_cmp", "pattern_search_launch", _SEARCH_ARGTYPES)
    err = fn(padded.data_ptr(), int(text), n, row_len, row_stride, int(stride_bits),
             int(k), sa.data_ptr(), None if llcp is None else llcp.data_ptr(),
             None if rlcp is None else rlcp.data_ptr(), pat.data_ptr(), lmax,
             plen.data_ptr(), lo.data_ptr(), hi.data_ptr(), q, int(bool(upper)),
             int(rounds), bound.data_ptr(), levels.data_ptr(), active.data_ptr(),
             warps, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pattern_search launch failed: cudaError {err}")
    pattern_search.launches += 1
    return bound, levels, active


pattern_search.launches = 0
