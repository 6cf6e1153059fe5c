"""Dispatch for the port's kernels, with the signatures and ``block``/``tile``
defaults of ``repro/kernels/ops.py``.

A tensor on the CPU goes to the kernel's plain version in ``ref``; a CUDA
tensor launches the hand-written kernel, which raises on what it does not
take.  There is no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import ref


def prefix_pack(tokens, cfg, block: int = 512):
    if tokens.device.type == "cpu":
        return ref.prefix_pack_ref(tokens, cfg)
    from repro_torch.kernels.prefix_pack import prefix_pack as _prefix_pack

    return _prefix_pack(tokens, cfg, block=block)


def window_gather(corpus, rows, offs, k: int):
    if corpus.device.type == "cpu":
        return ref.window_gather_ref(corpus, rows, offs, k)
    from repro_torch.kernels.window_gather import window_gather as _window_gather

    return _window_gather(corpus, rows, offs, k)


def bucket_hist(key_hi, key_lo, split_hi, split_lo, block: int = 1024):
    if key_hi.device.type == "cpu":
        return ref.bucket_hist_ref(key_hi, key_lo, split_hi, split_lo)
    from repro_torch.kernels.bucket_hist import bucket_hist as _bucket_hist

    return _bucket_hist(key_hi, key_lo, split_hi, split_lo, block=block)


def bitonic_sort_tiles(key_hi, key_lo, val, tile: int = 1024):
    if key_hi.device.type == "cpu":
        return ref.bitonic_sort_tiles_ref(key_hi, key_lo, val, tile)
    from repro_torch.kernels.bitonic_sort import bitonic_sort_tiles as _bitonic

    return _bitonic(key_hi, key_lo, val, tile=tile)


def merge_path_ranks(keys, block: int = 256):
    if keys.device.type == "cpu":
        return ref.merge_path_ranks_ref(keys)
    from repro_torch.kernels.merge_path import merge_path_ranks as _merge_path_ranks

    return _merge_path_ranks(keys, block=block)


def pattern_cmp(sfx, pat, start, stop, block: int = 256):
    if sfx.device.type == "cpu":
        return ref.pattern_cmp_ref(sfx, pat, start, stop)
    from repro_torch.kernels.pattern_cmp import pattern_cmp as _pattern_cmp

    return _pattern_cmp(sfx, pat, start, stop, block=block)


def pattern_cmp_level(win, pos, t_in, t, pi, pat_len, pat_rows, cmp, nxt,
                      levels=None, block: int = 256):
    """One window level of the engine's round loop, in place (no Pallas
    counterpart: the JAX engine runs the level on the host around
    ``pattern_cmp``)."""
    if win.device.type == "cpu":
        return ref.pattern_cmp_level_ref(win, pos, t_in, t, pi, pat_len, pat_rows,
                                         cmp, nxt, levels)
    from repro_torch.kernels.pattern_cmp import pattern_cmp_level as _level

    return _level(win, pos, t_in, t, pi, pat_len, pat_rows, cmp, nxt, levels,
                  block=block)


def pattern_search(padded, stride_bits, k, sa, llcp, rlcp, pat, plen, lo, hi,
                   upper, rounds, block: int = 256):
    """The whole Manber–Myers search of one bound for a batch (no Pallas
    counterpart: it runs the rounds around ``pattern_cmp``'s compare)."""
    if padded.device.type == "cpu":
        return ref.pattern_search_ref(padded, stride_bits, k, sa, llcp, rlcp, pat,
                                      plen, lo, hi, upper, rounds)
    from repro_torch.kernels.pattern_cmp import pattern_search as _pattern_search

    return _pattern_search(padded, stride_bits, k, sa, llcp, rlcp, pat, plen, lo,
                           hi, upper, rounds, block=block)


def run_groups(keys, valid):
    """Group ids of runs of equal ``keys`` rows, padding rows (``valid``
    false) standing alone (no Pallas counterpart: the JAX package's pipeline
    computes the flags inline, then ``run_starts``' ``lax.cummax``)."""
    if valid.device.type == "cpu":
        return ref.run_groups_ref(keys, valid)
    from repro_torch.kernels.run_groups import run_groups as _run_groups

    return _run_groups(keys, valid)


def run_starts(eq_prev):
    """The start index of each row's run from the flags ``eq_prev`` (no
    Pallas counterpart: the JAX package's ``run_starts`` is a ``lax.cummax``)."""
    if eq_prev.device.type == "cpu":
        return ref.run_starts_ref(eq_prev)
    from repro_torch.kernels.run_groups import run_starts as _run_starts

    return _run_starts(eq_prev)
