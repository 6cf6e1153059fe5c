"""Dispatch for the port's kernels, with the signatures and ``block``/``tile``
defaults of ``repro/kernels/ops.py``.

A tensor on the CPU goes to the kernel's plain version in ``ref``; a CUDA
tensor launches the hand-written kernel, which raises on what it does not
take.  There is no fallback from one to the other.  Kernels not yet ported
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from repro_torch.kernels import KERNEL_REGISTRY, ref


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


def _not_ported(key: str):
    raise NotImplementedError(
        f"the {key} kernel is not ported yet (ROADMAP.md "
        f"{KERNEL_REGISTRY[key].roadmap})")


def bucket_hist(key_hi, key_lo, split_hi, split_lo, block: int = 1024):
    _not_ported("bucket_hist")


def bitonic_sort_tiles(key_hi, key_lo, val, tile: int = 1024):
    _not_ported("bitonic_sort")


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
