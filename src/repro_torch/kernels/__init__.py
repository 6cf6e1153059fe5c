"""Hand-written CUDA kernels of the port, each paired with a plain version.

``KERNEL_REGISTRY`` has the keys of ``repro.kernels.KERNEL_REGISTRY`` (one
per Pallas kernel of the JAX package).  Each entry names its dispatch op in
``repro_torch.kernels.ops`` and its plain version in
``repro_torch.kernels.ref``.  ``pattern_search``, the query engine's whole
search on the card, and ``pattern_cmp_level``, one window level of its round
loop, have no entry: they have no Pallas counterpart, and live beside
``pattern_cmp``, whose compare they run.  Nor has ``run_groups``, the
run-start group ids of sorted rows, which the JAX package leaves to
``lax.cummax``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class KernelEntry(NamedTuple):
    """One kernel's place in the port."""

    op: str  # dispatch callable in repro_torch.kernels.ops
    ref: str  # plain version in repro_torch.kernels.ref


KERNEL_REGISTRY: Dict[str, KernelEntry] = {
    "prefix_pack": KernelEntry("prefix_pack", "prefix_pack_ref"),
    "window_gather": KernelEntry("window_gather", "window_gather_ref"),
    "bucket_hist": KernelEntry("bucket_hist", "bucket_hist_ref"),
    "bitonic_sort": KernelEntry("bitonic_sort_tiles", "bitonic_sort_tiles_ref"),
    "merge_path": KernelEntry("merge_path_ranks", "merge_path_ranks_ref"),
    "pattern_cmp": KernelEntry("pattern_cmp", "pattern_cmp_ref"),
}


def _wrappers() -> Dict[str, object]:
    """Each ported kernel's wrapper (its ``launches`` count lives on it)."""
    from repro_torch.kernels import (
        bitonic_sort,
        bucket_hist,
        merge_path,
        pattern_cmp,
        prefix_pack,
        run_groups,
        window_gather,
    )

    return {
        "prefix_pack": prefix_pack.prefix_pack,
        "window_gather": window_gather.window_gather,
        "bucket_hist": bucket_hist.bucket_hist,
        "pattern_cmp": pattern_cmp.pattern_cmp,
        "pattern_cmp_level": pattern_cmp.pattern_cmp_level,
        "pattern_search": pattern_cmp.pattern_search,
        "merge_path": merge_path.merge_path_ranks,
        "bitonic_sort": bitonic_sort.bitonic_sort_tiles,
        "run_groups": run_groups.run_groups,
    }


def reset_launch_counts() -> None:
    """Set every ported kernel's ``launches`` count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each ported kernel since the last reset."""
    return {key: fn.launches for key, fn in _wrappers().items()}
