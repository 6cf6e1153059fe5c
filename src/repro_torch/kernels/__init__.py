"""Hand-written CUDA kernels of the port, each paired with a plain version.

``KERNEL_REGISTRY`` has the keys of ``repro.kernels.KERNEL_REGISTRY`` (one
per Pallas kernel of the JAX package).  A ported entry names its kernel
module, its dispatch op in ``repro_torch.kernels.ops`` and its plain version
in ``repro_torch.kernels.ref``; an entry not yet ported names the ROADMAP
item that ports it, and its op raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class KernelEntry(NamedTuple):
    """One kernel's place in the port."""

    op: str  # dispatch callable in repro_torch.kernels.ops
    ported: bool
    ref: Optional[str] = None  # plain version in repro_torch.kernels.ref
    roadmap: Optional[str] = None  # the ROADMAP.md item that ports it


KERNEL_REGISTRY: Dict[str, KernelEntry] = {
    "prefix_pack": KernelEntry("prefix_pack", True, "prefix_pack_ref"),
    "window_gather": KernelEntry("window_gather", True, "window_gather_ref"),
    "bucket_hist": KernelEntry("bucket_hist", False, roadmap="item 10"),
    "bitonic_sort": KernelEntry("bitonic_sort_tiles", False,
                                roadmap="queue 2, K6"),
    "merge_path": KernelEntry("merge_path_ranks", True, "merge_path_ranks_ref"),
    "pattern_cmp": KernelEntry("pattern_cmp", True, "pattern_cmp_ref"),
}


def reset_launch_counts() -> None:
    """Set every ported kernel's ``launches`` count to 0."""
    from repro_torch.kernels import merge_path, pattern_cmp, prefix_pack, window_gather

    prefix_pack.prefix_pack.launches = 0
    window_gather.window_gather.launches = 0
    pattern_cmp.pattern_cmp.launches = 0
    merge_path.merge_path_ranks.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each ported kernel since the last reset."""
    from repro_torch.kernels import merge_path, pattern_cmp, prefix_pack, window_gather

    return {
        "prefix_pack": prefix_pack.prefix_pack.launches,
        "window_gather": window_gather.window_gather.launches,
        "pattern_cmp": pattern_cmp.pattern_cmp.launches,
        "merge_path": merge_path.merge_path_ranks.launches,
    }
