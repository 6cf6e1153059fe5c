"""Elastic scaling: re-derive a mesh for the devices that survive
(``repro.runtime.elastic``'s counterpart).

Restart-based elasticity: on node loss the job restarts on the remaining N'
devices; ``replan_mesh`` picks the closest (data, model) factorization, and
the checkpoint manager's global-view arrays restore onto any device
(``CheckpointManager.restore``).  The mesh is the port's descriptor
(``sharding.Mesh``: axis names and sizes), so a plan needs no devices.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.sharding.rules import Mesh, make_mesh


def replan_mesh(
    num_devices: int,
    prefer_model: int = 16,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """Closest 2-D mesh for ``num_devices``: model axis <= prefer_model and
    dividing num_devices; data gets the rest."""
    model = 1
    for cand in range(min(prefer_model, num_devices), 0, -1):
        if num_devices % cand == 0:
            model = cand
            break
    data = num_devices // model
    return make_mesh((data, model), axis_names)


def surviving_devices(all_devices: Sequence, lost: Sequence[int]):
    """Filter out failed devices by index (``torch.device.index``; a
    simulation hook for tests)."""
    lost_set = set(lost)
    return [d for d in all_devices if d.index not in lost_set]
