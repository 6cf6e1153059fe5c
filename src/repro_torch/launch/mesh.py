"""Production mesh definitions (``repro.launch.mesh``'s counterpart).

Each returns the port's ``sharding.Mesh``, the axis names and sizes that
the sharding rules read.  The production mesh is ``repro``'s: a single pod
is 16x16 = 256 chips over ``("data", "model")``, and a multi-pod mesh adds
a leading ``"pod"`` axis (2 pods = 512 chips); the dry-run sizes its cells
on them.  The SA pipeline flattens its mesh into one shard axis
(``"sa"``).  The local mesh is over the ranks of the initialized process
group (one rank a device), or ``(1, 1)`` on one process.
"""
from __future__ import annotations

from repro_torch.sharding.rules import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_sa_mesh(num_shards: int | None = None) -> Mesh:
    """Flat 1-D mesh for the suffix-array pipeline: ``num_shards`` shards,
    or one a rank of the process group when None."""
    if num_shards is None:
        from repro_torch.core.distributed import world

        num_shards = world().size
    return make_mesh((num_shards,), ("sa",))


def make_local_mesh(shape=None, axes=("data", "model"), group=None) -> Mesh:
    """The mesh over the ranks of ``group`` (the initialized world; one
    process when none is): ``(D, 1)`` by default."""
    from repro_torch.core.distributed import world

    n = world(group).size
    if shape is None:
        shape = (n, 1)
    mesh = make_mesh(shape, axes)
    if mesh.size != n:
        raise ValueError(f"a mesh of {mesh.size} devices over {n} rank(s)")
    return mesh
