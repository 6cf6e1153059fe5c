"""Where a tree's leaves lie on D ranks: the port's counterpart of a tree of
``NamedSharding``s on a ``(D, 1)`` mesh.

A spec (``rules.P``) names, for each dim, the mesh axes it is cut over.  On
a mesh whose only axis of more than one device is a data axis of D devices,
that is at most one dim a leaf, cut into D equal contiguous slices: rank
``r`` holds slice ``r`` (``jax``'s layout of a dim sharded over one axis).
A leaf whose spec names no such axis is whole on every rank.  A
:class:`Placement` holds, for each leaf of the tree in ``jax.tree`` order,
the dim it is cut along (or None), and the ranks; it cuts whole leaves
into this rank's slices (``shard``) and puts the slices back together on
every rank (``unshard``).  A mesh with two axes of more than one device
(tensor parallelism) is refused: the port runs data parallelism with FSDP
only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.distributed import SINGLE, Ranks, gather_along
from repro_torch.models.params import tensor_leaves, tree_leaves, tree_unflatten
from repro_torch.sharding.rules import Mesh, P


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _cut_dim(spec: P, sizes: dict, d: int) -> Optional[int]:
    cut = None
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        n = math.prod(sizes[a] for a in names)
        if n == 1:
            continue
        if n != d or cut is not None:
            raise ValueError(f"spec {spec} cuts a leaf over {n} of {d} ranks or along "
                             "two dims: only data parallelism over every rank is ported")
        cut = i
    return cut


@dataclasses.dataclass(frozen=True)
class Placement:
    """Each leaf's cut dim (None: whole on every rank), in leaf order, and
    the ranks the cuts are over."""

    dims: Tuple[Optional[int], ...]
    ranks: Ranks = SINGLE

    def _check(self, leaves):
        if len(leaves) != len(self.dims):
            raise ValueError(f"a tree of {len(leaves)} leaves against a placement of "
                             f"{len(self.dims)}")

    def shard(self, tree):
        """This rank's slices of a tree of whole leaves (copies; a whole
        leaf stays the same tensor)."""
        leaves = tensor_leaves(tree)
        self._check(leaves)
        d, r = self.ranks.size, self.ranks.rank
        out = []
        for t, dim in zip(leaves, self.dims, strict=True):
            if dim is None or d == 1:
                out.append(t)
                continue
            n = t.shape[dim]
            if n % d:
                raise ValueError(f"a dim of {n} does not split over {d} ranks")
            out.append(t.narrow(dim, r * (n // d), n // d).clone())
        return tree_unflatten(tree, out)

    def unshard(self, tree):
        """The whole leaves of a tree of this rank's slices, on every rank
        (an all-gather a cut leaf; every rank must call it)."""
        leaves = tensor_leaves(tree)
        self._check(leaves)
        return tree_unflatten(tree, [t if dim is None else gather_along(t, dim, self.ranks)
                                     for t, dim in zip(leaves, self.dims, strict=True)])

    def whole_shapes(self, tree):
        """The whole shape of each leaf of a tree of slices."""
        leaves = tensor_leaves(tree)
        self._check(leaves)
        out = []
        for t, dim in zip(leaves, self.dims, strict=True):
            shape = list(t.shape)
            if dim is not None:
                shape[dim] *= self.ranks.size
            out.append(tuple(shape))
        return out

    def take(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of whole leaf ``i`` (a view)."""
        dim = self.dims[i]
        if dim is None or self.ranks.size == 1:
            return t
        n = t.shape[dim] // self.ranks.size
        return t.narrow(dim, self.ranks.rank * n, n)


def placement(spec_tree, mesh: Mesh, ranks: Ranks = SINGLE) -> Placement:
    """The placement of a spec tree (``P`` leaves) on ``mesh`` over
    ``ranks``, whose size must be the mesh's."""
    if mesh.size != ranks.size:
        raise ValueError(f"a mesh of {mesh.size} devices over {ranks.size} rank(s): "
                         "one rank a device")
    sizes = mesh.axis_sizes
    return Placement(tuple(_cut_dim(s, sizes, ranks.size)
                           for s in tree_leaves(spec_tree, is_leaf=_is_spec)), ranks)
