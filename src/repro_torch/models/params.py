"""Parameter definitions of the port (``repro.models.params``'s counterpart).

Modules declare parameters as nested dicts of :class:`ParamDef` (shape +
logical axes + init).  From one definition tree come:

* ``init_params(defs, generator, dtype, device)`` — materialized tensors;
* ``abstract_params(defs, dtype)`` — tensors on the ``meta`` device, the
  counterpart of ``jax.ShapeDtypeStruct`` (shapes and dtypes, no memory);
* ``axes_tree(defs)`` — the logical-axis tree; ``count_params(defs)``.

The init kinds are ``repro``'s: ``normal`` × ``scale``, ``zeros``, ``ones``
and ``scaled`` = N(0, 1) / sqrt(fan_in) with fan_in = ``shape[0]``.
``stack_layer_defs`` prefixes the layer axis, so a stacked parameter's
fan_in is the layer count, as in ``repro``.  Values come from a
``torch.Generator``: the distribution is ``repro``'s, the stream is not
(``params_from_reference`` in ``models/model.py`` carries ``repro``'s
values across).  Each tensor is drawn directly in its target dtype on its
device, never as a float32 temporary.

Trees are plain nested dicts (and tuples for recurrent states, NamedTuples
such as ``TrainState``); leaves are visited in sorted-key order, as
``jax.tree`` flattens a dict, and a tuple's in field order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = is_def):
    """``fn`` over the leaves of nested dicts/lists/tuples (``rest``: trees
    of the same structure)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, t in enumerate(tree)]
        # a NamedTuple (``TrainState``) takes its fields as arguments
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Callable = is_def) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def tensor_map(fn: Callable, tree, *rest):
    """``tree_map`` over a tree whose leaves are tensors."""
    return tree_map(fn, tree, *rest, is_leaf=is_tensor)


def tensor_leaves(tree) -> List[torch.Tensor]:
    """A tensor tree's leaves in ``jax.tree`` order."""
    return tree_leaves(tree, is_leaf=is_tensor)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure (tensor leaves) holding ``leaves``."""
    it = iter(leaves)
    out = tensor_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _materialize(defn: ParamDef, generator, dtype, device) -> torch.Tensor:
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=dtype, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=dtype, device=device)
    if defn.init == "scaled":
        fan_in = defn.shape[0] if defn.shape else 1
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        scale = defn.scale
    out = torch.randn(defn.shape, dtype=dtype, device=device, generator=generator)
    return out.mul_(scale)


def init_params(defs, generator: torch.Generator, dtype: torch.dtype, device):
    """Materialize a ParamDef tree on ``device`` (leaves drawn from
    ``generator`` in flattening order)."""
    return tree_map(lambda d: _materialize(d, generator, dtype, device), defs)


def abstract_params(defs, dtype: torch.dtype):
    """Meta-device tensors of every parameter's shape and dtype."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def axes_tree(defs):
    return tree_map(lambda d: d.axes, defs)


def count_params(defs) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))


def stack_layer_defs(defn, num_layers: int):
    """Prefix every ParamDef with a leading stacked 'layers' axis."""
    return tree_map(lambda d: ParamDef((num_layers, *d.shape), ("layers", *d.axes),
                                       d.init, d.scale), defn)
