"""Logical-axis -> mesh-axis sharding rules with divisibility fallback
(``repro.sharding.rules``'s counterpart).

Every parameter carries logical axes (``repro_torch.models.params``).  Rules
map each logical axis to candidate mesh axes under a :class:`ShardingPolicy`;
a dim is sharded only when its size divides the product of the mesh axes
(otherwise it falls back to replication — e.g. hymba's 25 q-heads or MQA's
single KV head).

Conventions (MaxText-style):
  * TP ("model"):  vocab, mlp, q_proj, kv_proj, expert_mlp, ssm_inner
  * FSDP (data axes): embed (the dim shared by every weight)
  * experts: EP over "model" only when policy.moe_ep and divisible, else
    replicated (TP-inside-expert via expert_mlp stays on "model")
  * decode KV caches shard the *sequence* dim (flash-decoding style) so
    MQA/GQA with few KV heads still scales.

The rules are pure functions of axis names and sizes.  The port's mesh is
:class:`Mesh`, a descriptor of those two (not a ``DeviceMesh``, which would
need a process group of its size), and a spec is :class:`P`, a tuple of one
entry a dim as ``jax.sharding.PartitionSpec`` holds it, so the specs equal
``repro``'s entry for entry (``tests/test_torch_train_sharding.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.config import ArchConfig, ShardingPolicy
from repro_torch.models.params import is_def, tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's axis names and sizes: all the rules read of it."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} "
                             "differ in length")

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape, strict=True))


def make_mesh(shape, axis_names) -> Mesh:
    """``jax.make_mesh``'s counterpart: a :class:`Mesh` of these sizes."""
    return Mesh(tuple(int(s) for s in shape), tuple(axis_names))


class P(tuple):
    """A partition spec: one entry a dim, None (replicated), a mesh axis
    name or a tuple of names; a one-name tuple is stored as the name, as
    ``PartitionSpec`` stores it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _candidates(logical: Optional[str], policy: ShardingPolicy):
    if logical is None or logical == "layers":
        return ()
    if logical == "embed":
        return policy.fsdp_axes
    if logical in ("vocab", "mlp", "q_proj", "kv_proj", "expert_mlp",
                   "ssm_inner"):
        return policy.tp_axes
    if logical == "experts":
        return policy.tp_axes if policy.moe_ep else ()
    return ()


def resolve_axes(
    axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh: Mesh,
    policy: ShardingPolicy,
) -> P:
    """One param's logical axes -> partition spec (with fallbacks)."""
    sizes = mesh.axis_sizes
    used = set()
    # embedding table (has a "vocab" axis): optionally keep d_model
    # unsharded so logits never contract over a sharded dim (embed_fsdp)
    if "vocab" in axes and not policy.embed_fsdp:
        policy = dataclasses.replace(policy, fsdp_axes=())
    # EP and TP both want "model": give experts priority when enabled
    order = list(range(len(axes)))
    if policy.moe_ep and "experts" in axes:
        order.sort(key=lambda i: 0 if axes[i] == "experts" else 1)
    chosen: dict = {}
    for i in order:
        cand = tuple(
            a for a in _candidates(axes[i], policy)
            if a in sizes and a not in used
        )
        if not cand:
            chosen[i] = None
            continue
        prod = math.prod(sizes[a] for a in cand)
        if shape[i] % prod == 0 and prod > 1:
            chosen[i] = cand if len(cand) > 1 else cand[0]
            used.update(cand)
        else:
            # try single best axis
            best = None
            for a in cand:
                if shape[i] % sizes[a] == 0 and sizes[a] > 1:
                    best = a
                    break
            chosen[i] = best
            if best is not None:
                used.add(best)
    return P(*(chosen.get(i) for i in range(len(axes))))


def param_specs(model, mesh: Mesh, policy: ShardingPolicy):
    """Spec tree matching ``model.param_defs()``."""
    return tree_map(lambda d: resolve_axes(d.axes, d.shape, mesh, policy),
                    model.param_defs(), is_leaf=is_def)


def _dp_axes(mesh: Mesh, policy: ShardingPolicy):
    sizes = mesh.axis_sizes
    return tuple(a for a in policy.dp_axes if a in sizes)


def batch_specs(cfg: ArchConfig, mesh: Mesh, policy: ShardingPolicy,
                batch: int, kind: str = "train"):
    """Input batch specs: {tokens|embeds, labels} or decode inputs."""
    sizes = mesh.axis_sizes
    dp = _dp_axes(mesh, policy)
    prod = math.prod(sizes[a] for a in dp) if dp else 1
    bspec = dp if (dp and batch % prod == 0) else None
    if bspec is None and dp:
        # try fewer axes
        for k in range(len(dp) - 1, 0, -1):
            sub = dp[:k]
            if batch % math.prod(sizes[a] for a in sub) == 0:
                bspec = sub
                break
    b = bspec if bspec else None
    if kind == "decode":
        return {
            "tokens": P(b, None),
            "pos": P(b),
        }
    if cfg.input_mode == "embeddings" and kind in ("train", "prefill"):
        return {
            "embeds": P(b, None, None),
            "labels": P(b, None),
        }
    return {"tokens": P(b, None), "labels": P(b, None)}


def cache_specs(cfg: ArchConfig, mesh: Mesh, policy: ShardingPolicy,
                batch: int, long_context: bool = False):
    """Decode-cache spec resolver: fn(path, array) -> spec, ``path`` in
    ``jax.tree_util.keystr``'s form (``"['k']"``, ``"['layer_00'][0]"``).

    KV caches shard batch over dp axes when divisible and the *sequence* dim
    over kv_seq_axes (flash-decoding style — works for MQA kv=1);
    long_context (B=1) pushes sequence over data+model.  Handles the three
    cache layouts: stacked (L,B,T,KV,hd), windowed per-layer (B,W,KV,hd) and
    SSM/conv state stacks.
    """
    sizes = mesh.axis_sizes
    dp = _dp_axes(mesh, policy)
    prod = math.prod(sizes[a] for a in dp) if dp else 1
    b = dp if (dp and batch % prod == 0) else None
    if long_context:
        seq_axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
        b = None
    else:
        seq_axes = tuple(a for a in policy.kv_seq_axes if a in sizes)
    seq_prod = math.prod(sizes[a] for a in seq_axes) if seq_axes else 1
    tp = tuple(a for a in policy.tp_axes if a in sizes)
    tp_prod = math.prod(sizes[a] for a in tp) if tp else 1

    def seq_ok(t):
        return (seq_axes or None) if (seq_axes and t % seq_prod == 0) else None

    def spec_of(path: str, x) -> P:
        shape = x.shape
        if cfg.family == "ssm":
            return P(b, *([None] * (len(shape) - 1)))
        if "ssm" in path or "conv" in path:
            inner_dim = shape[-1] if "conv" in path else shape[-2]
            tp_ok = tp if (tp and inner_dim % tp_prod == 0) else None
            if len(shape) == 4 and "conv" in path:
                return P(None, b, None, tp_ok)
            return P(None, b, tp_ok, None)
        if len(shape) == 5:  # stacked (L, B, T, KV, hd)
            return P(None, b, seq_ok(shape[2]), None, None)
        if len(shape) == 4:  # windowed (B, W, KV, hd)
            return P(b, seq_ok(shape[1]), None, None)
        return P(*([None] * len(shape)))

    return spec_of


def keystr_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts/tuples, ``path`` as
    ``jax.tree_util.keystr`` writes it; the tree's structure is kept."""
    if isinstance(tree, dict):
        return {k: keystr_map(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [keystr_map(fn, t, f"{path}[{i}]") for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(path, tree)
