"""Gradient compression for data parallelism (``repro.train.compression``'s
counterpart).

At many nodes the cross-node all-reduce is the scarce resource; the standard
tricks are quantization and sparsification with error feedback.  Pure
functions plus compressed all-reduces over a ``torch.distributed`` group, so
they compose with any training loop:

  * int8 symmetric quantization (per-tensor scale): 4x fewer bytes on the
    wire; decompress-after-reduce keeps the accumulator exact per rank.
  * top-k sparsification with error feedback (memory carried between steps).

The int8 all-reduce quantizes, all_gathers the int8 payload and the scales
(cheaper than an all_reduce at int8 width) and reduces locally in float32.
``repro``'s take an axis name inside ``shard_map``; these take the group
(the initialized world when None).  ``torch.round`` rounds half to even, as
``jnp.round`` does.  ``lax.top_k`` keeps the lower index among equal
magnitudes, which ``torch.topk`` does not promise, so the top-k is a stable
descending sort of the magnitudes.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_sparsify(x: torch.Tensor, ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-|ratio| entries (by magnitude); returns (values, indices),
    ties to the lower index."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    _, idx = torch.sort(torch.abs(flat), descending=True, stable=True)
    idx = idx[:k]
    return flat[idx], idx


def topk_restore(shape, values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = math.prod(int(s) for s in shape)
    flat = torch.zeros((n,), dtype=values.dtype, device=values.device)
    flat[idx] = values
    return flat.reshape(tuple(shape))


def compressed_allreduce_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean all-reduce over ``group`` with an int8 wire format."""
    q, scale = quantize_int8(x)
    size = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(size)]  # int8 payload: 4x cheaper
    ss = [torch.empty_like(scale) for _ in range(size)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    deq = torch.stack(qs).to(torch.float32) * torch.stack(ss).reshape((-1,) + (1,) * x.ndim)
    return torch.mean(deq, dim=0)


def compressed_allreduce_topk(
    x: torch.Tensor, group, ratio: float, error: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsified mean all-reduce with error feedback.

    Returns (reduced, new_error): new_error carries what was dropped locally
    (added back into the next step's gradient — the standard EF-SGD trick).
    """
    acc = x + error
    vals, idx = topk_sparsify(acc, ratio)
    sparse = topk_restore(x.shape, vals, idx)
    new_error = acc - sparse
    reduced = sparse.clone()
    dist.all_reduce(reduced, op=dist.ReduceOp.SUM, group=group)
    return reduced / dist.get_world_size(group), new_error
