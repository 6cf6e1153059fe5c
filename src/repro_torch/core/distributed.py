"""Shuffle helpers of the SA pipeline at world size 1.

The port of ``repro.core.distributed`` for one shard: the capacity-padded
bucket scatter keeps its overflow drops, ``slot`` routing and dump bucket;
the all_to_all ``exchange`` is the identity and ``sample_splitters`` finds
no splitters.  World size > 1 is ROADMAP item 10.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bucket_scatter(
    values: torch.Tensor,
    bucket: torch.Tensor,
    num_buckets: int,
    capacity: int,
    fill: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter rows of ``values`` (n, W) into a (num_buckets, capacity, W)
    buffer, rows of one bucket in array order.

    Overflowing rows are dropped (counted).  Returns (buffer, slot, dropped):
    ``slot[i]`` is the flat buffer slot of row i (or num_buckets*capacity if
    dropped) so responses can be routed back to requesters.
    """
    n, w = values.shape
    dev = values.device
    order = torch.argsort(bucket, stable=True)
    sb = bucket[order].long()
    hist = torch.bincount(bucket.long(), minlength=num_buckets)
    start = torch.cumsum(hist, 0) - hist
    pos = torch.arange(n, device=dev) - start[sb]
    ok = pos < capacity
    flat = torch.where(ok, sb * capacity + pos, num_buckets * capacity)
    buf = torch.full((num_buckets * capacity + 1, w), fill, dtype=values.dtype,
                     device=dev)
    buf[flat] = values[order]
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    slot[order] = flat.to(torch.int32)
    dropped = torch.sum(~ok).to(torch.int32)
    return (buf[: num_buckets * capacity].reshape(num_buckets, capacity, w),
            slot, dropped)


def exchange(buf: torch.Tensor) -> torch.Tensor:
    """all_to_all of a (D, capacity, W) buffer; the identity at D = 1."""
    if buf.shape[0] != 1:
        raise NotImplementedError(
            "exchange across shards is ROADMAP.md item 10")
    return buf


def lex_bucket(
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    split_hi: torch.Tensor,
    split_lo: torch.Tensor,
) -> torch.Tensor:
    """bucket = #splitters strictly less than key (lexicographic 2-word)."""
    gt = (key_hi[:, None] > split_hi[None, :]) | (
        (key_hi[:, None] == split_hi[None, :])
        & (key_lo[:, None] > split_lo[None, :])
    )
    return torch.sum(gt, dim=1).to(torch.int32)


def sample_splitters(
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    num_samples: int,
    num_shards: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TeraSort-style splitter estimation: D-1 quantiles of a systematic
    sample of every shard's keys.  At D = 1 there are none: the splitters
    are empty and every key lands in bucket 0."""
    if num_shards != 1:
        raise NotImplementedError(
            "splitters across shards are ROADMAP.md item 10")
    return key_hi[:0], key_lo[:0]


def run_starts(eq_prev: torch.Tensor) -> torch.Tensor:
    """Given eq_prev[i] = (row i equals row i-1), return start index of each
    run (``group id``): g[i] = i at run starts, propagated by cumulative max."""
    n = eq_prev.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=eq_prev.device)
    cand = torch.where(eq_prev, -1, idx)
    return torch.cummax(cand, dim=0).values


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32 words -> one int64 whose order is the (hi, lo) order:
    hi * 2^32 + (lo + 2^31) covers every int32 pair without overflow."""
    return hi.long() * (1 << 32) + (lo.long() + (1 << 31))


def lex_sort(keys, carry=()):
    """``lax.sort(keys + carry, num_keys=len(keys))`` for int32 tensors.

    Keys are most significant first; equal keys keep their order, as
    ``lax.sort`` does (:func:`lex_order`).  Returns the sorted keys
    followed by the carried tensors.
    """
    keys, carry = list(keys), list(carry)
    perm = lex_order(keys)
    return [t[perm] for t in keys + carry]


def lex_order(keys) -> torch.Tensor:
    """The stable permutation that sorts rows by ``keys``, most significant
    first: ``np.lexsort(keys[::-1])`` for int32, int64 or bool tensors.

    Adjacent int32 keys are packed in pairs (:func:`_pair_key`); each sort
    is stable, from the least significant key up.
    """
    keys = [k.to(torch.int32) if k.dtype == torch.bool else k for k in keys]
    perm = None
    i = len(keys)
    while i > 0:
        if i >= 2 and keys[i - 1].dtype == keys[i - 2].dtype == torch.int32:
            key = _pair_key(keys[i - 2], keys[i - 1])
            i -= 2
        else:
            key = keys[i - 1]
            i -= 1
        if perm is not None:
            key = key[perm]
        p = torch.sort(key, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm
