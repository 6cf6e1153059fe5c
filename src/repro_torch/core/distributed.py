"""Shuffle helpers and collectives of the SA pipelines.

The port of ``repro.core.distributed``.  One process is one rank, the
counterpart of one device of the JAX package's 1-D ``"sa"`` mesh, and
:class:`Ranks` is the counterpart of its axis name: the process group, this
process's rank in it and its size.  At one rank (:data:`SINGLE`, the handle
when no process group is initialized) no collective runs: ``exchange`` is
the identity and ``sample_splitters`` finds no splitters.  At D ranks the
collectives go over ``torch.distributed``, each in one function here:
``exchange`` (``lax.all_to_all``), ``all_gather`` (``lax.all_gather``),
``psum`` and ``pmax``, and the out-of-core build's two for what rank 0 owns:
``broadcast_object`` (rank 0's decision, such as a resume's adoption or
refusal) and ``barrier`` (rank 0's files written before the others read).  They take tensors where they lie: over NCCL on the
ranks' cards, over gloo on the CPU or on the card, whose tensors gloo stages
through host memory itself (one card's ranks share it over gloo: NCCL takes
one rank a card).  The capacity-padded bucket scatter keeps its overflow
drops, ``slot`` routing and dump bucket.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

# Bytes this process has sent the other ranks through ``exchange``,
# ``all_gather`` and ``reduce_scatter`` since the last :func:`reset_traffic`,
# and its exchanges.
TRAFFIC = {"exchange_bytes": 0, "exchanges": 0, "gather_bytes": 0, "scatter_bytes": 0}


def reset_traffic() -> None:
    for key in TRAFFIC:
        TRAFFIC[key] = 0


@dataclass(frozen=True)
class Ranks:
    """The ranks a build runs on: the counterpart of the JAX package's mesh
    axis.  ``group`` is a ``torch.distributed`` process group (``None``: the
    default group), ``rank`` this process's rank in it, ``size`` its size."""

    group: Any = None
    rank: int = 0
    size: int = 1


SINGLE = Ranks()


def world(group: Optional[Any] = None) -> Ranks:
    """The ranks of ``group``, or of the initialized world when ``group`` is
    ``None`` (as the JAX package's ``mesh=None`` takes every device); the
    single-rank handle when no process group is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed "
                             "is not initialized")
        return SINGLE
    return Ranks(group, dist.get_rank(group), dist.get_world_size(group))


def broadcast_object(obj: Any, ranks: Ranks = SINGLE, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (a small picklable record) on every rank:
    ``obj`` itself at one rank.  What the other ranks pass is ignored.  Over
    NCCL the pickled bytes travel on the rank's current card, which
    ``launch.sa_build.init_ranks`` sets."""
    if ranks.size == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(ranks.group, src)
                               if ranks.group is not None else src,
                               group=ranks.group)
    return box[0]


def barrier(ranks: Ranks = SINGLE) -> None:
    """Wait for every rank: what rank 0 wrote before its barrier is there
    for the others after theirs.  Nothing at one rank."""
    if ranks.size == 1:
        return
    import torch.distributed as dist

    dist.barrier(group=ranks.group)


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


def exchange(buf: torch.Tensor, ranks: Ranks = SINGLE) -> torch.Tensor:
    """all_to_all of a (D, capacity, W) buffer: ``out[j]`` is what rank j
    sent this rank (``lax.all_to_all(..., tiled=True)``'s layout); the
    identity at one rank.  One ``all_to_all_single`` with equal splits."""
    if buf.shape[0] != ranks.size:
        raise ValueError(f"exchange: a buffer of {buf.shape[0]} buckets over "
                         f"{ranks.size} rank(s)")
    if ranks.size == 1:
        return buf
    import torch.distributed as dist

    send = buf.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out.view(-1), send.view(-1), group=ranks.group)
    TRAFFIC["exchange_bytes"] += (send.numel() * send.element_size()
                                  * (ranks.size - 1) // ranks.size)
    TRAFFIC["exchanges"] += 1
    return out


def all_gather(x: torch.Tensor, ranks: Ranks = SINGLE) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), stacked in rank order:
    ``lax.all_gather``; ``x[None]`` at one rank."""
    if ranks.size == 1:
        return x[None]
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty((ranks.size, *x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=ranks.group)
    TRAFFIC["gather_bytes"] += x.numel() * x.element_size() * (ranks.size - 1)
    return out


def reduce_scatter(x: torch.Tensor, ranks: Ranks = SINGLE) -> torch.Tensor:
    """This rank's block of the sum over the ranks of ``x`` (D, ...):
    ``sum_j x_j[rank]``, ``x[0]`` at one rank.  One ``reduce_scatter_tensor``
    (gloo takes CUDA tensors for it too, staged through host memory)."""
    if x.shape[0] != ranks.size:
        raise ValueError(f"reduce_scatter: {x.shape[0]} blocks over {ranks.size} rank(s)")
    if ranks.size == 1:
        return x[0]
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    # the blocks flat: the op cuts dim 0 of its input into D
    dist.reduce_scatter_tensor(out.view(-1), x.view(-1), group=ranks.group)
    TRAFFIC["scatter_bytes"] += out.numel() * out.element_size() * (ranks.size - 1)
    return out


def gather_along(x: torch.Tensor, dim: int, ranks: Ranks = SINGLE) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order: the whole of a leaf cut into D slices along ``dim``."""
    if ranks.size == 1:
        return x
    parts = all_gather(x.movedim(dim, 0), ranks)  # (D, n, ...)
    return parts.reshape(-1, *parts.shape[2:]).movedim(0, dim)


def scatter_along(x: torch.Tensor, dim: int, ranks: Ranks = SINGLE) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over the ranks of ``x``:
    :func:`reduce_scatter` of a leaf cut into D slices along ``dim``."""
    if ranks.size == 1:
        return x
    n = x.shape[dim]
    if n % ranks.size:
        raise ValueError(f"a dim of {n} does not split over {ranks.size} ranks")
    blocks = x.movedim(dim, 0).reshape(ranks.size, n // ranks.size, *x.shape[:dim],
                                       *x.shape[dim + 1:])
    return reduce_scatter(blocks, ranks).movedim(0, dim)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward is the reduce-scatter (sum) of
    the incoming grad: each rank gets the grads every rank's rows took."""

    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return gather_along(x, 0, ranks)

    @staticmethod
    def backward(ctx, grad):
        return scatter_along(grad, 0, ctx.ranks), None


def gather_rows(x: torch.Tensor, ranks: Ranks = SINGLE) -> torch.Tensor:
    """Every rank's rows of ``x`` (equal shapes), stacked in rank order along
    dim 0, differentiably: the grad of a rank's rows is the sum of what every
    rank's use of them gives."""
    if ranks.size == 1:
        return x
    return _GatherRows.apply(x, ranks)


def _all_reduce(x: torch.Tensor, ranks: Ranks, op: str) -> torch.Tensor:
    if ranks.size == 1:
        return x
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=ranks.group)
    return out


def psum(x: torch.Tensor, ranks: Ranks = SINGLE) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the ranks (``x`` at one rank)."""
    return _all_reduce(x, ranks, "SUM")


def pmax(x: torch.Tensor, ranks: Ranks = SINGLE) -> torch.Tensor:
    """The largest ``x`` over the ranks (``x`` at one rank)."""
    return _all_reduce(x, ranks, "MAX")


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


def partition(
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    split_hi: torch.Tensor,
    split_lo: torch.Tensor,
    cfg,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The range partition: :func:`lex_bucket`, and the dump bucket
    ``len(split_hi) + 1`` (= D) where ``valid`` is False.

    Under ``cfg.use_pallas`` with splitters (D > 1) the buckets come from
    the ``bucket_hist`` kernel (its dispatcher: the plain version on a CPU
    tensor); its histogram counts every key, so callers count the masked
    buckets themselves.  At one rank there is no splitter and nothing
    launches.
    """
    if cfg.use_pallas and split_hi.numel():
        from repro_torch.kernels import ops as kops  # the TeraSort partition

        bucket, _ = kops.bucket_hist(key_hi.contiguous(), key_lo.contiguous(),
                                     split_hi.contiguous(), split_lo.contiguous())
    else:
        bucket = lex_bucket(key_hi, key_lo, split_hi, split_lo)
    if valid is None:
        return bucket
    return torch.where(valid, bucket, split_hi.shape[0] + 1).to(torch.int32)


def sample_splitters(
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    num_samples: int,
    ranks: Ranks = SINGLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TeraSort-style splitter estimation: a systematic sample of every
    rank's keys, all-gathered and sorted, and its D-1 quantiles, the same on
    every rank.  At one rank there are none: the splitters are empty and
    every key lands in bucket 0.

    The sample positions are computed in int64; the JAX package computes
    ``arange(num_samples) * n`` in int32, which wraps once it passes 2^31.
    """
    d = ranks.size
    if d == 1:
        return key_hi[:0], key_lo[:0]
    n = key_hi.shape[0]
    idx = torch.arange(num_samples, device=key_hi.device) * n // num_samples
    idx = idx.clamp(0, n - 1)
    samples = all_gather(torch.stack([key_hi[idx], key_lo[idx]]), ranks)
    s_hi, s_lo = lex_sort([samples[:, 0].reshape(-1), samples[:, 1].reshape(-1)])
    q = torch.arange(1, d, device=key_hi.device) * num_samples  # total // d
    return s_hi[q], s_lo[q]


def run_starts(eq_prev: torch.Tensor) -> torch.Tensor:
    """Given eq_prev[i] = (row i equals row i-1), return start index of each
    run (``group id``): g[i] = i at run starts, propagated by cumulative max.
    A card launches the ``run_groups`` kernel; the CPU takes its plain
    version."""
    from repro_torch.kernels import ops as kops

    return kops.run_starts(eq_prev)


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
