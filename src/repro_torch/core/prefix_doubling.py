"""Prefix doubling (Manber–Myers) over the rank store.

The port of ``repro.core.prefix_doubling``.  The scheme's tie-break loop
refines K tokens a round, O(maxLCP / K) rounds, which degenerates on highly
repetitive text (the paper's "ATATATAT" anecdote); prefix doubling converges
in O(log n) rounds.  The in-memory store holds Manber–Myers **ranks**
instead of tokens, and every round is one ``mget_scalar`` (rank[pos + h]),
one sort of the same (rank, rank2, pos) records and one ``scatter_update``
write-back.

Rank convention: rank(suffix) = global position in the sorted order of the
first member of its still-tied run (monotone, unique once resolved).  Each
rank holds a shard of the text and of the rank store (one process a rank;
one rank without a process group).  At D ranks a run may span rank edges:
:func:`_global_rerank` chains run starts over the ranks' all-gathered
summaries, as the JAX package chains them over its devices; at one rank
this reduces to ``run_starts``.

Translations from the JAX package: ``lax.while_loop`` is a host loop whose
condition reads one device scalar a round, summed over the ranks
(:func:`_round` is its body); ``lax.sort(num_keys=3)`` is
:func:`repro_torch.core.distributed.lex_sort`; the O(D) ``fori_loop`` chain
runs on the host.  The byte counters are summed in int64, where the JAX
package sums them in int32 (its ``shuffles_bytes`` wraps once a build's
shuffle passes 2^31 bytes).  At one rank no kernel runs on this path: the
initial records come from ``encoding.make_records_text``, as in the JAX
package; at D ranks under ``cfg.use_pallas`` the sample sort's partition is
the ``bucket_hist`` kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.distributed import (
    Ranks,
    all_gather,
    bucket_scatter,
    exchange,
    lex_sort,
    partition,
    psum,
    run_starts,
    sample_splitters,
    world,
)
from repro_torch.core.pipeline import gathered, local_shard, plan
from repro_torch.core.store import StoreSpec, mget_scalar, scatter_update, token_bytes
from repro_torch.core.types import KEY_SENTINEL, Footprint, SAResult
from repro_torch.device import resolve_device


def _global_sort3(rank, rank2, pos, cap, samples, ranks: Ranks, cfg: SAConfig):
    """Sample-sort (rank, rank2, pos) records across the ranks.

    Returns the sorted (rank, rank2, pos), ``d * cap`` long on each rank,
    and the drop count.  Equal (rank, rank2) pairs colocate (the partition
    is strict-less-than).  Sentinel padding records go to a local dump
    bucket: never shipped, never counted as drops.
    """
    d = ranks.size
    valid = rank != KEY_SENTINEL
    s1, s2 = sample_splitters(
        torch.where(valid, rank, KEY_SENTINEL), torch.where(valid, rank2, KEY_SENTINEL),
        samples, ranks)
    bucket = partition(rank, rank2, s1, s2, cfg, valid)
    rec = torch.stack([rank, rank2, pos], dim=1)
    buf, slot, _ = bucket_scatter(rec, bucket, d + 1, cap, KEY_SENTINEL)
    drop = torch.sum(valid & (slot >= d * cap))
    del rec, bucket, slot
    recv = exchange(buf[:d], ranks).reshape(d * cap, 3)
    r1, r2, p = lex_sort([recv[:, i].contiguous() for i in range(3)])
    return r1, r2, p, drop


def _global_rerank(k1, k2, ranks: Ranks):
    """Global run-start ranks for rank-locally sorted (k1, k2) keys,
    sentinel records last (``repro.core.prefix_doubling._global_rerank``).

    Returns (rank, tied, count): rank[i] = global position of the first
    member of i's run (KEY_SENTINEL for sentinel slots); tied[i] = run size
    > 1.  At one rank a run starts and ends on this rank: ``run_starts``.
    At D ranks each rank's summary (valid count, first and last keys, the
    local start of its last run) is all-gathered and the run starts are
    chained over the ranks on the host, with the JAX package's two edge
    terms: a first record that continues the previous rank's run, and a
    last record whose run the next rank's first record continues.
    """
    valid = k1 != KEY_SENTINEL
    c = torch.sum(valid)
    eq = torch.zeros(k1.shape, dtype=torch.bool, device=k1.device)
    eq[1:] = (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1]) & valid[1:] & valid[:-1]
    ls = run_starts(eq)  # local index of run start
    tied = eq.clone()
    tied[:-1] |= eq[1:]
    if ranks.size == 1:
        return torch.where(valid, ls, KEY_SENTINEL), tied & valid, c

    # --- per-rank summaries ------------------------------------------------
    last = (c - 1).clamp(min=0)
    has = c > 0
    firsts_lasts = torch.stack([k1[0], k2[0], k1[last], k2[last]]).to(torch.int32)
    summary = torch.cat([
        c.to(torch.int32)[None],
        torch.where(has, firsts_lasts, KEY_SENTINEL),
        ls[last].to(torch.int32)[None],
    ])
    counts, fk1, fk2, lk1, lk2, lrs = all_gather(summary, ranks).cpu().T.tolist()
    offs = [sum(counts[:j]) for j in range(ranks.size)]  # exclusive

    # --- chain run starts across ranks (O(D), the same on every rank) -------
    starts = []
    pk1 = pk2 = KEY_SENTINEL
    pstart, phas = 0, False
    for j in range(ranks.size):
        hj = counts[j] > 0
        cont = phas and hj and fk1[j] == pk1 and fk2[j] == pk2
        sj = pstart if cont else offs[j]
        starts.append(sj)
        if hj:  # a rank whose last run starts at 0 is one run
            pk1, pk2 = lk1[j], lk2[j]
            pstart = sj if lrs[j] == 0 else offs[j] + lrs[j]
        phas = phas or hj

    me, o = ranks.rank, offs[ranks.rank]
    rank = torch.where(ls == 0, starts[me], o + ls)
    rank = torch.where(valid, rank, KEY_SENTINEL).to(torch.int32)
    if counts[me] > 0:
        # my last record's run continues into the next rank's first record
        if me + 1 < ranks.size and (fk1[me + 1], fk2[me + 1]) == (lk1[me], lk2[me]):
            tied[counts[me] - 1] = True
        # my first record continues the previous rank's run
        if starts[me] != o:
            tied[0] = True
    return rank, tied & valid, c


def _round(rank, p, store, h, *, spec: StoreSpec, cfg: SAConfig, text_len: int,
           shuffle_cap: int):
    """One doubling round: fetch rank[p + h], re-sort, rerank, write back.

    Returns (rank, p, store, n_tied, shuffle bytes, fetch bytes, drops), the
    counts this rank's."""
    active = p != KEY_SENTINEL
    ahead = p + h
    served = active & (ahead < text_len)
    r2, dropf = mget_scalar(store, ahead, served, spec, fill=-1)
    r2 = torch.where(served, r2, -1)
    del ahead, served
    r1s, r2s, ps, drops = _global_sort3(
        rank, torch.where(active, r2, KEY_SENTINEL), p, shuffle_cap,
        cfg.samples_per_shard, spec.ranks, cfg)
    del r2
    new_rank, tied, c = _global_rerank(r1s, r2s, spec.ranks)
    del r1s, r2s
    store, dropw = scatter_update(store, ps, new_rank, ps != KEY_SENTINEL, spec)
    n_tied = torch.sum(tied)
    return (new_rank, ps, store, n_tied, c.long() * 12,
            torch.sum(active).long() * 8, dropf + drops + dropw)


def _device_fn(text_l, halo_l, *, cfg: SAConfig, rows_per_shard: int,
               shuffle_cap: int, fetch_cap: int, text_len: int, max_rounds: int,
               ranks: Ranks):
    """The per-rank doubling body.  Returns (p, statvec) with statvec
    ``[count, valid suffixes, rounds, shuffle bytes, fetch bytes, drops,
    unresolved]`` (int64), this rank's."""
    dev = text_l.device
    base = ranks.rank * rows_per_shard

    # --- initial records from K-token prefix keys ----------------------
    flat = torch.cat([text_l.reshape(-1), halo_l.reshape(-1)])
    rec = encoding.make_records_text(flat, cfg, pos_base=base, n_emit=rows_per_shard)
    del flat
    valid0 = torch.arange(rows_per_shard, device=dev) + base < text_len
    kh = torch.where(valid0, rec[:, 0], KEY_SENTINEL)
    kl = torch.where(valid0, rec[:, 1], KEY_SENTINEL)
    pos = torch.where(valid0, rec[:, 3], KEY_SENTINEL)
    del rec, valid0

    r1, r2, p, drop0 = _global_sort3(kh, kl, pos, shuffle_cap, cfg.samples_per_shard,
                                     ranks, cfg)
    n_valid = torch.sum(pos != KEY_SENTINEL)
    del kh, kl, pos
    rank, tied, _ = _global_rerank(r1, r2, ranks)
    del r1, r2

    spec = StoreSpec(num_shards=ranks.size, rows_per_shard=rows_per_shard,
                     row_len=1, request_capacity=fetch_cap, ranks=ranks)
    store0 = torch.zeros((rows_per_shard,), dtype=torch.int32, device=dev)
    store, dropw = scatter_update(store0, p, rank, p != KEY_SENTINEL, spec)

    rounds = 0
    shuffle_bytes = torch.zeros((), dtype=torch.int64, device=dev)
    fetch_bytes = torch.zeros((), dtype=torch.int64, device=dev)
    drops = (drop0 + dropw).long()
    n_tied = torch.sum(tied)
    h = cfg.prefix_len
    while rounds < max_rounds and int(psum(n_tied, ranks)) > 0:
        rank, p, store, n_tied, sb, fb, dr = _round(
            rank, p, store, h, spec=spec, cfg=cfg, text_len=text_len,
            shuffle_cap=shuffle_cap)
        rounds += 1
        shuffle_bytes += sb
        fetch_bytes += fb
        drops += dr
        h *= 2

    count = torch.sum(p != KEY_SENTINEL)
    statvec = torch.stack([
        count, n_valid, torch.tensor(rounds, device=dev), shuffle_bytes,
        fetch_bytes, drops, n_tied.long(),
    ]).long()
    return p, statvec


def build_suffix_array_doubling(
    text, cfg: SAConfig = SAConfig(), device=None, group=None,
) -> SAResult:
    """Prefix-doubling SA of one token stream (the beyond-paper mode).

    device: ``None``/``"cuda"`` for the card (raises without CUDA), or
    ``"cpu"`` for the plain PyTorch path.  group: the process group to
    build on (``None``: the initialized world, one rank without one); every
    rank passes the whole text and returns the same result.  A build that
    drops records or stops with ties left is retried with twice the slack,
    as in the JAX package.
    """
    text = np.asarray(text, np.int32)
    if text.ndim != 1:
        raise ValueError("doubling mode is for long-text corpora")
    ranks = world(group)
    dev = resolve_device(device)
    d = ranks.size
    info = plan(text.shape, cfg, d)
    data, _, halo = local_shard(text, None, cfg, info, ranks, dev)

    n = text.shape[0]
    max_rounds = int(math.ceil(math.log2(max(n, 2)))) + 2
    slack = cfg.shuffle_slack
    for _attempt in range(7):
        # capacity per destination bucket
        shuffle_cap = max(1, int(math.ceil(info["rows_per_shard"] * slack / d)))
        fetch_cap = max(1, int(math.ceil(d * shuffle_cap * slack / d)))
        p, statvec = _device_fn(
            data, halo, cfg=cfg, rows_per_shard=info["rows_per_shard"],
            shuffle_cap=shuffle_cap, fetch_cap=fetch_cap, text_len=n,
            max_rounds=max_rounds, ranks=ranks)
        statmat = gathered(statvec, ranks)
        _, _, _, shuffle_b, fetch_b, dropped, unresolved = (
            int(x) for x in statmat.sum(0))
        if dropped == 0 and unresolved == 0:
            break
        slack *= 2  # host-level adaptive retry (two-phase planning fallback)

    p = gathered(p, ranks)
    sa = np.concatenate([p[i, :c] for i, c in enumerate(statmat[:, 0].tolist())])
    sa = sa.astype(np.int64)
    rounds = int(statmat[:, 2].max())
    tb = token_bytes(cfg.vocab_size)
    fp = Footprint(
        input=n * tb,
        store_put=n * tb + n * 4,  # corpus + rank store
        shuffle=shuffle_b,
        fetch_request=fetch_b,
        fetch_response=fetch_b // 2,
        materialized=0,
        output=n * 8,
        rounds=rounds,
        dropped=dropped,
    )
    stats = {
        "num_suffixes": n,
        "emitted": int(sa.shape[0]),
        "rounds": fp.rounds,
        "dropped": fp.dropped,
        "unresolved": unresolved,
    }
    return SAResult(suffix_array=sa, footprint=fp, stats=stats)
