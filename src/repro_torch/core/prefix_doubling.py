"""Prefix doubling (Manber–Myers) over the rank store, at one shard.

The port of ``repro.core.prefix_doubling``.  The scheme's tie-break loop
refines K tokens a round, O(maxLCP / K) rounds, which degenerates on highly
repetitive text (the paper's "ATATATAT" anecdote); prefix doubling converges
in O(log n) rounds.  The in-memory store holds Manber–Myers **ranks**
instead of tokens, and every round is one ``mget_scalar`` (rank[pos + h]),
one sort of the same (rank, rank2, pos) records and one ``scatter_update``
write-back.

Rank convention: rank(suffix) = position in the sorted order of the first
member of its still-tied run (monotone, unique once resolved).  At one shard
the JAX package's O(D) cross-device run chaining reduces to ``run_starts``,
and a run continues across no device edge; world size > 1 is ROADMAP.md
item 10.

Translations from the JAX package: ``lax.while_loop`` is a host loop whose
condition reads one device scalar a round (:func:`_round` is its body);
``lax.sort(num_keys=3)`` is :func:`repro_torch.core.distributed.lex_sort`.
The byte counters are summed in int64, where the JAX package sums them in
int32 (its ``shuffles_bytes`` wraps once a build's shuffle passes 2^31 bytes).
No kernel runs on this path: the initial records come from
``encoding.make_records_text``, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.distributed import (
    bucket_scatter,
    exchange,
    lex_bucket,
    lex_sort,
    run_starts,
    sample_splitters,
)
from repro_torch.core.pipeline import _shard_inputs, plan
from repro_torch.core.store import StoreSpec, mget_scalar, scatter_update, token_bytes
from repro_torch.core.types import KEY_SENTINEL, Footprint, SAResult
from repro_torch.device import resolve_device


def _global_sort3(rank, rank2, pos, d, cap, samples):
    """Sample-sort (rank, rank2, pos) records at one shard.

    Returns the sorted (rank, rank2, pos), ``d * cap`` long, and the drop
    count.  Sentinel padding records go to a local dump bucket: never
    shipped, never counted as drops.
    """
    valid = rank != KEY_SENTINEL
    s1, s2 = sample_splitters(
        torch.where(valid, rank, KEY_SENTINEL), torch.where(valid, rank2, KEY_SENTINEL),
        samples)
    bucket = torch.where(valid, lex_bucket(rank, rank2, s1, s2), d)
    rec = torch.stack([rank, rank2, pos], dim=1)
    buf, slot, _ = bucket_scatter(rec, bucket, d + 1, cap, KEY_SENTINEL)
    drop = torch.sum(valid & (slot >= d * cap))
    del rec, bucket, slot
    recv = exchange(buf[:d]).reshape(d * cap, 3)
    r1, r2, p = lex_sort([recv[:, i].contiguous() for i in range(3)])
    return r1, r2, p, drop


def _global_rerank(k1, k2, d):
    """Run-start ranks for sorted (k1, k2) keys, sentinel records last.

    Returns (rank, tied, count): rank[i] = position of the first member of
    i's run (KEY_SENTINEL for sentinel slots); tied[i] = run size > 1.  At
    one shard a run starts and ends on this shard, so the JAX package's
    chain across devices and its edge terms (a run continued from the
    previous device or into the next) vanish.
    """
    if d != 1:
        raise NotImplementedError("reranking across shards is ROADMAP.md item 10")
    valid = k1 != KEY_SENTINEL
    c = torch.sum(valid)
    eq = torch.zeros(k1.shape, dtype=torch.bool, device=k1.device)
    eq[1:] = (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1]) & valid[1:] & valid[:-1]
    rank = torch.where(valid, run_starts(eq), KEY_SENTINEL)
    tied = eq.clone()
    tied[:-1] |= eq[1:]
    return rank, tied & valid, c


def _round(rank, p, store, h, *, spec: StoreSpec, cfg: SAConfig, text_len: int,
           shuffle_cap: int):
    """One doubling round: fetch rank[p + h], re-sort, rerank, write back.

    Returns (rank, p, store, n_tied, shuffle bytes, fetch bytes, drops)."""
    d = spec.num_shards
    active = p != KEY_SENTINEL
    ahead = p + h
    served = active & (ahead < text_len)
    r2, dropf = mget_scalar(store, ahead, served, spec, fill=-1)
    r2 = torch.where(served, r2, -1)
    del ahead, served
    r1s, r2s, ps, drops = _global_sort3(
        rank, torch.where(active, r2, KEY_SENTINEL), p, d, shuffle_cap,
        cfg.samples_per_shard)
    del r2
    new_rank, tied, c = _global_rerank(r1s, r2s, d)
    del r1s, r2s
    store, dropw = scatter_update(store, ps, new_rank, ps != KEY_SENTINEL, spec)
    n_tied = torch.sum(tied)
    return (new_rank, ps, store, n_tied, c.long() * 12,
            torch.sum(active).long() * 8, dropf + drops + dropw)


def _device_fn(text_l, halo_l, *, cfg: SAConfig, rows_per_shard: int,
               shuffle_cap: int, fetch_cap: int, text_len: int, max_rounds: int):
    """The single-shard doubling body.  Returns (p, statvec) with statvec
    ``[count, valid suffixes, rounds, shuffle bytes, fetch bytes, drops,
    unresolved]`` (int64)."""
    d = 1
    dev = text_l.device

    # --- initial records from K-token prefix keys ----------------------
    flat = torch.cat([text_l.reshape(-1), halo_l.reshape(-1)])
    rec = encoding.make_records_text(flat, cfg, pos_base=0, n_emit=rows_per_shard)
    del flat
    valid0 = torch.arange(rows_per_shard, device=dev) < text_len
    kh = torch.where(valid0, rec[:, 0], KEY_SENTINEL)
    kl = torch.where(valid0, rec[:, 1], KEY_SENTINEL)
    pos = torch.where(valid0, rec[:, 3], KEY_SENTINEL)
    del rec, valid0

    r1, r2, p, drop0 = _global_sort3(kh, kl, pos, d, shuffle_cap, cfg.samples_per_shard)
    n_valid = torch.sum(pos != KEY_SENTINEL)
    del kh, kl, pos
    rank, tied, _ = _global_rerank(r1, r2, d)
    del r1, r2

    spec = StoreSpec(num_shards=d, rows_per_shard=rows_per_shard, row_len=1,
                     request_capacity=fetch_cap)
    store0 = torch.zeros((rows_per_shard,), dtype=torch.int32, device=dev)
    store, dropw = scatter_update(store0, p, rank, p != KEY_SENTINEL, spec)

    rounds = 0
    shuffle_bytes = torch.zeros((), dtype=torch.int64, device=dev)
    fetch_bytes = torch.zeros((), dtype=torch.int64, device=dev)
    drops = (drop0 + dropw).long()
    n_tied = torch.sum(tied)
    h = cfg.prefix_len
    while rounds < max_rounds and int(n_tied) > 0:
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
    text, cfg: SAConfig = SAConfig(), device=None,
) -> SAResult:
    """Prefix-doubling SA of one token stream (the beyond-paper mode).

    device: ``None``/``"cuda"`` for the card (raises without CUDA), or
    ``"cpu"`` for the plain PyTorch path.  A build that drops records or
    stops with ties left is retried with twice the slack, as in the JAX
    package.
    """
    text = np.asarray(text, np.int32)
    if text.ndim != 1:
        raise ValueError("doubling mode is for long-text corpora")
    dev = resolve_device(device)
    d = 1
    info = plan(text.shape, cfg, d)
    data, _, halo = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in _shard_inputs(text, None, cfg, d, info))

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
            max_rounds=max_rounds)
        count, _, rounds, shuffle_b, fetch_b, dropped, unresolved = statvec.tolist()
        if dropped == 0 and unresolved == 0:
            break
        slack *= 2  # host-level adaptive retry (two-phase planning fallback)

    sa = p[:count].cpu().numpy().astype(np.int64)
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
