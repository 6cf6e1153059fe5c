"""TeraSort baseline for SA construction (paper §III).

The port of ``repro.core.terasort``.  "Keeping every suffix in place": every
suffix is materialized as a fixed-width padded record of ``w = ceil((L+1) /
chars_per_word)`` key words plus its two index words, and the whole payload
rides the shuffle, where the scheme shuffles 16-byte records.  Dataflow:

  Map       : every suffix -> a (w + 2)-word record, built a chunk of reads
              at a time from shifted token slices (the JAX package's
              (rows, L+1, w * cpw) window tensor would take 167 GB at
              1 M reads of 200 tokens)
  Partition : ``sample_splitters`` across the ranks + the range partition
              on the first two words (no splitters at one rank)
  Shuffle   : capacity-padded ``bucket_scatter`` and one all_to_all of the
              whole records (the identity at one rank)
  Sort      : one sort over all w + 2 words on each rank
              (:func:`repro_torch.core.distributed.lex_order`)

Reads mode only (the paper's case): long-text suffixes are unbounded and
cannot be materialized at fixed width.  Each rank maps its shard of the
reads (one process a rank; one rank without a process group).  At one rank
no kernel runs on this path, as none runs on the JAX package's; at D ranks
under ``cfg.use_pallas`` the partition is the ``bucket_hist`` kernel, here
and in the scheme Map that sizes the shuffle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import SAConfig
from repro_torch.core import encoding
from repro_torch.core.distributed import (
    Ranks,
    bucket_scatter,
    exchange,
    lex_order,
    partition,
    sample_splitters,
    world,
)
from repro_torch.core.pipeline import (
    _map_phase,
    exact_shuffle_cap,
    gathered,
    local_shard,
    plan,
)
from repro_torch.core.store import token_bytes
from repro_torch.core.types import KEY_SENTINEL, Footprint, SAResult, global_index, pack_index
from repro_torch.device import resolve_device

# Most suffix records the Map packs at once (a chunk of whole reads).
MAP_CHUNK = 1 << 24


def _suffix_words(l: int, cfg: SAConfig) -> int:
    cpw = cfg.resolved_chars_per_word()
    return -(-(l + 1) // cpw)


def _map_records(reads_l, lengths_l, *, cfg: SAConfig, stride_bits: int,
                 row_base: int = 0, chunk: int = MAP_CHUNK):
    """Map: every suffix -> ``[w key words, idx_hi, idx_lo]`` (local read
    ``i`` is read ``row_base + i``), rows past a read's length all
    ``KEY_SENTINEL``.  Returns (records, valid count)."""
    r, l = reads_l.shape
    w = _suffix_words(l, cfg)
    dev = reads_l.device
    rec = torch.empty((r * (l + 1), w + 2), dtype=torch.int32, device=dev)
    offs = torch.arange(l + 1, dtype=torch.int32, device=dev)
    step = max(1, chunk // (l + 1))
    for lo in range(0, r, step):
        hi = min(r, lo + step)
        out = rec[lo * (l + 1) : hi * (l + 1)].view(hi - lo, l + 1, w + 2)
        out[..., :w] = encoding.suffix_words(reads_l[lo:hi], w, cfg)
        rows = torch.arange(row_base + lo, row_base + hi, dtype=torch.int32,
                            device=dev)[:, None]
        rows = rows.expand(hi - lo, l + 1)
        out[..., w], out[..., w + 1] = pack_index(rows, offs.expand_as(rows),
                                                  stride_bits)
        valid = offs[None, :] <= lengths_l[lo:hi, None]
        out.masked_fill_(~valid[..., None], KEY_SENTINEL)
        del out, rows, valid
    n_valid = torch.sum(offs[None, :] <= lengths_l[:, None])
    return rec, n_valid


def _device_fn(reads_l, lengths_l, *, cfg: SAConfig, stride_bits: int,
               shuffle_cap: int, ranks: Ranks):
    """The per-rank TeraSort body.  Returns (ih, il, statvec) with statvec
    ``[count, valid suffixes, dropped]``."""
    d = ranks.size
    w = _suffix_words(reads_l.shape[1], cfg)
    rec, n_valid = _map_records(reads_l, lengths_l, cfg=cfg, stride_bits=stride_bits,
                                row_base=ranks.rank * reads_l.shape[0])

    # Partition on the first two words (TeraSort's 10-byte key analogue)
    s_hi, s_lo = sample_splitters(rec[:, 0], rec[:, 1], cfg.samples_per_shard, ranks)
    bucket = partition(rec[:, 0], rec[:, 1], s_hi, s_lo, cfg)

    # Shuffle the full payload (the baseline's sin)
    buf, _, drop = bucket_scatter(rec, bucket, d, shuffle_cap, KEY_SENTINEL)
    del rec, bucket
    recv = exchange(buf, ranks).reshape(d * shuffle_cap, w + 2)
    del buf

    # Sort on every word; the index words make each valid record unique and
    # sentinel rows sort last, so the valid rows come first in suffix order
    perm = lex_order([recv[:, i] for i in range(w + 2)])
    ih, il = recv[perm, w], recv[perm, w + 1]
    count = torch.sum(recv[:, 0] != KEY_SENTINEL)
    del recv, perm
    return ih, il, torch.stack([count, n_valid.to(count.dtype), drop.to(count.dtype)])


def build_suffix_array_terasort(
    corpus, lengths=None, cfg: SAConfig = SAConfig(), device=None, group=None,
) -> SAResult:
    """Build the suffix array of an (R, L) read set the TeraSort way.

    device: ``None``/``"cuda"`` for the card (raises without CUDA), or
    ``"cpu"`` for the plain PyTorch path.  group: the process group to
    build on (``None``: the initialized world, one rank without one); every
    rank passes the whole corpus and returns the same result.  The shuffle
    capacity is the scheme Map's exact bucket histogram under
    ``cfg.adaptive``, else ``plan``'s.
    """
    corpus = np.asarray(corpus, np.int32)
    if corpus.ndim != 2:
        raise ValueError("TeraSort baseline supports read-set mode only")
    ranks = world(group)
    dev = resolve_device(device)
    info = plan(corpus.shape, cfg, ranks.size, lengths)
    data, lens, halo = local_shard(corpus, lengths, cfg, info, ranks, dev)
    shuffle_cap = info["shuffle_cap"]
    if cfg.adaptive:
        _, _, bucket = _map_phase(
            data, lens, halo, cfg=cfg, rows_per_shard=info["rows_per_shard"],
            stride_bits=info["stride_bits"], text_mode=False, text_len=0,
            ranks=ranks)
        shuffle_cap = exact_shuffle_cap(bucket, ranks.size, ranks)
        del bucket

    ih, il, statvec = _device_fn(data, lens, cfg=cfg,
                                 stride_bits=info["stride_bits"],
                                 shuffle_cap=shuffle_cap, ranks=ranks)
    statmat = gathered(statvec, ranks)
    ih, il = gathered(ih, ranks), gathered(il, ranks)
    sa = np.concatenate([global_index(ih[i, :c], il[i, :c])
                         for i, c in enumerate(statmat[:, 0].tolist())])
    n_suffix, dropped = (int(x) for x in statmat[:, 1:].sum(0))

    l = corpus.shape[1]
    tb = token_bytes(cfg.vocab_size)
    suffix_bytes = (l + 1) * tb + 8  # materialized payload + index
    fp = Footprint(
        input=int(corpus.size) * tb,
        store_put=0,  # no in-memory store: every suffix kept in place
        shuffle=n_suffix * suffix_bytes,
        fetch_request=0,
        fetch_response=0,
        materialized=n_suffix * suffix_bytes,
        output=n_suffix * 8,
        rounds=0,
        dropped=dropped,
    )
    stats = {
        "num_suffixes": n_suffix,
        "emitted": int(sa.shape[0]),
        "record_bytes": suffix_bytes,
        "dropped": fp.dropped,
    }
    return SAResult(suffix_array=sa, footprint=fp, stats=stats)
