"""Suffix-array construction — the paper's scheme (§IV) at one shard.

The port of ``repro.core.pipeline.build_suffix_array``.  Dataflow:

  Map      : every suffix -> 16-byte record (prefix key + packed index)
             [core.encoding / the prefix_pack kernel]
  Sample   : splitter estimation (no splitters at one shard)
  Shuffle  : capacity-padded bucket scatter; the exchange is the identity
  Reduce   : lexicographic sort by (key, index); tie groups refine by
             fetching the next K-token window from the store (mgetsuffix,
             the window_gather kernel) in a host loop until no tie is left
  Output   : the sorted index run == the suffix array

Translations from the JAX package: ``lax.while_loop`` is a host loop whose
condition reads one device scalar per round; ``lax.sort(num_keys=k)`` is
:func:`repro_torch.core.distributed.lex_sort`; ``segment_min`` is
``scatter_reduce("amin")``.  Counters are int64, where the JAX package
accumulates them in int32.
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
from repro_torch.core.store import StoreSpec, serve_windows, token_bytes
from repro_torch.core.types import (
    KEY_SENTINEL,
    Footprint,
    SAResult,
    global_index,
    unpack_index,
)
from repro_torch.device import resolve_device


def _tied(g: torch.Tensor) -> torch.Tensor:
    """True where a row shares its group id with a neighbour."""
    eq = g[1:] == g[:-1]
    tied = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    tied[1:] |= eq
    tied[:-1] |= eq
    return tied


def _suffix_exhausted(ih, il, depth, *, text_mode, text_len, uniform_len,
                      stride_bits, k):
    """Analytic exhaustion: the first ``depth * k`` tokens already covered the
    whole suffix (text mode / uniform-length reads)."""
    if text_mode:
        rem = text_len - il
    else:
        _, off = unpack_index(ih, il, stride_bits)
        rem = uniform_len - off
    return rem <= depth * k


def _run_groups(keys, validr):
    """Group ids of runs of equal ``keys`` rows (padding rows stand alone)."""
    eq = torch.zeros(validr.shape, dtype=torch.bool, device=validr.device)
    same = validr[1:].clone()
    for key in keys:
        same &= key[1:] == key[:-1]
    eq[1:] = same
    return run_starts(eq)


def _refine_tie_groups(g, ih, il, exhausted, *, store_local, spec, cfg,
                       analytic, text_mode, text_len, uniform_len,
                       stride_bits, hard_cap):
    """Group-synchronous window-refinement loop (the reduce-phase core).

    Still-tied groups fetch their next K-token window from the store and
    re-sort within the group; a group consumes a window only when every
    active member was served.  Returns ``(g, ih, il, exhausted, depth,
    stats)`` as the JAX loop's final carry; stats are int64 device scalars
    except ``iters``.
    """
    n = ih.shape[0]
    k = cfg.prefix_len
    dev = ih.device
    depth = torch.ones((n,), dtype=torch.int32, device=dev)  # K tokens consumed
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = dict(iters=0, fetch_requests=zero, fetch_request_bytes=zero,
                 fetch_response_bytes=zero, retries=zero, max_depth=zero + 1)

    while stats["iters"] < hard_cap:
        active = _tied(g) & ~exhausted & (ih != KEY_SENTINEL)
        if not bool(active.any()):
            break
        validr = ih != KEY_SENTINEL
        if analytic:
            exhausted = _suffix_exhausted(
                ih, il, depth, text_mode=text_mode, text_len=text_len,
                uniform_len=uniform_len, stride_bits=stride_bits, k=k,
            ) | ~validr
            active = _tied(g) & ~exhausted & validr
        if text_mode:
            row = il + depth * k  # absolute window start owns the request
            off = torch.zeros_like(il)
        else:
            row, off0 = unpack_index(ih, il, stride_bits)
            off = off0 + depth * k
        words, exh_new, ok, fs = serve_windows(store_local, row, off, active,
                                               spec, cfg)
        del row, off
        # group-synchronous advance: a group consumes its window only if every
        # active member was served; otherwise the whole group retries.
        member_ok = torch.where(active, ok, True).to(torch.int32)
        gl = g.long()
        seg_ok = torch.ones((n,), dtype=torch.int32, device=dev).scatter_reduce(
            0, gl, member_ok, "amin")
        step = (seg_ok[gl] > 0) & validr & active
        del gl, seg_ok, member_ok
        nk_hi = torch.where(step, words[:, 0], 0)
        nk_lo = torch.where(step, words[:, 1], 0)
        del words
        if not analytic:
            exhausted = torch.where(step, exh_new, exhausted)
        depth = torch.where(step, depth + 1, depth)
        del step, exh_new, ok, active
        g, nk_hi, nk_lo, ih, il, exh_i, depth = lex_sort(
            [g, nk_hi, nk_lo, ih, il], [exhausted.to(torch.int32), depth])
        exhausted = exh_i > 0
        g = _run_groups([g, nk_hi, nk_lo], ih != KEY_SENTINEL)
        del nk_hi, nk_lo, exh_i
        stats = dict(
            iters=stats["iters"] + 1,
            fetch_requests=stats["fetch_requests"] + fs.requests,
            fetch_request_bytes=stats["fetch_request_bytes"] + fs.request_bytes,
            fetch_response_bytes=stats["fetch_response_bytes"] + fs.response_bytes,
            retries=stats["retries"] + fs.dropped,
            max_depth=torch.maximum(stats["max_depth"], depth.max().long()),
        )
    return g, ih, il, exhausted, depth, stats


def _map_phase(reads_l, lengths_l, halo_l, *, cfg, rows_per_shard, stride_bits,
               text_mode, text_len):
    """Map + sample + bucket.  Returns (records, valid, bucket)."""
    if text_mode:
        flat = torch.cat([reads_l.reshape(-1), halo_l.reshape(-1)])
        pos = torch.arange(rows_per_shard, dtype=torch.int32, device=flat.device)
        if cfg.use_pallas:
            from repro_torch.kernels import ops as kops

            keys = kops.prefix_pack(flat, cfg)[:rows_per_shard]
            rec = torch.stack(
                [keys[:, 0], keys[:, 1], torch.zeros_like(pos), pos], dim=-1)
            del keys
        else:
            rec = encoding.make_records_text(flat, cfg, pos_base=0,
                                             n_emit=rows_per_shard)
        valid0 = pos < text_len
    else:
        rec, valid0 = encoding.make_records_reads(
            reads_l, lengths_l, cfg, read_id_base=0, stride_bits=stride_bits)
    rec.masked_fill_(~valid0[:, None], KEY_SENTINEL)
    s_hi, s_lo = sample_splitters(rec[:, 0], rec[:, 1], cfg.samples_per_shard)
    bucket = lex_bucket(rec[:, 0], rec[:, 1], s_hi, s_lo)
    # invalid padding records go to a local dump bucket, never shipped
    bucket = torch.where(valid0, bucket, 1)
    return rec, valid0, bucket


def exact_shuffle_cap(bucket: torch.Tensor, num_shards: int) -> int:
    """Adaptive pre-pass: the exact max per-(sender, bucket) record count."""
    hist = torch.bincount(bucket.long(), minlength=num_shards + 1)[:num_shards]
    return max(1, int(hist.max()))


def fetch_capacity(shuffle_cap: int, cfg: SAConfig, num_shards: int) -> int:
    """Per-round store request capacity (``make_pipeline``'s arithmetic)."""
    d = num_shards
    return max(1, int(math.ceil(d * shuffle_cap * cfg.fetch_fraction
                                * cfg.shuffle_slack / d)))


def _device_fn(reads_l, lengths_l, halo_l, *, cfg: SAConfig, info: dict):
    """The single-shard SA pipeline body.  Returns (ih, il, statvec)."""
    d = 1
    k = cfg.prefix_len
    text_mode, text_len = info["text_mode"], info["text_len"]
    stride_bits, uniform_len = info["stride_bits"], info["uniform_len"]
    rec, valid0, bucket = _map_phase(
        reads_l, lengths_l, halo_l, cfg=cfg,
        rows_per_shard=info["rows_per_shard"], stride_bits=stride_bits,
        text_mode=text_mode, text_len=text_len,
    )
    n_valid_local = valid0.sum()
    shuffle_cap = (exact_shuffle_cap(bucket, d) if cfg.adaptive
                   else info["shuffle_cap"])

    # ---- Shuffle: bucket scatter; the exchange is the identity ----------
    buf, slot, _ = bucket_scatter(rec, bucket, d + 1, shuffle_cap, KEY_SENTINEL)
    drop_shuffle = torch.sum(valid0 & (slot >= d * shuffle_cap))
    del rec, bucket, slot, valid0
    recv = exchange(buf[:d]).reshape(d * shuffle_cap, 4)
    cols = [recv[:, i].contiguous() for i in range(4)]
    del buf, recv

    # ---- Reduce: initial sort ------------------------------------------
    kh, kl, ih, il = lex_sort(cols)
    del cols
    validr = ih != KEY_SENTINEL
    g = _run_groups([kh, kl], validr)
    del kh, kl

    # exhausted = the first depth*K tokens already covered the whole suffix:
    # analytic in text mode / uniform reads, else resolved by fetch flags.
    analytic = text_mode or (uniform_len is not None)
    if analytic:
        exhausted = _suffix_exhausted(
            ih, il, 1, text_mode=text_mode, text_len=text_len,
            uniform_len=uniform_len, stride_bits=stride_bits, k=k,
        )
    else:
        exhausted = torch.zeros_like(validr)
    exhausted = exhausted | ~validr

    spec = StoreSpec(
        num_shards=d,
        rows_per_shard=info["rows_per_shard"],
        row_len=info["row_len"],
        request_capacity=fetch_capacity(shuffle_cap, cfg, d),
    )
    if text_mode:  # store shard = tokens + right halo
        store_local = torch.cat([reads_l.reshape(-1), halo_l.reshape(-1)])[:, None]
    else:
        store_local = reads_l

    g, ih, il, exhausted, _, stats = _refine_tie_groups(
        g, ih, il, exhausted, store_local=store_local, spec=spec, cfg=cfg,
        analytic=analytic, text_mode=text_mode, text_len=text_len,
        uniform_len=uniform_len, stride_bits=stride_bits,
        hard_cap=2 * info["max_rounds"] + 8,
    )

    validr = ih != KEY_SENTINEL
    unresolved = torch.sum(_tied(g) & ~exhausted & validr)
    statvec = torch.stack([
        torch.sum(validr),
        n_valid_local,
        torch.tensor(stats["iters"], device=ih.device),
        stats["fetch_requests"],
        stats["fetch_request_bytes"],
        stats["fetch_response_bytes"],
        drop_shuffle,
        stats["retries"],
        unresolved,
        stats["max_depth"],
    ]).long()
    return ih, il, statvec


def plan(corpus_shape, cfg: SAConfig, num_shards: int, lengths=None):
    """Static planning (``repro.core.pipeline.plan``)."""
    text_mode = len(corpus_shape) == 1
    if text_mode:
        n = corpus_shape[0]
        rows_per_shard = -(-n // num_shards)
        row_len, l = 1, 1
        stride_bits = 0
        n_local = rows_per_shard
        text_len = n
        uniform_len = None
    else:
        r, l = corpus_shape
        rows_per_shard = -(-r // num_shards)
        row_len = l
        stride_bits = int(math.ceil(math.log2(l + 1)))
        n_local = rows_per_shard * (l + 1)
        text_len = 0
        uniform_len = l if lengths is None else None
    shuffle_cap = max(1, int(math.ceil(n_local * cfg.shuffle_slack / num_shards)))
    if cfg.max_rounds:
        max_rounds = cfg.max_rounds
    elif text_mode:
        max_rounds = int(math.ceil(corpus_shape[0] / cfg.prefix_len)) + 1
    else:
        max_rounds = int(math.ceil((l + 1) / cfg.prefix_len)) + 1
    return dict(
        text_mode=text_mode,
        rows_per_shard=rows_per_shard,
        row_len=row_len,
        stride_bits=stride_bits,
        shuffle_cap=shuffle_cap,
        max_rounds=max_rounds,
        uniform_len=uniform_len,
        text_len=text_len,
        n_local=n_local,
    )


def _shard_inputs(corpus, lengths, cfg: SAConfig, d: int, info):
    """Numpy (data, lengths, halo) shard layout (``repro.core.pipeline``)."""
    corpus = np.asarray(corpus, np.int32)
    rows = info["rows_per_shard"]
    k = cfg.prefix_len
    if info["text_mode"]:
        pad = rows * d - corpus.shape[0]
        flat = np.pad(corpus, (0, pad))
        data = flat.reshape(d * rows, 1)
        lens = np.zeros((d * rows,), np.int32)
        halo = np.zeros((d, k), np.int32)
        for i in range(d - 1):
            seg = flat[(i + 1) * rows : min((i + 1) * rows + k, d * rows)]
            halo[i, : seg.shape[0]] = seg
        halo = halo.reshape(d * k)
    else:
        r, l = corpus.shape
        pad = rows * d - r
        data = np.pad(corpus, ((0, pad), (0, 0)))
        if lengths is None:
            lens = np.concatenate(
                [np.full((r,), l, np.int32), np.full((pad,), -1, np.int32)]
            )
        else:
            lens = np.concatenate(
                [np.asarray(lengths, np.int32), np.full((pad,), -1, np.int32)]
            )
        halo = np.zeros((d,), np.int32)
    return data, lens, halo


def build_suffix_array(
    corpus,
    lengths=None,
    cfg: SAConfig = SAConfig(),
    device=None,
) -> SAResult:
    """Build the suffix array of ``corpus`` with the paper's scheme.

    corpus: (R, L) int32 reads (tokens 1..V, 0 padding) or (n,) int32 text.
    device: ``None``/``"cuda"`` for the card (raises without CUDA), or
    ``"cpu"`` for the plain PyTorch path.
    """
    dev = resolve_device(device)
    info = plan(np.shape(corpus), cfg, 1, lengths)
    data, lens, halo = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in _shard_inputs(corpus, lengths, cfg, 1, info))
    ih, il, statvec = _device_fn(data, lens, halo, cfg=cfg, info=info)
    return _finalize(ih.cpu().numpy(), il.cpu().numpy(),
                     statvec.cpu().numpy()[None, :], corpus, cfg)


def _finalize(ih, il, statmat, corpus, cfg: SAConfig) -> SAResult:
    d = statmat.shape[0]
    per_dev = ih.shape[0] // d
    chunks = []
    for i in range(d):
        lo = i * per_dev
        cnt = int(statmat[i, 0])
        chunks.append(global_index(ih[lo : lo + cnt], il[lo : lo + cnt]))
    sa = np.concatenate(chunks) if chunks else np.zeros((0,), np.int64)

    corpus = np.asarray(corpus)
    tb = token_bytes(cfg.vocab_size)
    n_suffix = int(statmat[:, 1].sum())
    fp = Footprint(
        input=int(corpus.size) * tb,
        store_put=int(corpus.size) * tb,
        shuffle=n_suffix * 16,
        fetch_request=int(statmat[:, 4].sum()),
        fetch_response=int(statmat[:, 5].sum()),
        materialized=0,
        output=n_suffix * 8,
        rounds=int(statmat[:, 9].max()) if d else 0,
        dropped=int(statmat[:, 6].sum()),
    )
    stats = {
        "num_suffixes": n_suffix,
        "emitted": int(sa.shape[0]),
        "per_device_counts": statmat[:, 0].tolist(),
        "fetch_requests": int(statmat[:, 3].sum()),
        "iters": int(statmat[:, 2].max()),
        "rounds": fp.rounds,
        "dropped": fp.dropped,
        "retries": int(statmat[:, 7].sum()),
        "unresolved": int(statmat[:, 8].sum()),
    }
    return SAResult(suffix_array=sa, footprint=fp, stats=stats)
