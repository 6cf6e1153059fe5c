"""Cases of ``repro`` on D fake devices against ``repro_torch`` on D ranks.

Shared by ``tests/test_torch_distributed.py``: :func:`repro_main` runs every
case in a process whose jax sees D CPU devices; :func:`port_rank` runs every
case in one of D spawned processes, a gloo rank each.  Each writes its
results, keyed by ``(case, use_pallas)``, as a pickle into the test's
temporary directory.  A case's result holds the suffix array (or the store
values) and every counter the two packages report.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

K2 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4: forces rounds
K3 = dict(vocab_size=4, chars_per_word=3, key_words=2)

# name -> (builder, corpus kind, config fields)
CASES = {
    "reads": ("scheme", "reads", K2),
    "varlen": ("scheme", "varlen", K2),
    "text": ("scheme", "text", K3),
    "repeat": ("scheme", "repeat", K3),
    "retries": ("scheme", "reads", dict(K2, fetch_fraction=0.02)),
    "drops": ("scheme", "reads", dict(K2, adaptive=False, shuffle_slack=0.3)),
    "terasort": ("terasort", "reads", K2),
    "doubling_text": ("doubling", "text", K3),
    "doubling_ones": ("doubling", "ones", K3),
    "rank_store": ("rank_store", None, {}),
    "refine": ("refine", "skewed", K2),
}
# cases whose repro path runs no kernel whatever cfg.use_pallas says: repro
# runs them once, and both of the port's runs are held to that
NO_REPRO_KERNEL = ("terasort", "doubling_text", "doubling_ones", "rank_store")
STORE_ROWS, STORE_CAP = 16, 3


def corpus(kind):
    """(corpus, lengths) of a corpus kind, made from a fixed seed."""
    if kind == "reads":
        return np.random.default_rng(1).integers(1, 5, size=(101, 17)).astype(np.int32), None
    if kind == "varlen":
        rng = np.random.default_rng(2)
        lens = rng.integers(0, 12, size=(37,)).astype(np.int32)
        reads = np.zeros((37, 12), np.int32)
        for i, n in enumerate(lens):
            reads[i, :n] = rng.integers(1, 5, size=(n,))
        return reads, lens
    if kind == "text":
        return np.random.default_rng(3).integers(1, 5, size=(1000,)).astype(np.int32), None
    if kind == "repeat":
        return np.tile(np.array([1, 2], np.int32), 150), None
    if kind == "ones":
        return np.ones(257, np.int32), None
    if kind == "skewed":  # tests/test_refiner.py::test_refine_multidev_skewed_ties
        rng = np.random.default_rng(0)
        return np.concatenate([rng.integers(1, 5, size=256), np.ones(256)]).astype(np.int32), None
    raise ValueError(kind)


def refine_batch(text):
    """The skewed-tie batch: the suffixes at 300..499 in a shuffled order."""
    from repro_torch.core.oracle import naive_sa_text

    full = naive_sa_text(text)
    sub = full[np.isin(full, np.arange(300, 500))]
    return np.random.default_rng(0).permutation(sub)


def store_inputs(d):
    """Rank-store inputs over d shards of STORE_ROWS: a permutation of the
    positions with an inactive slot and an out-of-range one, new values."""
    n = d * STORE_ROWS
    rng = np.random.default_rng(d)
    pos = rng.permutation(n).astype(np.int32)
    pos[3], pos[7] = -1, n + 5
    return (np.arange(n, dtype=np.int32) * 3, pos,
            rng.integers(0, 1000, size=(n,)).astype(np.int32))


def summary(res):
    return {"sa": np.asarray(res.suffix_array),
            "footprint": dataclasses.asdict(res.footprint), "stats": dict(res.stats)}


def refiner_summary(ref, got):
    return {"sa": np.asarray(got), "counters": {
        k: getattr(ref, k) for k in ("requests", "request_bytes", "response_bytes",
                                     "rounds", "peak_records", "calls")}}


# ---------------------------------------------------------------------------
# repro on D fake devices
# ---------------------------------------------------------------------------


def _repro_case(name, use_pallas):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.config import SAConfig
    from repro.core.distributed import shard_map
    from repro.core.pipeline import DeviceRefiner, build_suffix_array
    from repro.core.prefix_doubling import build_suffix_array_doubling
    from repro.core.store import StoreSpec, mget_scalar, scatter_update
    from repro.core.terasort import build_suffix_array_terasort

    builder, kind, fields = CASES[name]
    cfg = SAConfig(**fields, use_pallas=use_pallas)
    if builder == "rank_store":
        d = jax.device_count()
        mesh = Mesh(np.array(jax.devices()), ("sa",))
        spec = StoreSpec(axis="sa", num_shards=d, rows_per_shard=STORE_ROWS, row_len=1,
                         request_capacity=STORE_CAP)
        vals, pos, newv = store_inputs(d)

        def fetch(v, p):
            got, dropped = mget_scalar(v, p, p >= 0, spec, fill=-1)
            return got, dropped[None]

        def write(v, p, x):
            out, dropped = scatter_update(v, p, x, p >= 0, spec)
            return out, dropped[None]

        got, fdrop = jax.jit(shard_map(fetch, mesh=mesh, in_specs=(P("sa"),) * 2,
                                       out_specs=(P("sa"), P("sa"))))(vals, pos)
        out, wdrop = jax.jit(shard_map(write, mesh=mesh, in_specs=(P("sa"),) * 3,
                                       out_specs=(P("sa"), P("sa"))))(vals, pos, newv)
        return {"got": np.asarray(got), "fetch_dropped": np.asarray(fdrop),
                "written": np.asarray(out), "write_dropped": np.asarray(wdrop)}
    data, lengths = corpus(kind)
    if builder == "refine":
        ref = DeviceRefiner(data, cfg)
        return refiner_summary(ref, ref.refine(refine_batch(data)))
    if builder == "terasort":
        return summary(build_suffix_array_terasort(data, lengths, cfg=cfg))
    if builder == "doubling":
        return summary(build_suffix_array_doubling(data, cfg=cfg))
    return summary(build_suffix_array(data, lengths, cfg=cfg))


def repro_main(out_path):
    """Every case with use_pallas off and on (once for NO_REPRO_KERNEL)."""
    results = {}
    for name in CASES:
        for use_pallas in (False, True):
            if use_pallas and name in NO_REPRO_KERNEL:
                results[name, True] = results[name, False]
            else:
                results[name, use_pallas] = _repro_case(name, use_pallas)
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# repro_torch on D gloo ranks
# ---------------------------------------------------------------------------


def _port_case(name, use_pallas, ranks):
    import torch

    from repro_torch.config import SAConfig
    from repro_torch.core.pipeline import DeviceRefiner, build_suffix_array
    from repro_torch.core.prefix_doubling import build_suffix_array_doubling
    from repro_torch.core.store import StoreSpec, mget_scalar, scatter_update
    from repro_torch.core.terasort import build_suffix_array_terasort
    from repro_torch.core.distributed import all_gather

    builder, kind, fields = CASES[name]
    cfg = SAConfig(**fields, use_pallas=use_pallas)
    if builder == "rank_store":
        d, me = ranks.size, ranks.rank
        spec = StoreSpec(num_shards=d, rows_per_shard=STORE_ROWS, row_len=1,
                         request_capacity=STORE_CAP, ranks=ranks)
        vals, pos, newv = (torch.from_numpy(a[me * STORE_ROWS:(me + 1) * STORE_ROWS])
                           for a in store_inputs(d))
        got, fdrop = mget_scalar(vals, pos, pos >= 0, spec, fill=-1)
        out, wdrop = scatter_update(vals, pos, newv, pos >= 0, spec)
        return {k: all_gather(v.reshape(-1), ranks).reshape(-1).numpy() for k, v in (
            ("got", got), ("fetch_dropped", fdrop), ("written", out),
            ("write_dropped", wdrop))}
    data, lengths = corpus(kind)
    if builder == "refine":
        ref = DeviceRefiner(data, cfg, device="cpu")
        return refiner_summary(ref, ref.refine(refine_batch(data)).numpy())
    if builder == "terasort":
        return summary(build_suffix_array_terasort(data, lengths, cfg=cfg, device="cpu"))
    if builder == "doubling":
        return summary(build_suffix_array_doubling(data, cfg=cfg, device="cpu"))
    return summary(build_suffix_array(data, lengths, cfg=cfg, device="cpu"))


def port_rank(rank, d, out_dir):
    """One gloo rank of ``d`` (a ``torch.multiprocessing`` spawn target):
    runs every case with use_pallas off and on; writes ``rank{rank}.pkl``.
    The bucket_hist dispatcher is counted."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import world
    from repro_torch.kernels import ops

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rdzv')}",
                           rank=rank, world_size=d)
    real = ops.bucket_hist
    hist_calls = []

    def counted(*a, **kw):
        hist_calls.append(a[0].shape[0])
        return real(*a, **kw)

    ops.bucket_hist = counted
    try:
        ranks = world()
        results = {}
        for name in CASES:
            for use_pallas in (False, True):
                del hist_calls[:]
                results[name, use_pallas] = _port_case(name, use_pallas, ranks)
                results[name, use_pallas, "bucket_hist calls"] = len(hist_calls)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        ops.bucket_hist = real
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the out-of-core, journaled and indexed paths, called in one process
# ---------------------------------------------------------------------------


def _reads():
    return corpus("reads")[0][:20]


def run_superblock():
    from repro_torch.config import SAConfig, SuperblockConfig
    from repro_torch.core.superblock import build_suffix_array_superblock

    return build_suffix_array_superblock(_reads(), cfg=SAConfig(**K2), device="cpu",
                                         sb=SuperblockConfig(num_superblocks=2))


def run_auto_out_of_core():
    from repro_torch.config import SAConfig, SuperblockConfig
    from repro_torch.core.superblock import build_suffix_array_auto

    return build_suffix_array_auto(_reads(), cfg=SAConfig(**K2), device="cpu",
                                   sb=SuperblockConfig(num_superblocks=2))


def run_journal():
    import tempfile

    from repro_torch.core.journal import BuildJournal

    with tempfile.TemporaryDirectory() as tmp:
        return BuildJournal(os.path.join(tmp, "journal.jsonl"))


def run_index_build():
    from repro_torch import SuffixArrayIndex
    from repro_torch.config import SAConfig

    return SuffixArrayIndex.build(_reads(), cfg=SAConfig(**K2), device="cpu")
