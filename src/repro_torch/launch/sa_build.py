"""Suffix-array construction launcher of the port (the paper's §IV experiment).

    PYTHONPATH=src python -m repro_torch.launch.sa_build --reads 2000 --read-len 64
    PYTHONPATH=src python -m repro_torch.launch.sa_build --text 100000
    PYTHONPATH=src python -m repro_torch.launch.sa_build --device cpu --reads 50
    PYTHONPATH=src python -m repro_torch.launch.sa_build --mode terasort \
        --reads 2000                     # the TeraSort baseline
    PYTHONPATH=src python -m repro_torch.launch.sa_build --mode doubling \
        --text 100000                    # prefix doubling (reads: flattened)
    PYTHONPATH=src python -m repro_torch.launch.sa_build --device cpu \
        --reads 800 --read-len 48 --superblocks 3     # the out-of-core build
    PYTHONPATH=src python -m repro_torch.launch.sa_build --reads 800 \
        --read-len 48 --superblocks 4 --store-backend chunked \
        --cache-budget 65536             # disk-streamed: bounded resident bytes
    PYTHONPATH=src python -m repro_torch.launch.sa_build --reads 2000 \
        --index-dir /data/ix             # persist a queryable index directory
    PYTHONPATH=src python -m repro_torch.launch.sa_build --reads 2000 \
        --superblocks 4 --index-dir /data/ix --resume  # journaled; resumable

Every path of ``repro.launch.sa_build``, with the same flags, corpus
synthesis and printout.  ``--mode scheme`` (the default) builds single-pass
or out-of-core (``--superblocks``, ``--max-records-per-run``, with
``--merge-algorithm``, ``--merge-backend``, ``--merge-tile``,
``--pipeline-depth`` and ``--store-retries``), streaming (``--store-backend
chunked``, ``--cache-budget``, ``--chunk-records``, ``--corpus-file``),
persisted (``--index-dir``) and journaled (``--resume``, which needs
``--index-dir``: re-running the same command after a crash resumes the
build from the journaled block runs).  ``--mode terasort`` (reads only) and
``--mode doubling`` build in core; doubling flattens a reads corpus with a
``$`` separator after every read; ``--index-dir`` needs ``--mode scheme``.
``--corpus-file`` names a chunked corpus file: an existing one is built as
it is (loaded whole by the in-core modes), a fresh path gets the
synthesized corpus written there first and kept.  ``--device cuda`` (the
default) runs on ``cuda:0`` with the hand-written kernels
(``use_pallas=True``; the terasort and doubling modes run none);
``--device cpu`` runs the plain PyTorch path.

Under ``torchrun`` every process is one rank of the build:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.sa_build --device cpu --reads 2000 --mode terasort

Each rank joins the process group from the environment (``init_ranks``:
NCCL where every local rank has a card of its own, gloo otherwise, the
choice printed to stderr), builds its shard in any ``--mode``, and rank 0
prints the lines ``repro.launch.sa_build`` prints on as many devices.  The
out-of-core, streaming, journaled and indexed builds run on every rank too:
rank 0 owns ``--index-dir`` and a fresh ``--corpus-file`` (it alone writes
them; the other ranks read them after a barrier), so the ranks of one build
share that directory: one node, or a shared filesystem.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=64)
    ap.add_argument("--text", type=int, default=0,
                    help="long-text mode with this many tokens")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus synthesis seed (reproducible runs)")
    ap.add_argument("--mode", choices=["scheme", "terasort", "doubling"],
                    default="scheme")
    ap.add_argument("--packing", choices=["base", "bits"], default="base")
    ap.add_argument("--paired-end", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the card with the CUDA kernels; cpu: the "
                         "plain PyTorch path")
    ap.add_argument("--superblocks", type=int, default=0,
                    help="explicit out-of-core superblock count (0 = derive)")
    ap.add_argument("--max-records-per-run", type=int, default=0,
                    help="per-run suffix-record budget; exceeding corpora "
                         "build out-of-core (0 = unbounded, single-pass)")
    ap.add_argument("--merge-backend", choices=["host", "device"],
                    default="host",
                    help="where out-of-core merge tie groups are refined")
    ap.add_argument("--merge-algorithm",
                    choices=["merge_path", "kway", "rerank"],
                    default="merge_path",
                    help="out-of-core merge: batched merge-path tiles "
                         "(default), the heap-walk k-way baseline, or the "
                         "wholesale re-rank baseline")
    ap.add_argument("--merge-tile", type=int, default=0,
                    help="merge-path tile width (buffered heads per run; "
                         "0 = derive from the per-run record capacity)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="background buffers for the pipelined build; "
                         "0 = fully synchronous")
    ap.add_argument("--store-backend", choices=["memory", "chunked"],
                    default="memory",
                    help="out-of-core merge store: corpus resident on the "
                         "device (memory) or disk-chunked with a bounded LRU "
                         "cache on the host")
    ap.add_argument("--corpus-file", default=None,
                    help="chunked corpus file: read if it exists, else the "
                         "synthesized corpus is written there and streamed "
                         "(implies --store-backend chunked)")
    ap.add_argument("--cache-budget", type=int, default=0,
                    help="chunked-backend resident-byte budget, store cache "
                         "+ merge frontier (0 = 64 MiB default)")
    ap.add_argument("--chunk-records", type=int, default=0,
                    help="corpus items per on-disk chunk when serializing "
                         "(0 = derive from the cache budget)")
    ap.add_argument("--index-dir", default=None,
                    help="finalize the build as a reopenable index directory "
                         "(SA + LCP + corpus + manifest); serve it with "
                         "repro_torch.launch.serve --index-dir")
    ap.add_argument("--store-retries", type=int, default=0,
                    help="retry transient store-fetch faults this many times "
                         "(capped exponential backoff) before failing the "
                         "build; 0 = fail fast")
    ap.add_argument("--resume", action="store_true",
                    help="journal the build in --index-dir and resume a "
                         "killed one from its journaled block runs")
    args = ap.parse_args(argv)
    if args.index_dir and args.mode != "scheme":
        ap.error("--index-dir requires --mode scheme")
    if args.resume and not args.index_dir:
        ap.error("--resume requires --index-dir (the journal lives there)")
    return args


def make_config(packing: str, device: str, use_pallas=None):
    """The launcher's SAConfig; the kernels run by default on the card."""
    from repro_torch.config import SAConfig

    if use_pallas is None:
        use_pallas = device == "cuda"
    return SAConfig(vocab_size=4, packing=packing, samples_per_shard=512,
                    use_pallas=use_pallas)


def make_corpus(args):
    """The corpus ``repro.launch.sa_build`` synthesizes for the same flags."""
    from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus

    if args.text:
        corpus, _ = synth_token_corpus(args.text, 4, seed=args.seed)
        return corpus
    return synth_dna_reads(args.reads, args.read_len, seed=args.seed,
                           paired_end=args.paired_end)


def make_superblock_config(args):
    """The launcher's SuperblockConfig, as ``repro.launch.sa_build`` builds
    it for the ported flags."""
    from repro_torch.config import SuperblockConfig

    return SuperblockConfig(
        num_superblocks=args.superblocks,
        max_records_per_run=args.max_records_per_run,
        merge_backend=args.merge_backend,
        merge_algorithm=args.merge_algorithm,
        merge_tile=args.merge_tile,
        store_backend="chunked" if args.corpus_file else args.store_backend,
        chunk_records=args.chunk_records,
        cache_budget_bytes=args.cache_budget,
        spill_dir=args.index_dir,
        emit_lcp=bool(args.index_dir),
        write_manifest=bool(args.index_dir),
        pipeline_depth=args.pipeline_depth,
        resume=args.resume,
        store_retries=args.store_retries,
    )


def write_corpus_file(corpus, args) -> None:
    """Serialize the synthesized corpus to ``--corpus-file`` once, chunk by
    chunk through the streaming writer, as ``repro.launch.sa_build`` does."""
    from repro_torch.core.store import DEFAULT_CACHE_BUDGET
    from repro_torch.data.chunk_store import chunk_items_for_budget, write_chunked_stream

    items = corpus.shape[0]
    row_len = 1 if corpus.ndim == 1 else corpus.shape[1]
    # the written chunks always fit the backend's LRU half-budget
    budget = args.cache_budget if args.cache_budget > 0 else DEFAULT_CACHE_BUDGET
    chunk_items = args.chunk_records or chunk_items_for_budget(items, row_len, budget)
    batches = (corpus[lo : lo + chunk_items] for lo in range(0, items, chunk_items))
    meta = write_chunked_stream(batches, args.corpus_file, chunk_items=chunk_items)
    print(f"wrote {args.corpus_file}: {meta.items} items x {meta.row_len}, "
          f"{meta.num_chunks} chunks of {meta.chunk_items}")


def backend_for(device: str, local_ranks: int) -> str:
    """The process group's backend: NCCL where every one of the host's
    ``local_ranks`` has a card of its own, gloo otherwise (the CPU, or
    ranks sharing a card: NCCL takes one rank a card)."""
    import torch

    if device == "cuda" and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def init_ranks(device: str):
    """Join the process group that ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``...), if
    one does and none is joined yet.  Returns this process's ranks handle
    (:class:`repro_torch.core.distributed.Ranks`), the single-rank handle
    outside ``torchrun``."""
    import sys

    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import world
    from repro_torch.device import local_card

    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = backend_for(device, local)
        dist.init_process_group(backend)
        if dist.get_rank() == 0:
            print(f"process group: {dist.get_world_size()} ranks over {backend}",
                  file=sys.stderr)
        if device == "cuda":
            torch.cuda.set_device(local_card())
    return world()


def run(corpus, cfg, device: str, sb=None, mode: str = "scheme"):
    """Build in ``mode``; returns (result, wall seconds), device work
    included.  ``terasort`` and ``doubling`` take an in-core corpus."""
    import torch

    t0 = time.perf_counter()
    if mode == "terasort":
        from repro_torch.core.terasort import build_suffix_array_terasort

        res = build_suffix_array_terasort(corpus, cfg=cfg, device=device)
    elif mode == "doubling":
        from repro_torch.core.prefix_doubling import build_suffix_array_doubling
        from repro_torch.data.corpus import flatten_reads_with_separators

        # a reads corpus keeps its read boundaries: a $ after every read, so
        # no suffix comparison spans two reads (the corpus decides the mode:
        # an existing --corpus-file may be text without --text)
        flat = (corpus if corpus.ndim == 1
                else flatten_reads_with_separators(corpus))
        res = build_suffix_array_doubling(flat, cfg=cfg, device=device)
    else:
        from repro_torch.core.superblock import build_suffix_array_auto

        res = build_suffix_array_auto(corpus, cfg=cfg, sb=sb, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def report(res, dt: float, mode: str = "scheme", index_dir=None) -> None:
    n = res.stats["num_suffixes"]
    print(f"mode={mode} suffixes={n} time={dt:.2f}s "
          f"({n / dt:.0f} suffixes/s)")
    for k, v in res.footprint.units().items():
        print(f"  {k:>17}: {v if isinstance(v, int) else round(v, 3)}")
    if res.stats.get("store_backend") == "chunked":
        print(f"streaming: peak_resident={res.footprint.peak_resident_bytes}B "
              f"of corpus={res.stats['corpus_bytes']}B, cache hit rate "
              f"{res.stats['store_cache_hit_rate']:.2f}, "
              f"{res.stats['spilled_runs']} spilled runs "
              f"({res.stats['spilled_bytes']}B)")
    if res.stats.get("journaled"):
        print(f"resume: {res.stats['journal_hits']} of "
              f"{res.stats['superblocks']} blocks recovered from the journal")
    if index_dir:
        print(f"index: {res.stats['index_dir']} (serve with "
              f"python -m repro_torch.launch.serve --index-dir {index_dir})")
    print(f"stats: {res.stats}")


def main(argv=None):
    import torch.distributed as dist

    args = parse_args(argv)
    joined = not dist.is_initialized()
    ranks = init_ranks(args.device)
    joined = joined and dist.is_initialized()  # left as a caller set it up
    try:
        return _build(args, ranks)
    finally:
        if joined:
            dist.destroy_process_group()


def _build(args, ranks):
    """Synthesize or load the corpus, build it in ``args.mode`` on
    ``ranks``, and print the report on rank 0."""
    from repro_torch.core.distributed import barrier, broadcast_object
    from repro_torch.core.superblock import corpus_shape_of, plan_superblocks

    echo = ranks.rank == 0
    fresh = not (args.corpus_file and os.path.exists(args.corpus_file))
    if args.corpus_file:  # rank 0's answer, taken before it writes the file
        fresh = broadcast_object(fresh, ranks)
    corpus = make_corpus(args) if fresh else None
    cfg = make_config(args.packing, args.device)
    sb = make_superblock_config(args)
    source = corpus
    if args.corpus_file:
        if fresh:  # serialize once on rank 0, then every rank streams it
            if echo:
                write_corpus_file(corpus, args)
            barrier(ranks)
        source = args.corpus_file
    if args.mode != "scheme":
        if corpus is None:  # the in-core modes load an existing corpus file
            from repro_torch.data.chunk_store import load_corpus

            corpus = load_corpus(args.corpus_file)
        res, dt = run(corpus, cfg, args.device, mode=args.mode)
        if echo:
            report(res, dt, args.mode)
        return res
    plan = plan_superblocks(corpus_shape_of(source), cfg, sb)
    if plan.num_superblocks > 1 and echo:
        print(f"out-of-core: {plan.total_records} records > "
              f"{plan.capacity_records}/run -> {plan.num_superblocks} "
              f"superblocks ({sb.store_backend} store backend)")
    res, dt = run(source, cfg, args.device, sb=sb)
    if echo:
        report(res, dt, args.mode, index_dir=args.index_dir)
    return res


if __name__ == "__main__":
    main()
