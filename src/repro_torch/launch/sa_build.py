"""Suffix-array construction launcher of the port (the paper's §IV experiment).

    PYTHONPATH=src python -m repro_torch.launch.sa_build --reads 2000 --read-len 64
    PYTHONPATH=src python -m repro_torch.launch.sa_build --text 100000
    PYTHONPATH=src python -m repro_torch.launch.sa_build --device cpu --reads 50
    PYTHONPATH=src python -m repro_torch.launch.sa_build --device cpu \
        --reads 800 --read-len 48 --superblocks 3     # the out-of-core build

The ``--mode scheme`` path of ``repro.launch.sa_build``, single-pass or
out-of-core (``--superblocks``, ``--max-records-per-run``, with
``--merge-backend``, ``--merge-tile`` and ``--pipeline-depth``), with the
same flags, corpus synthesis and printout.  ``--device cuda`` (the default)
runs on ``cuda:0`` with the hand-written kernels (``use_pallas=True``);
``--device cpu`` runs the plain PyTorch path.  Flags of paths not yet ported
exit with an error naming the ROADMAP.md item that ports them: the k-way and
re-rank merges, resume and store retries are item 9b; the chunked store,
corpus files and index directories are item 8.
"""
from __future__ import annotations

import argparse
import time

# flag -> (value that means "not used", ROADMAP.md item that ports its path)
UNPORTED = {
    "merge_algorithm": ("merge_path", "9b"),
    "store_backend": ("memory", "8"),
    "corpus_file": (None, "8"),
    "cache_budget": (0, "8"),
    "chunk_records": (0, "8"),
    "index_dir": (None, "8"),
    "resume": (False, "9b"),
    "store_retries": (0, "9b"),
}


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
    ap.add_argument("--merge-tile", type=int, default=0,
                    help="merge-path tile width (buffered heads per run; "
                         "0 = derive from the per-run record capacity)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="background buffers for the pipelined build; "
                         "0 = fully synchronous")
    # merge, persistence and streaming flags of repro.launch.sa_build not
    # ported yet: accepted so scripts keep working, refused unless left at
    # their default
    ap.add_argument("--merge-algorithm",
                    choices=["merge_path", "kway", "rerank"],
                    default="merge_path")
    ap.add_argument("--store-backend", choices=["memory", "chunked"],
                    default="memory")
    ap.add_argument("--corpus-file", default=None)
    ap.add_argument("--cache-budget", type=int, default=0)
    ap.add_argument("--chunk-records", type=int, default=0)
    ap.add_argument("--index-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--store-retries", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mode != "scheme":
        ap.error(f"--mode {args.mode} is not ported yet (ROADMAP.md item 11)")
    for name, (unused, item) in UNPORTED.items():
        if getattr(args, name) != unused:
            flag = "--" + name.replace("_", "-")
            ap.error(f"{flag} is not ported yet (ROADMAP.md item {item})")
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
        merge_tile=args.merge_tile,
        pipeline_depth=args.pipeline_depth,
    )


def run(corpus, cfg, device: str, sb=None):
    """Build; returns (result, wall seconds), device work included."""
    import torch

    from repro_torch.core.superblock import build_suffix_array_auto

    t0 = time.perf_counter()
    res = build_suffix_array_auto(corpus, cfg=cfg, sb=sb, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def report(res, dt: float, mode: str = "scheme") -> None:
    n = res.stats["num_suffixes"]
    print(f"mode={mode} suffixes={n} time={dt:.2f}s "
          f"({n / dt:.0f} suffixes/s)")
    for k, v in res.footprint.units().items():
        print(f"  {k:>17}: {v if isinstance(v, int) else round(v, 3)}")
    print(f"stats: {res.stats}")


def main(argv=None):
    from repro_torch.core.superblock import plan_superblocks

    args = parse_args(argv)
    corpus = make_corpus(args)
    cfg = make_config(args.packing, args.device)
    sb = make_superblock_config(args)
    plan = plan_superblocks(corpus.shape, cfg, sb)
    if plan.num_superblocks > 1:
        print(f"out-of-core: {plan.total_records} records > "
              f"{plan.capacity_records}/run -> {plan.num_superblocks} "
              f"superblocks ({sb.store_backend} store backend)")
    res, dt = run(corpus, cfg, args.device, sb=sb)
    report(res, dt, args.mode)
    return res


if __name__ == "__main__":
    main()
