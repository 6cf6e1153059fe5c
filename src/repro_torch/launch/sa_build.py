"""Suffix-array construction launcher of the port (the paper's §IV experiment).

    PYTHONPATH=src python -m repro_torch.launch.sa_build --reads 2000 --read-len 64
    PYTHONPATH=src python -m repro_torch.launch.sa_build --text 100000
    PYTHONPATH=src python -m repro_torch.launch.sa_build --device cpu --reads 50

The ``--mode scheme`` single-pass path of ``repro.launch.sa_build``, with the
same flags, corpus synthesis and printout.  ``--device cuda`` (the default)
runs on ``cuda:0`` with the hand-written kernels (``use_pallas=True``);
``--device cpu`` runs the plain PyTorch path.  Flags of paths not yet ported
exit with an error naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import time

# flag -> (value that means "not used", ROADMAP.md item that ports its path)
UNPORTED = {
    "superblocks": (0, 9),
    "max_records_per_run": (0, 9),
    "merge_backend": ("host", 9),
    "merge_algorithm": ("merge_path", 9),
    "merge_tile": (0, 9),
    "pipeline_depth": (1, 9),
    "store_backend": ("memory", 8),
    "corpus_file": (None, 8),
    "cache_budget": (0, 8),
    "chunk_records": (0, 8),
    "index_dir": (None, 8),
    "resume": (False, 9),
    "store_retries": (0, 9),
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
    # out-of-core, persistence and streaming flags of repro.launch.sa_build:
    # accepted so scripts keep working, refused unless left at their default
    ap.add_argument("--superblocks", type=int, default=0)
    ap.add_argument("--max-records-per-run", type=int, default=0)
    ap.add_argument("--merge-backend", choices=["host", "device"],
                    default="host")
    ap.add_argument("--merge-algorithm",
                    choices=["merge_path", "kway", "rerank"],
                    default="merge_path")
    ap.add_argument("--merge-tile", type=int, default=0)
    ap.add_argument("--pipeline-depth", type=int, default=1)
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


def run(corpus, cfg, device: str):
    """Build; returns (result, wall seconds), device work included."""
    import torch

    from repro_torch.core.superblock import build_suffix_array_auto

    t0 = time.perf_counter()
    res = build_suffix_array_auto(corpus, cfg=cfg, device=device)
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
    args = parse_args(argv)
    corpus = make_corpus(args)
    cfg = make_config(args.packing, args.device)
    res, dt = run(corpus, cfg, args.device)
    report(res, dt, args.mode)
    return res


if __name__ == "__main__":
    main()
