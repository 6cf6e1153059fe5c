"""Distributed SA construction with the PyTorch port: the paper's
experiment end to end.

Builds the suffix array of a paired-end read set over every rank of the
process group (one process a rank; each rank holds its shard of the corpus
and of the index records), prints the data-store footprint the way the
paper's Tables III/V do, and verifies against the oracle at verifiable
sizes.  Rank 0 prints.

    PYTHONPATH=src python examples/torch_sa_build.py --reads 2000 --read-len 64
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 examples/torch_sa_build.py --reads 2000 --baseline

The counterpart of ``examples/sa_build.py``, with the same lines but the
walls, and the number of ranks where it prints its devices.  ``--device
cuda`` (the default) builds on the rank's card with the hand-written
kernels; ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import time

import numpy as np

from repro_torch.core.oracle import naive_sa_reads
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.core.terasort import build_suffix_array_terasort
from repro_torch.data.corpus import synth_dna_reads
from repro_torch.launch.sa_build import init_ranks, make_config


def main(argv=None):
    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=64)
    ap.add_argument("--paired-end", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--baseline", action="store_true", help="also run TeraSort")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    joined = not dist.is_initialized()
    ranks = init_ranks(args.device)
    joined = joined and dist.is_initialized()
    echo = print if ranks.rank == 0 else (lambda *a, **k: None)

    def wall(t0):
        if args.device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    try:
        echo(f"ranks: {ranks.size}")
        reads = synth_dna_reads(args.reads, args.read_len, seed=0,
                                paired_end=args.paired_end)
        cfg = make_config("base", args.device)
        n_suffix = reads.shape[0] * (reads.shape[1] + 1)
        echo(f"input: {reads.shape[0]} reads x {reads.shape[1]} bp "
             f"-> {n_suffix} suffixes "
             f"(self-expansion ~{(reads.shape[1] + 1) / 2:.0f}x)")

        t0 = time.perf_counter()
        res = build_suffix_array(reads, cfg=cfg, device=args.device)
        dt = wall(t0)
        echo(f"scheme: {dt:.2f}s  ({n_suffix / dt:.0f} suffixes/s)  "
             f"rounds={res.stats['rounds']} dropped={res.stats['dropped']}")
        for k, v in res.footprint.units().items():
            echo(f"  {k:>15}: {v if isinstance(v, int) else round(v, 3)}")

        if args.baseline:
            t0 = time.perf_counter()
            tera = build_suffix_array_terasort(reads, cfg=cfg, device=args.device)
            echo(f"terasort baseline: {wall(t0):.2f}s  "
                 f"shuffle={tera.footprint.units()['shuffle']:.1f} units "
                 f"(scheme: {res.footprint.units()['shuffle']:.1f})")
            assert np.array_equal(res.suffix_array, tera.suffix_array)

        if args.verify:
            assert args.reads * args.read_len <= 1_000_000, "oracle too slow"
            ok = np.array_equal(res.suffix_array, naive_sa_reads(reads))
            echo(f"oracle match: {ok}")
            assert ok
        return res
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
