"""Suffix-array query launcher of the port: serve a built index directory.

    # explicit patterns (comma-separated tokens; repeatable)
    PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /data/ix \
        --pattern 1,3,2 --pattern 2,2

    # synthetic query load: qps / latency over corpus-sampled patterns
    PYTHONPATH=src python -m repro_torch.launch.serve --index-dir /data/ix \
        --queries 2000 --batch 64 --store-backend chunked --cache-budget 65536

The counterpart of ``repro.launch.serve``: the same flags, the same
synthetic load at the same seed and the same printout apart from the wall
times.  It opens an index directory written by either package
(``repro_torch.launch.sa_build --index-dir``, ``SuffixArrayIndex.save``, or
their ``repro`` counterparts).  ``--device cuda`` (the default) serves on
``cuda:0`` through the hand-written ``pattern_cmp`` kernel; ``--device cpu``
runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index-dir", required=True,
                    help="index directory written by sa_build --index-dir "
                         "or SuffixArrayIndex.save()")
    ap.add_argument("--store-backend", choices=["chunked", "memory"],
                    default="chunked",
                    help="serve the corpus from disk chunks (LRU-budgeted) "
                         "or resident on the device")
    ap.add_argument("--cache-budget", type=int, default=0,
                    help="chunked-backend resident-byte budget "
                         "(0 = 64 MiB default)")
    ap.add_argument("--result-cache", type=int, default=1 << 20,
                    help="hot-pattern LRU result cache budget in bytes "
                         "(0 disables)")
    ap.add_argument("--batch", type=int, default=64,
                    help="queries per engine batch")
    ap.add_argument("--shards", type=int, default=0,
                    help="SA shards (0 = one per local device)")
    ap.add_argument("--pattern", action="append", default=[],
                    help="comma-separated token pattern; repeatable. "
                         "When absent, runs the synthetic query load")
    ap.add_argument("--queries", type=int, default=1000,
                    help="synthetic-load query count")
    ap.add_argument("--pattern-len", type=int, default=8,
                    help="synthetic-load pattern length")
    ap.add_argument("--hot-fraction", type=float, default=0.25,
                    help="fraction of synthetic queries drawn from a small "
                         "hot set (exercises the result cache)")
    ap.add_argument("--verify", choices=["eager", "lazy", "off"],
                    default="lazy",
                    help="artifact integrity posture at open: pre-check "
                         "every whole-file checksum (eager), verify corpus "
                         "chunks as reads load them (lazy, default), or "
                         "trust the bytes (off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the card with the CUDA kernels; cpu: the "
                         "plain PyTorch path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from repro_torch.serve.sa_engine import SuffixArrayIndex

    t0 = time.perf_counter()
    idx = SuffixArrayIndex.open(
        args.index_dir,
        store_backend=args.store_backend,
        cache_budget_bytes=args.cache_budget,
        num_shards=args.shards,
        result_cache_bytes=args.result_cache,
        verify=args.verify,
        device=args.device,
        use_pallas=args.device == "cuda",
    )
    print(f"opened {args.index_dir}: {idx.stats()['suffixes']} suffixes, "
          f"backend={args.store_backend}, lcp={idx.lcp is not None} "
          f"({time.perf_counter() - t0:.2f}s)")

    if args.pattern:
        pats = [np.array([int(t) for t in p.split(",") if t != ""], np.int64)
                for p in args.pattern]
        counts = idx.count(pats)
        occs = (idx.align(pats) if not idx.store.text_mode
                else idx.locate(pats))
        for p, c, o in zip(pats, counts, occs, strict=True):
            shown = list(o[:8]) if not isinstance(o, list) else o[:8]
            more = "" if c <= 8 else f" (+{c - 8} more)"
            print(f"  pattern {[int(t) for t in p]}: "
                  f"count={int(c)} at {shown}{more}")
        idx.close()
        return

    # synthetic load: sample patterns out of the corpus (guaranteed hits)
    # plus a hot set replayed at --hot-fraction
    rng = np.random.default_rng(args.seed)
    eng = idx.engine
    n = int(np.asarray(idx.sa).shape[0])
    if n == 0:
        print("empty index; nothing to query")
        idx.close()
        return
    m = args.pattern_len

    def sample(count):
        g = np.asarray(idx.sa, np.int64)[rng.integers(0, n, count)]
        win = idx.store.fetch_windows(g, 0)[:, : min(m, idx.store.k)].cpu().numpy()
        out = []
        for row in win:
            row = row[row > 0]
            out.append(row.astype(np.int64) if row.size else
                       np.array([1], np.int64))
        return out

    hot = sample(max(1, args.queries // 50))
    lat = []
    served = 0
    t0 = time.perf_counter()
    while served < args.queries:
        b = min(args.batch, args.queries - served)
        batch = sample(b)
        take = rng.random(b) < args.hot_fraction
        for i in np.flatnonzero(take):
            batch[i] = hot[int(rng.integers(0, len(hot)))]
        t1 = time.perf_counter()
        idx.count(batch)
        lat.append((time.perf_counter() - t1) / b)
        served += b
    wall = time.perf_counter() - t0
    lat_us = np.sort(np.array(lat)) * 1e6
    st = idx.stats()
    print(f"served {served} queries in {wall:.2f}s "
          f"({served / wall:.0f} qps, batch={args.batch})")
    print(f"  per-query latency p50={lat_us[len(lat_us) // 2]:.0f}us "
          f"p95={lat_us[int(len(lat_us) * 0.95)]:.0f}us")
    print(f"  cache: {st['cache_hits']} hits / "
          f"{st['cache_hits'] + st['cache_misses']} lookups; "
          f"search rounds={st['search_rounds']} "
          f"compare rounds={st['compare_rounds']}; "
          f"store requests={st['store_requests']} "
          f"({st['store_response_bytes']}B)")
    print(f"  shards={eng.num_shards} lcp_accelerated={st['lcp_accelerated']}")
    idx.close()


if __name__ == "__main__":
    main()
