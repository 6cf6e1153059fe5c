#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --stream-reads 5000 12000  # phase 9's streaming build only
    python3 chip_smoke.py --merge-ab PARENT_TREE 10  # phase 8's reads cell, A/B
    python3 chip_smoke.py --gather-ab PARENT_TREE 4  # window_gather, A/B
    python3 chip_smoke.py --merges 5000 20  # phase 10 only, at these sizes
    python3 chip_smoke.py --resume 50000 26  # phase 11 only, at these sizes
    python3 chip_smoke.py --build-modes 1000000 26  # phase 12 only, at these sizes
    python3 chip_smoke.py --ranks 250000 24 4  # phase 13 only: reads, text, ranks
    python3 chip_smoke.py --ranks-ooc 50000 4  # phase 14 only: reads, ranks
    python3 chip_smoke.py --lm  # phase 15 only: LM serving
    python3 chip_smoke.py --train  # phase 16 only: LM training
    python3 chip_smoke.py --nccl  # on four cards: one NCCL rank a card

Run from the root of a checkout on a machine with one CUDA card.  Phases,
each of which fails loudly:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel to its plain PyTorch version on the card with
   ``torch.equal``, at the kernel-test shapes (``prefix_pack``'s edge
   lengths, views and wide tokens, ``pattern_search`` on the CPU tests'
   corpora and boundary patterns, ``pattern_cmp``'s and
   ``merge_path_ranks``' edge rows, ``merge_path_ranks``' tiles of sorted
   runs, ``bucket_hist``'s edge splitters (keys at offsets 0 and 1), and the
   int32-max fault inputs of ``bucket_hist`` and ``bitonic_sort_tiles``
   included, ``bitonic_sort_tiles``' edge cases (tiles 1-4, ragged tiles of
   4096 to 2^20, a tile above n, equal keys, int32 extremes, views) and its
   tiles above 2048, and ``window_gather``'s edge cases: ragged tiles, k = 1, 40,
   100 and 1000, rows and offsets out of range, R·L = 0 and corpus views whose
   base is not 16-byte aligned) and at the full-size shapes of phases 5 and
   7 (for the last two: 2^26 Map records of the text cell, D = 512, tiles
   of 1024, and for ``bitonic_sort_tiles`` also 2^16 and 2^20, with its
   CUDA launches a call), and time both, and for the last two the nearest
   composition of PyTorch calls; ``bucket_hist`` also at its phase-13 shape
   (a rank's ``RANKS_KEYS`` records, D = 4: its JSON entry, with D = 512
   under ``d512``); ``window_gather`` also at 2^14 requests (about a
   device-merge tile's); ``merge_path_ranks`` also on full synthetic tiles (C = 4 x 4096,
   W = 4 and 23), random and as 4 sorted runs, timed beside
   ``torch.unique``'s inverse index (the same ranks on unique rows);
4. small end-to-end builds on the card (kernels on) against the numpy oracle,
   and small ``SuffixArrayIndex`` builds whose count/locate/align answers
   are held to brute force (served through ``pattern_search``);
5. two full-size builds through ``repro_torch.launch.sa_build``'s code path,
   each with the kernels and with the plain path on the card: 1 M DNA reads
   of 200 tokens (201 M suffixes) and a 2^26-token text.  Both paths must
   give the same suffix array, Footprint and stats with nothing dropped or
   unresolved, the SA must be a permutation of the valid suffixes, and 2^20
   sampled adjacent pairs must be in suffix order.  Each build's launch
   counts are set to 0 just before it and read just after: ``prefix_pack``
   must launch in the text build, ``window_gather`` in the reads build, and
   no kernel on the plain path;
6. one profiled kernel-path build of each (``torch.profiler``): device busy
   share and device time by kind of kernel;
7. the query path at full size: ``SuffixArrayIndex.build`` with its LCP
   array over the reads of phase 5 and over the 2^26-token text, then
   batches of 4096 alignment seeds sampled from SA rows (a quarter from a
   hot set) through ``count`` and one batch through ``align``.  A second
   engine on the plain compare must give the same ranges and
   ``engine_stats()``; ``pattern_search`` must launch on the kernel engine
   (and, on the reads index, no ``pattern_cmp``) and nothing on the plain
   one; every range is checked at its edges against the tokens, and 2^20
   sampled LCP values against a direct compare.  One 4096-seed
   ``pattern_search`` call a bound is held to its plain version (bounds,
   levels, rounds) and timed (CUDA events, the profiler's device time)
   beside its byte bound and its chain of dependent loads;
8. the out-of-core build: the text of phase 5 cut to 2^``OOC_TEXT_LOG2``
   tokens and its reads cut to ``OOC_READS`` reads (same read length,
   alphabet and seed), with
   ``SuperblockConfig(num_superblocks=4, emit_lcp=True)``, each built with
   the kernels, on the plain path, and with the kernels and
   ``merge_backend="device"``.  Every build's SA and LCP must equal the
   in-core ones of the same corpus bit for bit (phases 5 and 7 for the
   text; a checked in-core build for the cut reads); the kernel and plain
   builds must give the same Footprint and stats (wall times aside);
   nothing dropped or unresolved, ``peak_records <= capacity_records``;
   ``merge_path`` must launch on the kernel path and not on the plain one.
   A smaller kernel-path reads build is profiled, and its largest and
   widest merge tiles (full tiles: 4 runs x 4096 heads) are held to the
   plain ranks (a permutation) and timed beside ``torch.unique``, with
   their run count R and the bound it gives;
9. persistence: right after phase 7, its reads index is saved (SA, LCP,
   corpus, manifest), reopened with ``verify="eager"`` on the chunked
   store (a 1 GiB cache) and on the memory store, and phase 7's seed
   batches are answered again: the ranges must equal the in-memory
   index's, ``pattern_cmp`` must launch on the chunked store (its round
   loop) and ``pattern_search`` on the memory store.  After phase 8, a streaming
   build
   (``store_backend="chunked"`` at a quarter of the corpus bytes, S = 4,
   LCP) of ``STREAM_READS`` reads (or, with ``--stream-reads``, each
   count given) goes into an index directory through
   ``SuffixArrayIndex.build(index_dir=...)``: its SA and LCP must equal
   the in-memory build's, ``peak_resident_bytes`` stay within the budget
   and ``merge_path`` launch.  Index directories live in a temporary
   directory that the phase removes;
10. the k-way and re-rank merges and the retrying store on the card:
   ``MERGE_READS`` reads and a 2^``MERGE_TEXT_LOG2``-token text, S = 4,
   LCP, each built with ``merge_algorithm="merge_path"`` (kernels; the
   reference), ``"kway"`` (kernels, plain) and ``"rerank"`` (kernels,
   plain, and kernels with ``merge_backend="device"``).  Every build's SA
   and LCP must equal the ``merge_path`` build's; kernels and plain give
   the same Footprint and stats (wall times aside); nothing dropped or
   unresolved, ``peak_records <= capacity_records``; ``prefix_pack``
   launches in the text kernel builds, ``window_gather`` in the reads
   kernel builds, nothing on the plain path.  Then the reads are built
   from a ``FlakyBackend`` on the card (every third store call fails
   twice) with ``store_retries=3``: the fault-free build's SA, LCP,
   Footprint and stats (walls and retry counters aside), with faults
   injected and retried.  Last, ``kway`` and ``rerank`` stream
   ``STREAM_MERGE_READS`` reads from the chunked store at a quarter of the
   corpus bytes: the in-memory build's SA, ``peak_resident_bytes`` within
   the budget;
11. crash safety on the card: phase 8's reads cell cut to ``RESUME_READS``
   reads (memory store; its unjournaled build made first) built journaled
   (``resume=True`` with a ``spill_dir``), then journaled and sanitized: the
   SA, LCP and Footprint of the unjournaled kernel build, and its
   stats but those the journal (its flags, the memory store's spilled runs)
   and the sanitizer (its flag, the cache hits of its audit reads) move.
   Then, journaled, killed at the last ``build:block`` (no worker) and
   resumed: the journaled build, with 3 blocks from the journal; killed at
   the merge's first ``merge:rank`` and resumed: 4 blocks from the
   journal, no kernel launched in phase 2 and ``merge_path_ranks`` as
   often as in the journaled build.  Phase 8's text cell, journaled,
   killed at ``merge:rank`` and resumed: phase 8's build, ``prefix_pack``
   launched 0 times.  ``STREAM_MERGE_READS`` reads streamed from the
   chunked store at a quarter of the corpus bytes, journaled and
   sanitized, killed a quarter of the way through the merge's refills and
   resumed: the unjournaled streaming build, ``peak_resident_bytes``
   within the budget.  Each wall is printed beside the unjournaled one;
12. the other build modes through the launcher's ``run`` on the card:
   ``--mode terasort`` over phase 5's reads (its SA must equal phase 5's
   in-core SA, and the scheme's shuffle bytes over TeraSort's must be
   exactly 16 / (L + 9)), ``--mode doubling`` over phase 5's text (phase
   5's SA) and over the reads cut to ``OOC_READS``, flattened with a
   separator after every read (a permutation, 2^20 sampled pairs in text
   order), each with its wall, suffixes/s, peak device memory and the wall
   of every doubling round; then ``find_duplicate_spans`` and
   ``dedup_corpus`` in modes ``scheme`` and ``doubling`` over a 2^20-token
   text with planted duplicate spans: the same spans, mask and stats, and
   one copy of every intact planted span masked.  The TeraSort and text
   doubling builds are profiled once more, as phase 6 profiles.  Nothing dropped or
   unresolved, and no kernel launched: neither mode of ``src/repro`` calls
   one;
13. world size 4 on the one card: ``RANKS_D`` processes, one gloo rank each
   (NCCL takes one rank a card), over ``synth_dna_reads(RANKS_READS, 200,
   seed=0)`` and ``synth_token_corpus(2**RANKS_TEXT_LOG2, 4, seed=0)``: the
   scheme with the kernels and plain on both, TeraSort on the reads,
   doubling on the text, and ``refine_indices`` over ``RANKS_REFINE``
   sampled suffixes of the reads.  Every build's SA must equal a one-rank
   kernel build of the same corpus made in the parent before the ranks
   start (the refinement: its subset in SA order), every rank's result
   rank 0's, kernels == plain (SA, Footprint, stats), and nothing dropped
   or unresolved.  ``bucket_hist`` (the partition) must launch in every
   kernel build, ``prefix_pack`` in the text scheme build and
   ``window_gather`` in the reads scheme build, nothing on the plain path.
   Each build's wall (the largest rank's, barrier to barrier), suffixes/s,
   each rank's peak device memory and its bytes through the exchange.  Then
   ``torchrun --nproc-per-node 4 -m repro_torch.launch.sa_build`` at
   ``RANKS_LAUNCH_READS`` reads on the card: exit 0, rank 0 alone printing
   4 ``per_device_counts`` with nothing dropped or unresolved;
14. the out-of-core paths on ``RANKS_D`` gloo ranks on the one card, each
   between barriers: (a) phase 8's reads cell cut to ``OOC_RANKS_READS``
   reads (S = 4, LCP, kernels, host merge): its one-rank SA and LCP
   (digests passed to the ranks);
   (b) the device merge at ``OOC_RANKS_DEVICE_READS`` reads: its one-rank
   build's SA and LCP; (c) (a) journaled into an index directory, killed on
   every rank at the first ``merge:rank`` and resumed: 4 blocks from the
   journal on every rank, (a)'s result, and the directory's
   ``suffix_array.npy``, ``lcp.npy`` and ``corpus.sachunk`` those of a
   one-rank build; (d) ``SuffixArrayIndex.open`` of (c)'s directory on every
   rank (the memory store): a 4096-seed count batch and an align batch, the
   one-rank index's answers, ``pattern_search`` launched; (e)
   ``OOC_RANKS_STREAM_READS`` reads streamed from the chunked store at a
   quarter of the corpus bytes into an index directory: the in-memory SA,
   ``peak_resident_bytes`` within the budget on every rank; (f) ``torchrun
   --nproc-per-node 4 -m repro_torch.launch.sa_build`` at
   ``OOC_RANKS_LAUNCH_READS`` reads, ``--superblocks 4 --index-dir
   --resume``: exit 0, then ``repro_torch.launch.serve`` answers a pattern.
   Every rank's result must be rank 0's; ``merge_path`` and
   ``window_gather`` launch in (a), ``bucket_hist`` in every block build.
   Each build's wall (the largest rank's), each rank's peak memory and
   exchange bytes, and the host's core count;
15. LM serving on the card (``repro_torch.models``, ``serve.engine``,
   ``launch.lm_serve``; no SA kernel may launch): (a) ``LM_ARCH``
   (gemma3-1b: 26 layers, d_model 1152, vocab 262144) in bfloat16 through
   ``lm_serve.serve``: batch 4, 1024-token prompts (past the local layers'
   512-token window), a 2048-position cache, 32 greedy decode steps: the
   prefill wall, decode tokens/s, peak memory, and one decode step
   profiled (device busy share, device time by kind, launches) beside its
   byte bound; (b) the same arch in float32 (TF32 off): prefill of 600
   tokens then one decode step against the forward over 601, and
   ``decode_step_windowed`` on ring caches built from the prefill's cache
   against ``decode_step``, within ``LM_TOL``/``LM_DECODE_TOL`` of the
   logit scale; (c) ``ServeEngine`` on (b)'s model: 8 requests of 16-64
   prompt tokens over 4 slots, 16 new tokens each: every request retires
   at the step ``schedule_steps`` gives, and every token is the
   teacher-forced forward's argmax within the decode tolerance; (d) every
   other full config one card holds (``LM_OTHERS``; mixtral-8x7b is left
   out and named), bfloat16 drawn on the card: a 2 x 256 prefill (frame or
   patch embeddings for the embeddings-mode archs) and 8 decode steps, with
   finite logits, walls and peak; (e) the nine tiny configs in float32,
   the card against the CPU on the same weights (forward, prefill, decode,
   loss);
16. LM training on the card (``repro_torch.train``, ``checkpoint``,
   ``runtime``, ``launch.train``; no SA kernel may launch): (a)
   ``TRAIN_ARCH`` (gemma3-1b) at full width in bfloat16 through
   ``launch.train.train``: the synthetic corpus, ``TRAIN_STEPS`` steps of
   ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens on a cosine schedule, the
   launcher's step wrapped to time each step: the losses finite and
   falling, the median step past the first, tokens/s, peak memory, one step
   profiled (device busy share, launches, device time by kind), the
   autograd cost of ``layer_params``' per-layer reads of the stacked
   leaves and the time of ``adamw_update`` alone; (c) that run's last
   ``TrainState`` (about 14 GB) through
   ``CheckpointManager.save(blocking=True)`` and ``restore`` onto the card:
   every leaf bit-equal, the bytes on disk and both walls; (b) the same
   arch in float32 (TF32 off) cut to ``TRAIN_CHECK_LAYERS`` layers (one
   LLLLLG period): one step from one state (drawn moments at step 3) and a
   ``TRAIN_CHECK_BATCH`` x ``TRAIN_CHECK_LEN`` batch on the card and on the
   CPU (loss, lr, grad_norm, every leaf of the new state), then
   ``microbatches=2`` against 1 on the card; (d) ``TRAIN_TINY`` on the
   card: ``run_training`` with faults injected and a preemption at step 6,
   then ``resume=True``: the uninterrupted run's losses, the retries
   counted; (e) the nine tiny configs in float32, one step each, card
   against CPU.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  ``--merges READS LOG2`` runs
phases 1-2 and then phase 10 alone at those sizes, ``--resume READS LOG2``
phase 11 alone (against unjournaled builds it makes itself; no result line),
``--build-modes READS LOG2`` phase 12 alone (against in-core scheme builds it
makes itself; no result line), ``--ranks READS LOG2 D`` phase 13 alone at D
ranks, ``--ranks-ooc READS D`` phase 14 alone at READS reads on D ranks,
``--lm`` phase 15 alone, ``--train`` phase 16 alone (no result line).  ``--nccl`` (on a machine with four cards, never in the
one-card run) runs phase 13's reads scheme build and TeraSort and phase 14
(a) and (c) under ``torchrun --nproc-per-node 4`` with one rank a card,
where ``sa_build.backend_for`` picks NCCL: each must equal its one-rank
build (no result line).
Without CUDA, or without the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
# int32 multiply-adds outside the tensor cores: an SM issues half as many
# int32 as float32 lanes a clock, so half the 67 TFLOP/s float32 rate.
PEAK_INT32_OPS_PER_S = 33.5e12
FULL_READS, FULL_READ_LEN = 1_000_000, 200
FULL_TEXT = 1 << 26
GATHER_M = 1 << 22
GATHER_SMALL_M = 1 << 14  # about a device-merge tile's requests
PAIR_SAMPLES = 1 << 20
READS_BUILD, TEXT_BUILD = "reads 1M x 200", "text 2^26"
READS_QUERY, TEXT_QUERY = "reads query", "text query"
# phase 8's cells: the corpora of phase 5 cut to OOC_READS reads and a
# 2^OOC_TEXT_LOG2 text (same read length, alphabet and seed) so their three
# builds each fit the time limit on a slow host (the walls that forced the
# cuts are in PERF.md); its profiled build is smaller still, since the
# profiler's bookkeeping grows with the merge's op count
OOC_READS = 50_000
OOC_TEXT_LOG2 = 24
OOC_PROFILE_READS = 5_000
READS_OOC = f"reads {OOC_READS // 1000}K x 200 out-of-core"
TEXT_OOC = f"text 2^{OOC_TEXT_LOG2} out-of-core"
# phase 11's reads cell, cut further: its six builds include a sanitized one
RESUME_READS = 20_000
# phase 8: superblocks of the out-of-core cells; full-size merge tiles of
# phase 3 (C = 4 runs x 4096 heads)
OOC_SUPERBLOCKS = 4
MERGE_C = 4 * 4096
# phase 7: (seeds, seed length) per index, sent as count batches of QUERY_BATCH
QUERY_BATCH = 4096
QUERIES = {READS_QUERY: (1 << 16, 24), TEXT_QUERY: (1 << 14, 16)}
HOT_FRACTION = 0.25
# phase 3: the partition and tile-sort kernels at full size (2^26 records)
HIST_D, SORT_TILE = 512, 1024
# bitonic_sort_tiles is also timed at larger tiles over the same records
SORT_TILES = (SORT_TILE, 1 << 16, 1 << 20)
# phase 9: the chunked store's cache for the reopened reads index (its
# 0.8 GB corpus fits: a smaller cache reloads most chunks every search
# round), and the streaming build's reads, cut from phase 8's reads (the
# walls that forced the cuts are in PERF.md)
OPEN_CACHE_BYTES = 1 << 30
STREAM_READS = 1_000
# phase 10: the corpora of the k-way and re-rank merges, cut from 5 000 reads
# and a 2^20 text (the k-way heap and its cursor's singleton fetches, and the
# re-rank's splitter scans, are host work: the walls that forced the cuts are
# in PERF.md), and the reads of their streaming runs
MERGE_READS = 250
MERGE_TEXT_LOG2 = 17
STREAM_MERGE_READS = 200
# phase 12: the dedup cell, a 2^20-token text with planted duplicate spans
# (without them a random 4-token text has no repeat of 32 tokens)
DEDUP_LOG2, DEDUP_FRACTION, DEDUP_SPAN = 20, 0.05, 64
# phase 13: world size 4 on the one card, gloo ranks (NCCL takes one rank a
# card).  The corpora are cut from phase 5's 1 M reads and 2^26 text: gloo
# stages every exchange through host memory (PERF.md section 4).  A rank's
# partition of the reads build is RANKS_KEYS Map records (phase 3 times
# bucket_hist there); refine_indices ranks RANKS_REFINE sampled suffixes of
# the reads; the launcher runs under torchrun at RANKS_LAUNCH_READS reads
RANKS_D, RANKS_READS, RANKS_TEXT_LOG2 = 4, 250_000, 24
RANKS_KEYS = RANKS_READS // RANKS_D * (FULL_READ_LEN + 1)
RANKS_REFINE = 1 << 16
RANKS_LAUNCH_READS = 10_000
# (build, corpus, mode, kernels) of phase 13, each on every rank
RANKS_BUILDS = (("reads scheme kernels", "reads", "scheme", True),
                ("reads scheme plain", "reads", "scheme", False),
                ("text scheme kernels", "text", "scheme", True),
                ("text scheme plain", "text", "scheme", False),
                ("reads terasort kernels", "reads", "terasort", True),
                ("text doubling kernels", "text", "doubling", True),
                ("reads refine kernels", "reads", "refine", True))
RANKS_READS_BUILD = f"{RANKS_D} ranks reads {RANKS_READS // 1000}K x 200 scheme kernels"
# the full-size run whose main path each kernel lies on
KERNEL_BUILD = {"prefix_pack": TEXT_BUILD, "window_gather": READS_BUILD,
                "bucket_hist": RANKS_READS_BUILD, "pattern_search": READS_QUERY,
                "pattern_cmp": "reads reopened chunked", "merge_path": READS_OOC}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_equal(name, got, want):
    import torch

    if not torch.equal(got, want):
        err = (got.long() - want.long()).abs().max().item()
        raise AssertionError(f"{name}: kernel != plain version (max |err| {err})")


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item()) if got.numel() else 0


def byte_or_op_bound(nbytes: float, int32_ops: float):
    """(bound ms, what bounds it): the larger of bytes moved over the memory
    rate and int32 operations over the int32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, int32_ops / PEAK_INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev, reads_corpus, text_tokens):
    """Kernel vs plain version at the test and the full-size shapes."""
    import numpy as np
    import torch

    from repro_torch.config import SAConfig
    from repro_torch.kernels import bitonic_sort as bs_mod
    from repro_torch.kernels import bucket_hist as bh_mod
    from repro_torch.kernels import cases, ref
    from repro_torch.kernels import merge_path as mp_mod
    from repro_torch.kernels import pattern_cmp as pc_mod
    from repro_torch.kernels import prefix_pack as pp_mod
    from repro_torch.kernels import window_gather as wg_mod
    from repro_torch.launch.sa_build import make_config

    for c in cases.PACK_CFGS:
        cfg = SAConfig(**c)
        for n in cases.PACK_LENGTHS:
            toks = torch.from_numpy(cases.pack_tokens(c, n)).to(dev)
            check_equal(f"prefix_pack {c} n={n}",
                        pp_mod.prefix_pack(toks, cfg, block=cases.PACK_BLOCK),
                        ref.prefix_pack_ref(toks, cfg))
        for name in cases.PACK_EDGE:
            toks, off = cases.pack_edge_tokens(c, name)
            toks = torch.from_numpy(toks).to(dev)[off:]
            for block in (cases.PACK_BLOCK, 512, 60):
                check_equal(f"prefix_pack {c} {name} block={block}",
                            pp_mod.prefix_pack(toks, cfg, block=block),
                            ref.prefix_pack_ref(toks, cfg))
    search_cases(dev)
    for case, name in zip([*cases.GATHER_CASES, cases.GATHER_LARGE],
                          [*cases.GATHER_IDS, "large"], strict=True):
        *args, k = cases.gather_case(case, dev)
        check_equal(f"window_gather {name} (r, l, m, k = {tuple(args[0].shape)}, "
                    f"{args[1].shape[0]}, {k}; 16-byte loads "
                    f"{wg_mod._vector_path(args[0])})",
                    wg_mod.window_gather(*args, k), ref.window_gather_ref(*args, k))
    cmp_cases = [(f"n={n} k={k} block={block}", cases.cmp_inputs(n, k), block)
                 for n, k, block in cases.CMP_SHAPES]
    cmp_cases += [(f"edge rows k={k}", cases.cmp_edge_inputs(k), 256)
                  for k in cases.CMP_EDGE_K]
    for name, arrays, block in cmp_cases:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        check_equal(f"pattern_cmp {name}", pc_mod.pattern_cmp(*args, block=block),
                    ref.pattern_cmp_ref(*args))
    merge_cases = [(f"c={c} w={w} block={block}", cases.merge_inputs(c, w), block)
                   for c, w, block in cases.MERGE_SHAPES]
    merge_cases += [(f"edge {name}", cases.merge_edge_inputs(name), 256)
                    for name in cases.MERGE_EDGE]
    merge_cases += [(f"{r} sorted runs block={block}", cases.merge_runs_inputs(r), block)
                    for r in cases.MERGE_RUNS for block in (256, 40)]
    merge_cases += [(f"runs {name}", cases.merge_run_edge_inputs(name), 256)
                    for name in cases.MERGE_RUN_EDGE]
    for name, keys, block in merge_cases:
        keys = torch.from_numpy(keys).to(dev)
        check_equal(f"merge_path_ranks {name}",
                    mp_mod.merge_path_ranks(keys, block=block),
                    ref.merge_path_ranks_ref(keys))
    hist_cases = [(f"n={n} d={d}", cases.hist_inputs(n, d), cases.HIST_BLOCK)
                  for n, d in cases.HIST_SHAPES]
    arrays, block = cases.fault_arrays(cases.HIST_FAULT)
    hist_cases.append(("int32-max fault input", list(arrays.values()), block))
    hist_cases += [(f"edge {name} at key offset {off}", cases.hist_edge_inputs(name),
                    cases.HIST_BLOCK, off)
                   for name in cases.HIST_EDGE for off in (0, 1)]
    for name, arrays, block, *off in hist_cases:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        if off:  # keys as views one key into their storage
            args[:2] = [a[off[0]:] for a in args[:2]]
        check_bucket_hist(f"bucket_hist {name}",
                          bh_mod.bucket_hist(*args, block=block),
                          ref.bucket_hist_ref(*args))
    sort_cases = [(f"n={n} tile={t}", cases.sort_inputs(n, t), t, 0)
                  for n, t in [*cases.SORT_SHAPES, *cases.SORT_LARGE]]
    arrays, tile = cases.fault_arrays(cases.SORT_FAULT)
    sort_cases.append(("int32-max fault input", list(arrays.values()), tile, 0))
    for name in cases.SORT_EDGE:
        *arrays, tile, offset = cases.sort_edge_inputs(name)
        sort_cases.append((f"edge {name}", arrays, tile, offset))
    for name, arrays, tile, offset in sort_cases:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        if offset:  # columns as views `offset` elements into their storage
            args = [torch.cat([a.new_zeros(offset), a])[offset:] for a in args]
        bs_mod.bitonic_sort_tiles.cuda_launches = 0
        got = bs_mod.bitonic_sort_tiles(*args, tile=tile)
        check_sorted_tiles(f"bitonic_sort_tiles {name} (CUDA launches "
                           f"{bs_mod.bitonic_sort_tiles.cuda_launches}, 16-byte "
                           f"path {bs_mod._vector_path(*args)})",
                           got, ref.bitonic_sort_tiles_ref(*args, tile))
    log("phase 3: kernels == plain versions at the tests/test_kernels.py shapes, "
        "prefix_pack's edge lengths, views and wide tokens, pattern_search on "
        "the CPU tests' corpora, "
        "window_gather's edge cases (misaligned views included), "
        "the edge rows of pattern_cmp and merge_path_ranks, merge_path_ranks' "
        "tiles of sorted runs, bucket_hist's edge splitters, the int32-max "
        "fault inputs of bucket_hist and bitonic_sort_tiles, and "
        "bitonic_sort_tiles' edge cases and tiles above 2048")

    out = {}
    # prefix_pack at the text Map's shape: the 2^26 tokens plus the K-token halo
    cfg = make_config("base", "cuda")
    k = cfg.prefix_len
    flat = torch.from_numpy(np.concatenate(
        [text_tokens, np.zeros(k, np.int32)])).to(dev)
    got = pp_mod.prefix_pack(flat, cfg)
    want = ref.prefix_pack_ref(flat, cfg)
    check_equal("prefix_pack full size", got, want)
    records = want[: text_tokens.shape[0]]  # the text cell's Map records
    n = flat.shape[0]
    # bytes: each token read once, each key word written once; operations:
    # one multiply and one add per token of each position's K-token window
    bound_ms, bound_by = byte_or_op_bound(4 * n * (1 + cfg.key_words), 2 * k * n)
    out["prefix_pack"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: pp_mod.prefix_pack(flat, cfg), 20),
        plain_ms=time_ms(lambda: ref.prefix_pack_ref(flat, cfg), 3),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"N={n}, key_words={cfg.key_words}, K={k}",
    )
    del got, want, flat
    out.update(sort_kernels_full_size(records))
    del records

    # window_gather at the refinement fetch's chunk: 2^22 requests, k = 26,
    # on the full-size 1 M x 200 corpus (rows/offsets incl. out-of-range);
    # and at about a device-merge tile's requests, 2^14
    corpus = torch.from_numpy(reads_corpus).to(dev)
    for m in (GATHER_M, GATHER_SMALL_M):
        o = gather_timing(wg_mod.window_gather, corpus, k, m)
        if m == GATHER_M:
            out["window_gather"] = o
        else:
            rows, offs = gather_requests(*corpus.shape, m, dev)
            launch_ms = device_ms(lambda: wg_mod.window_gather(corpus, rows, offs, k),
                                  "window_gather")
            log(f"phase 3: window_gather small ({o['shape']}): kernel {o['ms']:.4f} ms "
                f"(device {launch_ms:.4f} ms a launch), plain {o['plain_ms']:.4f} ms, "
                f"bound {o['bound_ms']:.4f} ms ({o['bound_by']}), "
                f"max|err| {o['max_abs_err']}")
    del corpus

    # pattern_cmp at the query engine's largest launch: one row per seed of a
    # 4096-pattern batch, K = 26
    args = [torch.from_numpy(a).to(dev) for a in cases.cmp_inputs(QUERY_BATCH, k)]
    got = pc_mod.pattern_cmp(*args)
    want = ref.pattern_cmp_ref(*args)
    check_equal("pattern_cmp B=4096", got, want)
    # bytes: the window tokens this data needs (in-range columns up to the
    # first mismatch) from both windows, start/stop read, [cmp, matched]
    # written; operations: one compare per token read
    sfx, _, start, stop = args
    lo, hi = start.clamp(min=0), stop.clamp(max=k)
    first = want[:, 1] + start
    needed = torch.where(want[:, 0] != 0, first - lo + 1, hi - lo).clamp(min=0)
    tokens = int(needed.sum())
    b = sfx.shape[0]
    bound_ms, bound_by = byte_or_op_bound(2 * 4 * tokens + 8 * b + 8 * b, tokens)
    out["pattern_cmp"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: pc_mod.pattern_cmp(*args), 200),
        plain_ms=time_ms(lambda: ref.pattern_cmp_ref(*args), 20),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"B={b}, K={k}, {tokens} window tokens needed",
    )
    # at this size a call costs its host launch path more than its device
    # time: read the device time alone from the profiler
    log(f"phase 3: pattern_cmp B={b}: device time "
        f"{device_ms(lambda: pc_mod.pattern_cmp(*args), 'pattern_cmp'):.4f} ms "
        f"a launch (profiler, 200 launches); CUDA events "
        f"{out['pattern_cmp']['ms']:.4f} ms a call, host launch path included")
    # merge_path_ranks at the merge's full tile, C = 4 x 4096: four words (the
    # depth-0 key words and the index words) and the widest row a reads
    # merge can build (every window level, the tie column, the index words);
    # rows in random order, and as the merge builds them, 4 sorted runs
    wide = (-(-(FULL_READ_LEN + 1) // k) + 2) * cfg.key_words + 3
    for runs in (None, OOC_SUPERBLOCKS):
        for w in (4, wide):
            keys = torch.from_numpy(merge_tile_keys(MERGE_C, w, runs)).to(dev)
            got = mp_mod.merge_path_ranks(keys)
            check_equal(f"merge_path_ranks C={MERGE_C} W={w} runs={runs}", got,
                        ref.merge_path_ranks_ref(keys))
            m = merge_path_timing(keys)
            log(f"phase 3: merge_path_ranks synthetic tile C={MERGE_C} W={w}, "
                f"{'random rows' if runs is None else f'{runs} sorted runs'} "
                f"(R = {m['runs']}): kernel {m['ms']:.4f} ms (device "
                f"{m['device_ms']:.4f} ms a call), plain {m['plain_ms']:.4f} ms, "
                f"library {m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
                f"({m['bound_by']})")
    for name, o in [*out.items(), ("bucket_hist", out["bucket_hist"]["d512"])]:
        lib = (f", library {o['library_ms']:.4f} ms ({o['library']})"
               if "library" in o else "")
        log(f"phase 3: {name} full size ({o['shape']}): kernel {o['ms']:.4f} ms, "
            f"plain {o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}){lib}, "
            f"max|err| {o['max_abs_err']}")
    return out


def search_cases(dev):
    """``pattern_search`` against its plain version on the card at the CPU
    tests' corpora and boundary patterns: 1-3 shards, with and without LCP,
    both bounds."""
    import torch

    from repro_torch import ShardedSAEngine
    from repro_torch.config import SAConfig
    from repro_torch.core.lcp import lcp_from_sa
    from repro_torch.core.store import CorpusStore
    from repro_torch.kernels import cases, ref
    from repro_torch.kernels import pattern_cmp as pc_mod

    for name in cases.SEARCH_CORPORA:
        corpus, sa = cases.search_corpus(name)
        store = CorpusStore(corpus, SAConfig(**cases.SEARCH_CFG), device=dev)
        lcp = lcp_from_sa(store, sa)
        for shards in (1, 2, 3):
            for with_lcp in (True, False):
                eng = ShardedSAEngine(store, sa, lcp=lcp if with_lcp else None,
                                      num_shards=shards, use_pallas=True)
                for upper in (False, True):
                    args = cases.search_args(eng, cases.search_patterns(corpus), upper)
                    got = pc_mod.pattern_search(*args)
                    want = ref.pattern_search_ref(*args)
                    for what, g, w in zip(("bound", "levels", "rounds"), got, want,
                                          strict=True):
                        check_equal(f"pattern_search {name} shards={shards} "
                                    f"lcp={with_lcp} upper={upper} {what}", g, w)
    torch.cuda.synchronize()


def gather_requests(r, l, m, device, seed=1):
    """m random (row, offset) requests over an (r, l) corpus, out-of-range
    rows and offsets included, on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, r + 1, size=(m,)).astype(np.int32)
    offs = rng.integers(0, l + 2, size=(m,)).astype(np.int32)
    return torch.from_numpy(rows).to(device), torch.from_numpy(offs).to(device)


def gather_bound(corpus, rows, offs, k):
    """window_gather's least time: the two index arrays, the corpus tokens
    these requests really read and the windows written, over the memory
    rate; no arithmetic beyond the indexing."""
    import torch

    r, l = corpus.shape
    m = rows.shape[0]
    valid = (rows >= 0) & (rows < r)
    tokens_read = int(torch.where(valid, (l - offs.clamp(0, l)).clamp(max=k), 0).sum())
    return byte_or_op_bound(8 * m + 4 * min(tokens_read, r * l) + 4 * m * k, 0)


def gather_timing(gather, corpus, k, m):
    """``gather`` (window_gather's signature) on m random requests: held to
    the plain version, timed beside it, with its bound."""
    from repro_torch.kernels import ref

    rows, offs = gather_requests(*corpus.shape, m, corpus.device)
    got = gather(corpus, rows, offs, k)
    want = ref.window_gather_ref(corpus, rows, offs, k)
    check_equal(f"window_gather M={m}", got, want)
    bound_ms, bound_by = gather_bound(corpus, rows, offs, k)
    return dict(
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: gather(corpus, rows, offs, k), 20 if m >= 1 << 20 else 200),
        plain_ms=time_ms(lambda: ref.window_gather_ref(corpus, rows, offs, k), 3),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"M={m}, k={k}, corpus {corpus.shape[0]}x{corpus.shape[1]}",
    )


def check_bucket_hist(name, got, want):
    for g, w in zip(got, want, strict=True):
        check_equal(name, g, w)


def check_sorted_tiles(name, got, want):
    """Keys equal row for row; values the same multiset in each key group
    (the kernel is not stable, as the TPU kernel is not)."""
    from repro_torch.kernels.cases import sorted_rows

    check_equal(f"{name} key_hi", got[0], want[0])
    check_equal(f"{name} key_lo", got[1], want[1])
    check_equal(f"{name} values per key group", sorted_rows(*got), sorted_rows(*want))


def sort_kernels_full_size(records):
    """``bucket_hist`` and ``bitonic_sort_tiles`` on 2^26 Map records of
    the text cell: D = 512 with 511 sorted sampled splitters, and tiles of
    1024, 2^16 and 2^20 with each record's index as its value (the kernel's
    entry holds tile 1024 and, under ``tiles``, the others).  Then
    ``bucket_hist`` at its main path's shape (phase 13): D = 4 over the
    first ``RANKS_KEYS`` records, a rank's partition of the 250 K-read
    build; its entry holds that, and D = 512 under ``d512``.
    ``bitonic_sort_tiles`` lies on no path of ``src/repro``; ``library_ms``
    times the nearest composition of PyTorch calls (one call computes
    neither function)."""
    import torch

    dev = records.device
    n = records.shape[0]
    kh, kl = records[:, 0].contiguous(), records[:, 1].contiguous()
    out = {"bucket_hist": dict(hist_timing(kh[:RANKS_KEYS], kl[:RANKS_KEYS], RANKS_D),
                               d512=hist_timing(kh, kl, HIST_D))}

    val = torch.arange(n, dtype=torch.int32, device=dev)
    tiles = {}
    for tile in SORT_TILES:
        tiles[tile] = sort_timing(kh, kl, val, tile)
        log(f"bitonic_sort_tiles tile={tile}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in tiles[tile].items()))
    out["bitonic_sort"] = dict(tiles[SORT_TILE], tiles={
        str(t): {k: v for k, v in o.items() if k.endswith(("ms", "launches"))}
        for t, o in tiles.items() if t != SORT_TILE})
    return out


def hist_timing(kh, kl, d):
    """``bucket_hist`` over keys (kh, kl) and d - 1 sorted splitters sampled
    from them, held to its plain version and timed beside it and the
    nearest library composition."""
    import torch

    from repro_torch.kernels import bucket_hist as bh_mod
    from repro_torch.kernels import ref

    n = kh.shape[0]
    gen = torch.Generator().manual_seed(17)
    pick = torch.randperm(n, generator=gen)[: d - 1].to(kh.device)
    order = torch.argsort(ref._fold(kh[pick], kl[pick]))
    sh, sl = kh[pick][order].contiguous(), kl[pick][order].contiguous()
    got = bh_mod.bucket_hist(kh, kl, sh, sl)
    want = ref.bucket_hist_ref(kh, kl, sh, sl)
    check_bucket_hist(f"bucket_hist N={n} D={d}", got, want)
    splits = ref._fold(sh, sl)

    def hist_library():
        bucket = torch.searchsorted(splits, ref._fold(kh, kl))
        return bucket, torch.bincount(bucket, minlength=d)

    lib = hist_library()
    check_equal("bucket_hist library composition", lib[1].to(torch.int32), want[1])
    # bytes: both key words read, the splitters read, buckets and histogram
    # written; operations: the log2(D) compares a key a search needs
    bound_ms, bound_by = byte_or_op_bound(8 * n + 8 * (d - 1) + 4 * n + 4 * d,
                                          n * (d - 1).bit_length())
    return dict(
        max_abs_err=max(max_abs_err(g, w) for g, w in zip(got, want, strict=True)),
        ms=time_ms(lambda: bh_mod.bucket_hist(kh, kl, sh, sl), 20),
        plain_ms=time_ms(lambda: ref.bucket_hist_ref(kh, kl, sh, sl), 3),
        library_ms=time_ms(hist_library, 20),
        library="torch.searchsorted over int64-folded splitters + torch.bincount",
        bound_ms=bound_ms, bound_by=bound_by, shape=f"N={n} Map records, D={d}")


def sort_timing(kh, kl, val, tile):
    """``bitonic_sort_tiles`` at one ``tile`` over the columns: held to the
    plain version, then its CUDA-event time, the plain
    version's and the library composition's (``torch.sort`` of the folded
    (N / tile, tile) view and a ``gather``), and the CUDA launches of the
    first call, as the wrapper counts them."""
    import torch

    from repro_torch.kernels import bitonic_sort as bs_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.cases import sorted_rows

    n = kh.shape[0]
    bs_mod.bitonic_sort_tiles.cuda_launches = 0
    got = bs_mod.bitonic_sort_tiles(kh, kl, val, tile)
    cuda_launches = bs_mod.bitonic_sort_tiles.cuda_launches
    want = ref.bitonic_sort_tiles_ref(kh, kl, val, tile)
    check_sorted_tiles(f"bitonic_sort_tiles full size, tile {tile}", got, want)
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
              max_abs_err(sorted_rows(*got), sorted_rows(*want)))
    del got, want

    def sort_library():
        keys, idx = torch.sort(ref._fold(kh, kl).view(-1, tile), dim=1)
        return keys, torch.gather(val.view(-1, tile), 1, idx)

    # bytes: three int32 columns read and written once; operations: one
    # compare per compare-exchange of the network, log2(T)(log2(T)+1)/2
    # stages of n/2 pairs
    lg = tile.bit_length() - 1
    bound_ms, bound_by = byte_or_op_bound(24 * n, n // 2 * lg * (lg + 1) // 2)
    reps = 20 if tile <= SORT_TILE else 5
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: bs_mod.bitonic_sort_tiles(kh, kl, val, tile), reps),
        plain_ms=time_ms(lambda: ref.bitonic_sort_tiles_ref(kh, kl, val, tile), 3),
        library_ms=time_ms(sort_library, reps),
        library=f"torch.sort of the int64-folded (N/{tile}, {tile}) view + torch.gather",
        bound_ms=bound_ms, bound_by=bound_by,
        cuda_launches=cuda_launches,
        shape=f"N={n} Map records, tile={tile}")


def merge_tile_keys(c, w, runs=None):
    """A synthetic merge tile of ``c`` rows and ``w`` words: about 16 rows
    share each leading word and the next words tie often, as neighbouring
    suffixes of a real tile do; the last two are the index words (unique).
    Rows in random order, or cut into ``runs`` equal runs, each sorted, as
    the merge concatenates its runs' frontiers.  Seeded by ``c + w``."""
    import numpy as np

    rng = np.random.default_rng(c + w)
    keys = np.zeros((c, w), np.int32)
    keys[:, 0] = rng.integers(0, max(1, c // 16), size=c)  # ~16 rows a value
    keys[:, 1 : w - 2] = rng.integers(0, 3, size=(c, w - 3))
    keys[:, w - 1] = rng.permutation(c)  # index words: hi 0, lo unique
    if runs:
        keys = np.concatenate([run[np.lexsort(run.T[::-1])]
                               for run in np.split(keys, runs)])
    return keys


def merge_path_bound(c, w, runs):
    """(bound ms, by) of ranking a tile of ``runs`` sorted runs: C·W·4 bytes
    read and C·4 written against the C·ceil(log2 R) word-0 compares that
    locating every row in the other runs needs at least."""
    return byte_or_op_bound(4 * c * w + 4 * c, c * (runs - 1).bit_length())


def merge_path_library(keys):
    """``torch.unique``'s inverse index of the rows: the rank of every row
    among the distinct rows, so the ranks on a tile of unique rows."""
    import torch

    return torch.unique(keys, dim=0, return_inverse=True)[1]


def merge_path_timing(keys):
    """Kernel (CUDA events, and the profiler's device time of a call's three
    launches), plain and library times of
    ``merge_path_ranks`` on ``keys`` (unique rows: the library's ranks are
    checked against the plain ones), with its run count and bound."""
    import torch

    from repro_torch.kernels import merge_path as mp_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.cases import merge_runs

    c, w = keys.shape
    runs = merge_runs(keys.cpu().numpy())
    bound_ms, bound_by = merge_path_bound(c, w, runs)
    check_equal(f"torch.unique ranks of a {tuple(keys.shape)} tile",
                merge_path_library(keys).to(torch.int32), ref.merge_path_ranks_ref(keys))
    out = dict(ms=time_ms(lambda: mp_mod.merge_path_ranks(keys), 20),
               plain_ms=time_ms(lambda: ref.merge_path_ranks_ref(keys), 3),
               library_ms=time_ms(lambda: merge_path_library(keys), 20),
               library="torch.unique(keys, dim=0, return_inverse=True)",
               bound_ms=bound_ms, bound_by=bound_by, runs=runs)
    # a profiler session right after a long one can come back without
    # device activity: take the first of three that has some
    calls = 20
    for _ in range(3):
        _, dev_ms, _ = profiled(
            lambda: [mp_mod.merge_path_ranks(keys) for _ in range(calls)])
        device_ms = sum(t for key, t in dev_ms.items() if "merge_path" in key)
        if device_ms > 0:
            out["device_ms"] = device_ms / calls
            return out
    raise AssertionError("merge_path_ranks: three profiler sessions recorded "
                         "no device time")


def phase_small_builds(dev):
    """Small builds on the card with the kernels, against the numpy oracle."""
    import numpy as np

    from repro_torch.config import SAConfig
    from repro_torch.core.oracle import doubling_sa_text, naive_sa_reads, naive_sa_text
    from repro_torch.core.pipeline import build_suffix_array
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = SAConfig(vocab_size=4, chars_per_word=2, key_words=2, use_pallas=True)
    rng = np.random.default_rng(0)
    reads = rng.integers(1, 5, size=(60, 15)).astype(np.int32)
    lens = rng.integers(0, 11, size=(25,)).astype(np.int32)
    var = np.zeros((25, 11), np.int32)
    for i, n in enumerate(lens):
        var[i, :n] = rng.integers(1, 5, size=(n,))
    text = rng.integers(1, 5, size=(300,)).astype(np.int32)
    atat = np.tile(np.array([1, 2, 1, 2], np.int32), 40)
    cases = [  # (name, corpus, lengths, oracle SA, the kernel its path runs)
        ("uniform reads", reads, None, naive_sa_reads(reads), "window_gather"),
        ("variable-length reads", var, lens, naive_sa_reads(var, lens),
         "window_gather"),
        ("random text", text, None, doubling_sa_text(text), "prefix_pack"),
        ("ATAT text", atat, None, naive_sa_text(atat), "prefix_pack"),
    ]
    for name, corpus, lengths, want, kernel in cases:
        reset_launch_counts()
        res = build_suffix_array(corpus, lengths=lengths, cfg=cfg, device=dev)
        counts = launch_counts()
        if not np.array_equal(res.suffix_array, want):
            raise AssertionError(f"phase 4: {name}: SA != oracle")
        if res.stats["dropped"] or res.stats["unresolved"]:
            raise AssertionError(f"phase 4: {name}: {res.stats}")
        if counts[kernel] <= 0:
            raise AssertionError(f"phase 4: {name}: {kernel} not launched: {counts}")
        log(f"phase 4: {name} == oracle on {dev}; launches {counts}")


def oracle_lcp(corpus, sa, stride_bits):
    """Brute-force LCP of consecutive suffixes of a small corpus: common
    leading tokens, a suffix ending at its first 0 (reads) or the text end."""
    import numpy as np

    def tokens(g):
        if corpus.ndim == 1:
            return corpus[g:]
        row = corpus[g >> stride_bits, g & ((1 << stride_bits) - 1):]
        return row[: np.argmax(row == 0)] if (row == 0).any() else row

    out = np.zeros(len(sa), np.int64)
    for i in range(1, len(sa)):
        a, b = tokens(int(sa[i - 1])), tokens(int(sa[i]))
        n = min(len(a), len(b))
        diff = np.flatnonzero(a[:n] != b[:n])
        out[i] = diff[0] if diff.size else n
    return out


def phase_small_out_of_core(dev):
    """Small out-of-core builds on the card with the kernels, three
    superblocks and the merge's LCP: SA against the numpy oracle, LCP
    against a brute-force compare; ``merge_path`` must launch in every
    build whose merge had two runs or more."""
    import numpy as np

    from repro_torch.config import SAConfig, SuperblockConfig
    from repro_torch.core import superblock
    from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = SAConfig(vocab_size=4, chars_per_word=2, key_words=2, use_pallas=True)
    rng = np.random.default_rng(5)
    reads = rng.integers(1, 5, size=(48, 12)).astype(np.int32)
    lens = rng.integers(0, 11, size=(30,)).astype(np.int32)
    var = np.zeros((30, 11), np.int32)
    for i, n in enumerate(lens):
        var[i, :n] = rng.integers(1, 5, size=(n,))
    rep = np.tile(np.array([1, 2] * 6, np.int32), (36, 1))
    text = rng.integers(1, 5, size=(600,)).astype(np.int32)
    atat = np.tile(np.array([1, 2], np.int32), 120)
    cases = [  # (name, corpus, lengths, SuperblockConfig overrides)
        ("reads", reads, None, {}),
        ("variable-length reads", var, lens, {}),
        ("repetitive reads", rep, None, {}),
        ("random text", text, None, {}),
        ("repetitive text", atat, None, {}),
        ("reads, merge_tile=2", reads, None, dict(merge_tile=2)),
        ("reads, merge_backend=device", reads, None, dict(merge_backend="device")),
        ("repetitive reads, merge_backend=device", rep, None,
         dict(merge_backend="device")),
    ]
    merged_runs = []
    real = superblock._merge_path_runs

    def spy(store, runs, *args, **kw):  # the merge's run count
        merged_runs.append(sum(1 for r in runs if r.shape[0]))
        return real(store, runs, *args, **kw)

    superblock._merge_path_runs = spy
    try:
        for name, corpus, lengths, over in cases:
            sb = SuperblockConfig(num_superblocks=3, emit_lcp=True, **over)
            merged_runs.clear()
            reset_launch_counts()
            res = superblock.build_suffix_array_superblock(
                corpus, lengths=lengths, cfg=cfg, sb=sb, device=dev)
            counts = launch_counts()
            want = (naive_sa_text(corpus) if corpus.ndim == 1
                    else naive_sa_reads(corpus, lengths))
            stride = 0 if corpus.ndim == 1 else int(np.ceil(np.log2(corpus.shape[1] + 1)))
            if not np.array_equal(res.suffix_array, want):
                raise AssertionError(f"phase 4: out-of-core {name}: SA != oracle")
            if not np.array_equal(res.lcp, oracle_lcp(corpus, want, stride)):
                raise AssertionError(f"phase 4: out-of-core {name}: LCP != brute force")
            if res.stats["dropped"] or res.stats["unresolved"]:
                raise AssertionError(f"phase 4: out-of-core {name}: {res.stats}")
            runs = max(merged_runs, default=0)
            if (runs >= 2) != (counts["merge_path"] > 0):
                raise AssertionError(f"phase 4: out-of-core {name}: merge of {runs} "
                                     f"runs, launches {counts}")
            log(f"phase 4: out-of-core {name} == oracle (SA, LCP) on {dev}, "
                f"{res.stats['superblocks']} superblocks, merge of {runs} runs; "
                f"launches {counts}")
    finally:
        superblock._merge_path_runs = real


def brute_text(text, pat):
    """Sorted start positions of ``pat`` in ``text`` (numpy, brute force)."""
    import numpy as np

    p = len(pat)
    if p == 0:
        return np.arange(len(text))
    if p > len(text):
        return np.zeros(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(text, p)
    return np.flatnonzero((win == pat).all(axis=1))


def brute_reads(reads, pat):
    """Sorted (read, offset) hits of ``pat`` inside the reads (0 = padding)."""
    import numpy as np

    padded = np.pad(reads, ((0, 0), (0, len(pat) + 1)))
    win = np.lib.stride_tricks.sliding_window_view(padded, len(pat), axis=1)
    hit = (win[:, : reads.shape[1] + 1] == pat).all(axis=2)
    return [(int(i), int(o)) for i, o in zip(*np.nonzero(hit), strict=True)]


def phase_small_indexes(dev):
    """Small ``SuffixArrayIndex`` builds on the card with the kernels: the
    quickstart's paired-end reads, random text and ATAT text, with count,
    locate and align held to brute force."""
    import numpy as np

    from repro_torch import SAConfig, SuffixArrayIndex
    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(3)
    reads = synth_dna_reads(64, 48, seed=1, paired_end=True)
    text = rng.integers(1, 5, size=(300,)).astype(np.int32)
    atat = np.tile(np.array([1, 2, 1, 2], np.int32), 40)
    for name, corpus in (("quickstart reads", reads), ("random text", text),
                         ("ATAT text", atat)):
        cfg = SAConfig(vocab_size=4, use_pallas=True)
        pats = [np.zeros(0, np.int64), np.array([9], np.int64),
                np.array([0, 1], np.int64)]
        flat = corpus.reshape(-1)
        for start, m in zip(rng.integers(0, flat.size - 30, 40),
                            rng.integers(1, 30, 40), strict=True):
            pats.append(flat[start : start + m].astype(np.int64))
        reset_launch_counts()
        idx = SuffixArrayIndex.build(corpus, cfg=cfg, device=dev)
        counts, occ = idx.count(pats), idx.locate(pats)
        launched = launch_counts()
        if launched["pattern_search"] <= 0:
            raise AssertionError(f"phase 4: {name}: pattern_search not launched: "
                                 f"{launched}")
        for p, c, o in zip(pats, counts, occ, strict=True):
            live = p.size == 0 or (p.min() >= 1 and p.max() <= 4)
            if corpus.ndim == 1:
                want = brute_text(corpus, p) if live else np.zeros(0, np.int64)
                if not np.array_equal(o, want) or c != want.size:
                    raise AssertionError(f"phase 4: {name}: locate {p} != brute force")
            elif p.size and live:
                want = brute_reads(corpus, p)
                if idx.align(p) != want or c != len(want):
                    raise AssertionError(f"phase 4: {name}: align {p} != brute force")
            elif c != (corpus.size + corpus.shape[0] if live else 0):
                raise AssertionError(f"phase 4: {name}: count {p} is {c}")
        log(f"phase 4: {name} index == brute force on {dev} "
            f"({len(pats)} patterns); launches {launched}")


def check_permutation(sa, expected):
    import torch

    if not torch.equal(torch.sort(sa).values, expected):
        raise AssertionError("SA is not a permutation of the valid suffixes")


def check_sampled_order(flat, pos, sa, seed):
    """2^20 sampled adjacent SA pairs in suffix order: zero-padded tokens,
    shorter first, then by global index.  ``flat`` holds the tokens with a 0
    after every suffix's last token; ``pos`` is each SA entry's position."""
    import torch

    dev = flat.device
    n = flat.shape[0]
    gen = torch.Generator().manual_seed(seed)
    i = torch.randint(1, sa.shape[0], (PAIR_SAMPLES,), generator=gen).to(dev)
    a, b = pos[i - 1], pos[i]
    ga, gb = sa[i - 1], sa[i]
    less = torch.zeros(PAIR_SAMPLES, dtype=torch.bool, device=dev)
    open_ = torch.ones(PAIR_SAMPLES, dtype=torch.bool, device=dev)
    cols = torch.arange(64, device=dev)
    c0 = 0
    while bool(open_.any()):
        ia, ib = a[:, None] + c0 + cols, b[:, None] + c0 + cols
        ta = torch.where(ia < n, flat[ia.clamp(max=n - 1)], 0)
        tb = torch.where(ib < n, flat[ib.clamp(max=n - 1)], 0)
        stop = (ta != tb) | (ta == 0)
        hit = stop.any(dim=1)
        first = stop.int().argmax(dim=1, keepdim=True)
        va, vb = ta.take_along_dim(first, 1)[:, 0], tb.take_along_dim(first, 1)[:, 0]
        verdict = (va < vb) | ((va == vb) & (ga < gb))
        less = torch.where(open_ & hit, verdict, less)
        open_ &= ~hit
        c0 += 64
    if not bool(less.all()):
        raise AssertionError(f"{int((~less).sum())} sampled pairs out of order")


def phase_full_builds(dev, reads_corpus, text_tokens):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.pipeline import plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sa_build

    builds = [(READS_BUILD, reads_corpus), (TEXT_BUILD, text_tokens)]
    results = {}
    counts = {}  # build -> launches of each kernel in its kernel-path run
    for use_pallas in (True, False):
        for name, corpus in builds:
            cfg = sa_build.make_config("base", "cuda", use_pallas=use_pallas)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            res, dt = sa_build.run(corpus, cfg, dev.type)
            launched = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            n = res.stats["num_suffixes"]
            path = "kernels" if use_pallas else "plain"
            log(f"phase 5: {name} [{path}]: {dt:.3f} s wall, {n / dt:.0f} "
                f"suffixes/s, iters {res.stats['iters']}, rounds "
                f"{res.footprint.rounds}, peak {peak / 2**30:.2f} GiB")
            sa_build.report(res, dt)
            results[(name, use_pallas)] = res
            if use_pallas:
                counts[name] = launched
                log(f"phase 5: {name} [kernels]: launches {launched}")
            elif any(launched.values()):
                raise AssertionError(f"{name}: plain path launched {launched}")
    for kernel, name in KERNEL_BUILD.items():
        if name in counts and counts[name][kernel] <= 0:
            raise AssertionError(
                f"{kernel} was not launched in the {name} build: {counts[name]}")
    for name, corpus in builds:
        a, b = results[(name, True)], results[(name, False)]
        if not (np.array_equal(a.suffix_array, b.suffix_array)
                and dataclasses.asdict(a.footprint) == dataclasses.asdict(b.footprint)
                and a.stats == b.stats):
            raise AssertionError(f"{name}: kernel and plain paths differ")
        if a.stats["dropped"] or a.stats["unresolved"]:
            raise AssertionError(f"{name}: {a.stats}")
        sa = torch.from_numpy(a.suffix_array).to(dev)
        if corpus.ndim == 1:
            nn = corpus.shape[0]
            check_permutation(sa, torch.arange(nn, device=dev))
            flat = torch.from_numpy(corpus).to(dev)
            pos = sa
        else:
            r, l = corpus.shape
            sb = plan(corpus.shape, sa_build.make_config("base", "cuda"), 1)["stride_bits"]
            expected = ((torch.arange(r, device=dev)[:, None] << sb)
                        | torch.arange(l + 1, device=dev)[None, :]).reshape(-1)
            check_permutation(sa, expected)
            flat = torch.nn.functional.pad(torch.from_numpy(corpus).to(dev),
                                           (0, 1)).reshape(-1)
            pos = (sa >> sb) * (l + 1) + (sa & ((1 << sb) - 1))
        check_sampled_order(flat, pos, sa, seed=7)
        log(f"phase 5: {name}: kernel == plain (SA, Footprint, stats), 0 dropped, "
            f"0 unresolved, permutation ok, {PAIR_SAMPLES} sampled pairs ordered")
        del sa, flat, pos
    return (counts, {name: results[(name, True)].suffix_array for name, _ in builds},
            {name: results[(name, True)].footprint for name, _ in builds})


KERNEL_CLASSES = (  # substring of a kernel's name -> what it belongs to
    ("prefix_pack", "prefix_pack"), ("window_gather", "window_gather"),
    ("pattern_search", "pattern_search"), ("pattern_cmp", "pattern_cmp"),
    ("merge_path", "merge_path"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("xmma", "matmul"), ("softmax", "softmax"),
    ("gather", "gather"),
    ("RadixSort", "sort"), ("radix", "sort"), ("sort", "sort"),
    ("scan", "scan"), ("scatter", "scatter"), ("index", "index"),
    ("reduce", "reduce"), ("Memcpy", "memcpy"), ("Memset", "memset"),
)


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``: (wall s, device ms by kernel
    name, launches by kernel name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (dt, {e.key: e.self_device_time_total / 1e3 for e in kernels},
            {e.key: e.count for e in kernels})


def device_ms(fn, kernel, reps=200):
    """The profiler's device time a launch of the kernel whose name holds
    ``kernel``, over ``reps`` calls of ``fn`` (at small sizes a call's CUDA
    events time its host launch path, not the device)."""
    _, ms, launches = profiled(lambda: [fn() for _ in range(reps)])
    key = next(key for key in ms if kernel in key)
    return ms[key] / launches[key]


def by_kind(ms):
    out = {}
    for key, t in ms.items():
        cls = next((c for sub, c in KERNEL_CLASSES if sub in key), "elementwise")
        out[cls] = out.get(cls, 0.0) + t
    return ", ".join(f"{c} {t:.1f} ms" for c, t in sorted(out.items(), key=lambda x: -x[1]))


def phase_profile(builds, mode="scheme", phase=6):
    """Where one kernel-path build of each cell, in ``mode``, spends its
    device time."""
    import torch

    from repro_torch.launch import sa_build

    for name, corpus in builds:
        cfg = sa_build.make_config("base", "cuda")
        torch.cuda.empty_cache()
        dt, ms, _ = profiled(lambda c=corpus, g=cfg: sa_build.run(c, g, "cuda", mode=mode))
        busy = sum(ms.values())
        log(f"phase {phase}: {name} profiled: wall {dt * 1e3:.1f} ms, device busy "
            f"{busy:.1f} ms ({100 * busy / (dt * 1e3):.1f} % of wall)")
        log("  by kind: " + by_kind(ms))
        for key, t in sorted(ms.items(), key=lambda x: -x[1])[:6]:
            log(f"  {t:9.2f} ms  {key[:100]}")


def token_layout(corpus, sa, stride_bits):
    """(flat, pos): the tokens with a 0 after every suffix's last token, and
    each SA entry's position in them (as ``check_sampled_order`` takes)."""
    import torch

    dev = sa.device
    if corpus.ndim == 1:
        return torch.from_numpy(corpus).to(dev), sa
    l = corpus.shape[1]
    flat = torch.nn.functional.pad(torch.from_numpy(corpus).to(dev), (0, 1)).reshape(-1)
    return flat, (sa >> stride_bits) * (l + 1) + (sa & ((1 << stride_bits) - 1))


def tokens_at(flat, pos, width):
    """(m, width) tokens from each position, 0 past the end."""
    import torch

    n = flat.shape[0]
    idx = pos[:, None] + torch.arange(width, device=flat.device)[None, :]
    return torch.where(idx < n, flat[idx.clamp(max=n - 1)], 0)


def check_ranges(flat, pos, rows, plen, rg):
    """Every suffix in ``sa[lo:hi]`` starts with its pattern, and ``sa[lo-1]``
    and ``sa[hi]`` (where they exist) do not."""
    import torch

    dev = flat.device
    n = pos.shape[0]
    lo, hi = rg[:, 0], rg[:, 1]
    cnt = hi - lo
    pid = torch.repeat_interleave(torch.arange(rows.shape[0], device=dev), cnt)
    first = torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt, cnt)
    inside = torch.arange(pid.shape[0], device=dev) + first
    width = rows.shape[1]
    cols = torch.arange(width, device=dev)[None, :]

    def starts_with(sa_row, p):
        got = tokens_at(flat, pos[sa_row], width)
        return ((got == rows[p]) | (cols >= plen[p][:, None])).all(dim=1)

    if not bool(starts_with(inside, pid).all()):
        raise AssertionError("a suffix inside its range does not start with the pattern")
    q = torch.arange(rows.shape[0], device=dev)
    for edge, ok in ((lo - 1, lo >= 1), (hi, hi < n)):
        if bool(starts_with(edge[ok], q[ok]).any()):
            raise AssertionError("a suffix just outside its range starts with the pattern")


def check_sampled_lcp(flat, pos, lcp, seed):
    """2^20 sampled ``lcp[i]`` == the first column where the suffixes at
    ``sa[i-1]`` and ``sa[i]`` differ or both have ended."""
    import torch

    dev = flat.device
    gen = torch.Generator().manual_seed(seed)
    i = torch.randint(1, pos.shape[0], (PAIR_SAMPLES,), generator=gen).to(dev)
    a, b = pos[i - 1], pos[i]
    want = torch.full((PAIR_SAMPLES,), -1, dtype=torch.int64, device=dev)
    c0 = 0
    while bool((want < 0).any()):
        ta, tb = tokens_at(flat, a + c0, 64), tokens_at(flat, b + c0, 64)
        stop = (ta != tb) | (ta == 0)
        hit = stop.any(dim=1) & (want < 0)
        want = torch.where(hit, c0 + stop.int().argmax(dim=1), want)
        c0 += 64
    got = lcp[i]
    if not torch.equal(got, want):
        raise AssertionError(f"{int((got != want).sum())} sampled LCP values differ")


def sample_seeds(idx, rng, count, m):
    """Alignment seeds as ``repro.launch.serve`` samples them: the depth-0
    window of random SA rows cut to ``m`` tokens, zeros stripped.  Read
    from the backend, so the store's counters stay the engine's."""
    import numpy as np
    import torch

    dev = idx.store.device
    g = torch.from_numpy(np.asarray(idx.sa, np.int64)[rng.integers(0, len(idx.sa), count)])
    win = idx.store.backend.gather(g.to(dev), torch.zeros_like(g).to(dev))
    win = win[:, : min(m, idx.store.k)].cpu().numpy()
    out = []
    for row in win:
        row = row[row > 0]
        out.append(row.astype(np.int64) if row.size else np.array([1], np.int64))
    return out


def phase_queries(dev, reads_corpus, text_tokens):
    """The query path at full size: build with LCP, count batches, align."""
    import numpy as np
    import torch

    from repro_torch import ShardedSAEngine
    from repro_torch.core.store import CorpusStore
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.sa_build import make_config
    from repro_torch.serve.sa_engine import SuffixArrayIndex

    counts, report, lcps, kept = {}, {}, {}, None
    for name, corpus in ((READS_QUERY, reads_corpus), (TEXT_QUERY, text_tokens)):
        n_seeds, m = QUERIES[name]
        rng = np.random.default_rng(11)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        idx = SuffixArrayIndex.build(corpus, cfg=make_config("base", "cuda", use_pallas=True),
                                     device=dev)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = idx.engine
        torch.cuda.synchronize()
        t_engine = time.perf_counter() - t0
        hot = sample_seeds(idx, rng, max(1, n_seeds // 50), m)
        batches = []
        for _ in range(n_seeds // QUERY_BATCH):
            batch = sample_seeds(idx, rng, QUERY_BATCH, m)
            for i in np.flatnonzero(rng.random(QUERY_BATCH) < HOT_FRACTION):
                batch[i] = hot[int(rng.integers(0, len(hot)))]
            batches.append(batch)
        # the align batch: seeds of the full length (a seed cut short by its
        # suffix's end can match tens of millions of positions)
        seeds = [p for p in sample_seeds(idx, rng, 2 * QUERY_BATCH, m) if p.size == m]
        seeds = seeds[:QUERY_BATCH]
        lat, kernel_counts = [], []
        t0 = time.perf_counter()
        for batch in batches:
            tb = time.perf_counter()
            kernel_counts.append(idx.count(batch))
            lat.append(time.perf_counter() - tb)
        t_query = time.perf_counter() - t0
        hits = idx.align(seeds) if corpus.ndim == 2 else idx.locate(seeds)
        launched = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        kstats = eng.engine_stats()
        counts[name] = launched
        if launched["pattern_search"] <= 0:
            raise AssertionError(f"{name}: pattern_search not launched: {launched}")
        if eng.num_shards == 1 and launched["pattern_cmp"]:
            raise AssertionError(f"{name}: pattern_cmp launched on the memory store "
                                 f"with one shard: {launched}")

        # the plain compare over the same backend and arrays, in a store of
        # its own so its traffic counters start from 0 as the kernel's did
        plain_store = CorpusStore(None, idx.cfg, backend=idx.store.backend,
                                  request_capacity=idx.store.request_capacity)
        reset_launch_counts()
        plain = ShardedSAEngine(plain_store, idx.sa, lcp=idx.lcp, use_pallas=False)
        t0 = time.perf_counter()
        for batch, want in zip(batches, kernel_counts, strict=True):
            if not np.array_equal(plain.count(batch), want):
                raise AssertionError(f"{name}: kernel and plain engines differ")
        t_plain = time.perf_counter() - t0
        plain_hits = plain.align(seeds) if corpus.ndim == 2 else plain.locate(seeds)
        if any(launch_counts().values()):
            raise AssertionError(f"{name}: plain engine launched {launch_counts()}")
        pstats = plain.engine_stats()
        if pstats != kstats:
            raise AssertionError(f"{name}: engine_stats differ: {kstats} != {pstats}")
        if not all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(hits, plain_hits, strict=True)):
            raise AssertionError(f"{name}: kernel and plain align/locate differ")
        all_counts = np.concatenate(kernel_counts)
        if all_counts.min() < 1:
            raise AssertionError(f"{name}: a sampled seed has count 0")

        sa = eng.sa
        flat, pos = token_layout(corpus, sa, idx.store.stride_bits)
        rows = torch.from_numpy(np.stack(seeds)).to(dev)
        check_ranges(flat, pos, rows, torch.full((len(seeds),), m, device=dev),
                     torch.from_numpy(eng.ranges(seeds)).to(dev))
        check_sampled_lcp(flat, pos, eng.lcp, seed=13)
        del flat, pos, plain, plain_store
        search = search_timing(name, eng, batches[0])
        # where one more (uncached) batch spends its time
        extra = sample_seeds(idx, rng, QUERY_BATCH, m)
        dt, ms, _ = profiled(lambda e=extra: idx.count(e))
        busy = sum(ms.values())
        lat_ms = np.sort(np.array(lat)) * 1e3
        n_q = len(batches) * QUERY_BATCH
        report[name] = dict(
            build_s=t_build, engine_s=t_engine, qps=n_q / t_query,
            plain_qps=n_q / t_plain,
            p50_ms=float(np.percentile(lat_ms, 50)),
            p95_ms=float(np.percentile(lat_ms, 95)), peak_gib=peak / 2**30,
            search=search)
        log(f"phase 7: {name}: {len(idx.sa)} suffixes; build with LCP "
            f"{t_build:.3f} s, engine set-up (LLCP/RLCP) {t_engine:.3f} s; "
            f"{n_q} seeds of {m} in {len(batches)} count batches of "
            f"{QUERY_BATCH}: {n_q / t_query:.0f} queries/s, batch p50 "
            f"{report[name]['p50_ms']:.1f} ms p95 {report[name]['p95_ms']:.1f} ms; "
            f"search_rounds {kstats['search_rounds']}, compare_rounds "
            f"{kstats['compare_rounds']}, cache hits {kstats['cache_hits']} / "
            f"misses {kstats['cache_misses']}, store requests "
            f"{kstats['store_requests']}; peak {peak / 2**30:.2f} GiB; plain "
            f"engine {n_q / t_plain:.0f} queries/s")
        log(f"phase 7: {name}: count batch walls in order (ms): "
            + ", ".join(f"{1e3 * t:.1f}" for t in lat))
        log(f"phase 7: {name}: one more batch profiled: wall {dt * 1e3:.1f} ms, "
            f"device busy {busy:.1f} ms ({100 * busy / (dt * 1e3):.1f} % of wall); "
            f"by kind: {by_kind(ms)}")
        log(f"phase 7: {name}: {'align' if corpus.ndim == 2 else 'locate'} of "
            f"{len(seeds)} seeds of {m}: {sum(len(h) for h in hits)} hits; "
            f"launches {launched}; kernel == plain engine (ranges, hits, "
            f"engine_stats), the hit batch's ranges checked at their edges, "
            f"{PAIR_SAMPLES} sampled LCP values exact, every seed found")
        lcps[name] = idx.lcp
        if name == READS_QUERY:  # phase 9 saves it and replays the batches
            kept = dict(idx=idx, batches=batches)
        else:
            idx.close()
        del idx, eng, sa
    return counts, report, lcps, kept


def search_timing(name, eng, batch):
    """One ``pattern_search`` call a bound for a seed batch on a full index:
    held to its plain version on the card (bounds, levels, rounds), timed by
    CUDA events and by the profiler's device time, beside its byte bound and
    its longest chain of dependent loads."""
    import torch

    from repro_torch.kernels import cases, ref
    from repro_torch.kernels import pattern_cmp as pc_mod

    calls = [cases.search_args(eng, batch, upper) for upper in (False, True)]
    outs, err = [], 0
    for args in calls:
        got, want = pc_mod.pattern_search(*args), ref.pattern_search_ref(*args)
        for what, g, w in zip(("bound", "levels", "rounds"), got, want, strict=True):
            check_equal(f"{name}: pattern_search upper={args[10]} {what}", g, w)
            err = max(err, max_abs_err(g, w))
        outs.append(got)

    def both():
        for args in calls:
            pc_mod.pattern_search(*args)

    def both_plain():
        for args in calls:
            ref.pattern_search_ref(*args)

    ms = time_ms(both, 50)
    plain_ms = time_ms(both_plain, 2)
    dev_ms = 2 * device_ms(both, "pattern_search", reps=50)
    # bytes, counted from this batch's record: a 32-byte sector for each
    # compare's sa entry and each window level's tokens, one for the
    # LLCP/RLCP entry of every round that made no compare (at least those
    # read one), the pattern rows and in/outputs; operations: a token
    # compared a level at least.  The chain: a load a round and one more a
    # compare, one launch after the other.
    nbytes = ops = chain = 0
    for args, (_, levels, active) in zip(calls, outs, strict=True):
        q, r = levels.shape
        compares, tokens = int((levels > 0).sum()), int(levels.sum())
        decided = int(active.sum()) - compares if eng._llcp is not None else 0
        nbytes += (32 * (decided + compares + tokens) + 8 * args[6].numel()
                   + 8 * 4 * q + 4 * q * r + 4 * q)
        ops += tokens
        chain += int((active + (levels > 0).sum(dim=1)).max())
    bound_ms, bound_by = byte_or_op_bound(nbytes, ops)
    q, lmax = calls[0][6].shape
    log(f"phase 7: {name}: pattern_search, both bounds of {q} seeds (lmax {lmax}): "
        f"kernel {ms:.4f} ms a call (CUDA events, two launches), device "
        f"{dev_ms:.4f} ms (profiler), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}, {nbytes} B); latency floor: the longest "
        f"rows' chains {chain} dependent loads, {1e6 * dev_ms / chain:.1f} ns a "
        f"load at the device time; == plain (bounds, levels, rounds)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, device_ms=dev_ms, chain=chain,
                shape=f"q={q}, both bounds")


def stats_without_walls(stats):
    return {k: v for k, v in stats.items() if not k.startswith("t_")}


def capture_tiles(fn):
    """Run ``fn`` with the merge's ``merge_path_ranks`` calls watched: returns
    the largest tile (most rows, then most words) and the widest tile (most
    words, then most rows) it ranked, as copies."""
    from repro_torch.kernels import ops

    real = ops.merge_path_ranks
    seen = {}

    def spy(keys, block=256):
        c, w = keys.shape
        for kind, rank in (("largest", (c, w)), ("widest", (w, c))):
            if rank > seen.get(kind, ((0, 0), None))[0]:
                seen[kind] = (rank, keys.clone())
        return real(keys, block=block)

    ops.merge_path_ranks = spy
    try:
        fn()
    finally:
        ops.merge_path_ranks = real
    return {kind: keys for kind, (_, keys) in seen.items()}


def incore_reference(dev, corpus, phase="phase 8"):
    """In-core SA and LCP of a reads corpus or a text on the kernel path (one
    superblock, the post-hoc LCP), checked as phases 5 and 7 check theirs:
    a permutation of the valid suffixes, 2^20 sampled pairs in order, 2^20
    sampled LCP values exact."""
    import math

    import torch

    from repro_torch.config import SuperblockConfig
    from repro_torch.core.superblock import build_suffix_array_superblock
    from repro_torch.launch import sa_build

    t0 = time.perf_counter()
    res = build_suffix_array_superblock(
        corpus, cfg=sa_build.make_config("base", "cuda"),
        sb=SuperblockConfig(emit_lcp=True), device=dev)
    sa = torch.from_numpy(res.suffix_array).to(dev)
    if corpus.ndim == 1:
        sb, what = 0, f"2^{corpus.shape[0].bit_length() - 1}-token text"
        expected = torch.arange(corpus.shape[0], device=dev)
    else:
        r, l = corpus.shape
        sb, what = math.ceil(math.log2(l + 1)), f"{r}-read corpus"
        expected = ((torch.arange(r, device=dev)[:, None] << sb)
                    | torch.arange(l + 1, device=dev)[None, :]).reshape(-1)
    check_permutation(sa, expected)
    flat, pos = token_layout(corpus, sa, sb)
    check_sampled_order(flat, pos, sa, seed=7)
    check_sampled_lcp(flat, pos, torch.from_numpy(res.lcp).to(dev), seed=13)
    log(f"{phase}: in-core reference of the {what}: "
        f"{time.perf_counter() - t0:.3f} s; permutation ok, {PAIR_SAMPLES} sampled "
        f"pairs ordered, {PAIR_SAMPLES} sampled LCP values exact")
    return res.suffix_array, res.lcp


def phase_out_of_core(dev, reads_corpus, text_tokens, incore_sa, incore_lcp):
    """The out-of-core build (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import SuperblockConfig
    from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels import merge_path as mp_mod
    from repro_torch.launch import sa_build

    want_sa, want_lcp = {}, {}
    if 1 << OOC_TEXT_LOG2 == text_tokens.shape[0]:
        ooc_text = text_tokens
        want_sa[TEXT_OOC], want_lcp[TEXT_OOC] = incore_sa[TEXT_BUILD], incore_lcp[TEXT_QUERY]
    else:
        ooc_text = synth_token_corpus(1 << OOC_TEXT_LOG2, 4, seed=0)[0]
        want_sa[TEXT_OOC], want_lcp[TEXT_OOC] = incore_reference(dev, ooc_text)
    if OOC_READS == reads_corpus.shape[0]:
        ooc_reads = reads_corpus
        want_sa[READS_OOC] = incore_sa[READS_BUILD]
        want_lcp[READS_OOC] = incore_lcp[READS_QUERY]
    else:
        ooc_reads = synth_dna_reads(OOC_READS, FULL_READ_LEN, seed=0)
        want_sa[READS_OOC], want_lcp[READS_OOC] = incore_reference(dev, ooc_reads)
    cells = [(READS_OOC, ooc_reads), (TEXT_OOC, ooc_text)]
    paths = [("kernels", True, "host"), ("plain", False, "host"),
             ("kernels, device merge", True, "device")]
    counts, report = {}, {}
    for name, corpus in cells:
        kept = {}
        for label, use_pallas, backend in paths:
            cfg = sa_build.make_config("base", "cuda", use_pallas=use_pallas)
            sb = SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True,
                                  merge_backend=backend)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            res, dt = sa_build.run(corpus, cfg, dev.type, sb=sb)
            launched = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            st = res.stats
            n = st["num_suffixes"]
            log(f"phase 8: {name} [{label}]: {dt:.3f} s wall, {n / dt:.0f} suffixes/s, "
                f"peak {peak / 2**30:.2f} GiB; superblocks {st['superblocks']}, "
                f"capacity_records {st['capacity_records']}, peak_records "
                f"{st['peak_records']}, merge_fetch_rounds {st['merge_fetch_rounds']}, "
                f"_requests {st['merge_fetch_requests']}, _bytes "
                f"{st['merge_fetch_bytes']}, merge_pieces {st['merge_pieces']}, "
                f"block_rounds {st['block_rounds']}, t_stage_s {st['t_stage_s']}, "
                f"t_build_s {st['t_build_s']}, t_merge_s {st['t_merge_s']}; "
                f"launches {launched}")
            if not np.array_equal(res.suffix_array, want_sa[name]):
                raise AssertionError(f"{name} [{label}]: SA != the in-core SA")
            if not np.array_equal(res.lcp, want_lcp[name]):
                raise AssertionError(f"{name} [{label}]: LCP != the in-core LCP")
            if st["dropped"] or st["unresolved"]:
                raise AssertionError(f"{name} [{label}]: {st}")
            if not st["peak_records"] <= st["capacity_records"]:
                raise AssertionError(f"{name} [{label}]: peak_records over capacity")
            if use_pallas and launched["merge_path"] <= 0:
                raise AssertionError(f"{name} [{label}]: merge_path not launched")
            if not use_pallas and any(launched.values()):
                raise AssertionError(f"{name} [{label}]: plain path launched {launched}")
            kept[label] = (dataclasses.asdict(res.footprint), stats_without_walls(st))
            report[(name, label)] = dict(wall_s=dt, suffixes_per_s=n / dt,
                                         peak_gib=peak / 2**30, stats=st,
                                         footprint=kept[label][0])
            if label == "kernels":
                counts[name] = launched
            del res
        if kept["kernels"] != kept["plain"]:
            raise AssertionError(f"{name}: kernel and plain paths differ "
                                 "(Footprint or stats)")
        log(f"phase 8: {name}: kernels == plain (SA, LCP, Footprint, stats); every "
            f"path's SA and LCP == the in-core ones of the same corpus; 0 dropped, "
            f"0 unresolved, peak_records <= capacity_records")

    # one profiled kernel-path reads build, its largest and widest tiles kept
    cfg = sa_build.make_config("base", "cuda")
    sb = SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True)
    small = synth_dna_reads(OOC_PROFILE_READS, FULL_READ_LEN, seed=0)
    torch.cuda.empty_cache()
    prof = []
    tiles = capture_tiles(lambda: prof.extend(
        profiled(lambda: sa_build.run(small, cfg, dev.type, sb=sb))))
    wall, ms, _ = prof
    busy = sum(ms.values())
    log(f"phase 8: reads {OOC_PROFILE_READS} x 200 out-of-core profiled: wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f} % of wall)")
    log("  by kind: " + by_kind(ms))
    for key, t in sorted(ms.items(), key=lambda x: -x[1])[:8]:
        log(f"  {t:9.2f} ms  {key[:100]}")
    tile_report = {}
    for kind, keys in tiles.items():
        got = mp_mod.merge_path_ranks(keys)
        want = ref.merge_path_ranks_ref(keys)
        check_equal(f"merge_path_ranks {kind} tile {tuple(keys.shape)}", got, want)
        if not torch.equal(torch.sort(got.long()).values,
                           torch.arange(keys.shape[0], device=keys.device)):
            raise AssertionError(f"{kind} tile's ranks are not a permutation")
        m = merge_path_timing(keys)
        m.update(max_abs_err=max_abs_err(got, want), shape=tuple(keys.shape))
        tile_report[kind] = m
        log(f"phase 8: merge_path_ranks on the {kind} tile of the reads merge "
            f"(C, W) = {tuple(keys.shape)}, R = {m['runs']}: kernel == plain, "
            f"ranks a permutation; kernel {m['ms']:.4f} ms (device "
            f"{m['device_ms']:.4f} ms a call), plain "
            f"{m['plain_ms']:.4f} ms, library {m['library_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']})")
    ooc_ref = {name: (corpus, want_sa[name], want_lcp[name]) for name, corpus in cells}
    return counts, report, tile_report, ooc_ref


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_reopen(dev, reads_index):
    """Phase 9, first half (run right after phase 7, so phase 8's peaks do
    not hold the index): save phase 7's reads index, reopen it on both
    stores and replay phase 7's batches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.sa_engine import SuffixArrayIndex

    counts = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_index_")
    try:
        idx, batches = reads_index["idx"], reads_index["batches"]
        want = [idx.engine.ranges(b) for b in batches]
        ix = os.path.join(tmp, "reads_index")
        t0 = time.perf_counter()
        idx.save(ix)
        t_save = time.perf_counter() - t0
        saved = dir_bytes(ix)
        log(f"phase 9: saved the {len(idx.sa)}-suffix reads index with LCP: "
            f"{saved} bytes in {t_save:.3f} s ({saved / t_save / 1e9:.2f} GB/s); "
            + ", ".join(f"{f} {os.path.getsize(os.path.join(ix, f))}"
                        for f in sorted(os.listdir(ix))))
        idx.close()
        del idx, reads_index["idx"]
        torch.cuda.empty_cache()
        for backend, budget in (("chunked", OPEN_CACHE_BYTES), ("memory", 0)):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opened = SuffixArrayIndex.open(ix, store_backend=backend, verify="eager",
                                           cache_budget_bytes=budget, device=dev)
            t_open = time.perf_counter() - t0
            t0 = time.perf_counter()
            eng = opened.engine  # SA, LCP and LLCP/RLCP onto the card
            torch.cuda.synchronize()
            t_engine = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = [eng.ranges(b) for b in batches]
            t_query = time.perf_counter() - t0
            launched = launch_counts()
            if not all(np.array_equal(g, w) for g, w in zip(got, want, strict=True)):
                raise AssertionError(f"phase 9: reopened ({backend}) ranges != "
                                     "the in-memory index's")
            kernel = "pattern_cmp" if backend == "chunked" else "pattern_search"
            if launched[kernel] <= 0:
                raise AssertionError(f"phase 9: reopened ({backend}): {kernel} "
                                     f"not launched: {launched}")
            counts[f"reads reopened {backend}"] = launched
            st = eng.engine_stats()
            n_q = len(batches) * QUERY_BATCH
            log(f"phase 9: reopened [{backend} store, verify=eager"
                + (f", cache {budget} B" if budget else "") + f"]: open "
                f"{t_open:.3f} s (whole-file crc32 of every artifact included), "
                f"engine set-up {t_engine:.3f} s, {n_q} seeds in {len(batches)} "
                f"batches {t_query:.3f} s ({n_q / t_query:.0f} queries/s); ranges "
                f"== the in-memory index's; store requests {st['store_requests']}"
                + (f", cache hits {opened.store.backend.cache_hits} / misses "
                   f"{opened.store.backend.cache_misses}" if budget else "")
                + f"; launches {launched}")
            opened.close()
            del opened, eng
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def streaming_name(reads: int) -> str:
    return f"reads {reads} x 200 streaming"


def phase_streaming(dev, ooc_ref, reads=STREAM_READS):
    """Phase 9, second half: a streaming build of ``reads`` reads into an
    index directory; ``ooc_ref`` is a (corpus, SA, LCP) to reuse when it
    has that many reads, else None."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.config import SuperblockConfig
    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sa_build
    from repro_torch.serve.sa_engine import SuffixArrayIndex

    counts = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_index_")
    try:
        if ooc_ref is not None and ooc_ref[0].shape[0] == reads:
            corpus, want_sa, want_lcp = ooc_ref
        else:
            corpus = synth_dna_reads(reads, FULL_READ_LEN, seed=0)
            want_sa, want_lcp = incore_reference(dev, corpus, "phase 9")
        budget = corpus.size * 4 // 4
        sb = SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True,
                              store_backend="chunked", cache_budget_bytes=budget)
        sx = os.path.join(tmp, "streaming_index")
        reset_launch_counts()
        t0 = time.perf_counter()
        built = SuffixArrayIndex.build(corpus, cfg=sa_build.make_config("base", "cuda"),
                                       sb=sb, index_dir=sx, device=dev)
        t_build = time.perf_counter() - t0
        launched = launch_counts()
        st = built.build_stats
        if not np.array_equal(np.asarray(built.sa), want_sa):
            raise AssertionError("phase 9: streaming SA != the in-memory build's")
        if not np.array_equal(np.asarray(built.lcp), want_lcp):
            raise AssertionError("phase 9: streaming LCP != the in-memory build's")
        if st["dropped"] or st["unresolved"] or st["store_backend"] != "chunked":
            raise AssertionError(f"phase 9: streaming build: {st}")
        if st["peak_resident_bytes"] > budget:
            raise AssertionError(f"phase 9: peak_resident_bytes "
                                 f"{st['peak_resident_bytes']} > budget {budget}")
        if launched["merge_path"] <= 0:
            raise AssertionError(f"phase 9: merge_path not launched: {launched}")
        counts[streaming_name(reads)] = launched
        log(f"phase 9: {streaming_name(reads)} into an index directory: {t_build:.3f} s "
            f"wall, {st['num_suffixes'] / t_build:.0f} suffixes/s; "
            f"peak_resident_bytes {st['peak_resident_bytes']} of budget {budget} "
            f"(corpus {st['corpus_bytes']} B), cache hits {st['store_cache_hits']} / "
            f"misses {st['store_cache_misses']}, spilled {st['spilled_runs']} runs "
            f"({st['spilled_bytes']} B), merge_pieces {st['merge_pieces']}, "
            f"merge_fetch_rounds {st['merge_fetch_rounds']}, t_stage_s "
            f"{st['t_stage_s']}, t_build_s {st['t_build_s']}, t_merge_s "
            f"{st['t_merge_s']}; {dir_bytes(sx)} bytes written; SA and LCP == the "
            f"in-memory build's; launches {launched}")
        built.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def merge_build(name, label, corpus, alg, use_pallas, merge_backend="host", **sb_kw):
    """One phase-10 out-of-core build of ``corpus`` (S = 4, LCP) through the
    launcher's code path, its launch counts set to 0 just before and read
    just after.  Returns (result, wall, launches)."""
    import torch

    from repro_torch.config import SuperblockConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sa_build

    cfg = sa_build.make_config("base", "cuda", use_pallas=use_pallas)
    sb = SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True,
                          merge_algorithm=alg, merge_backend=merge_backend, **sb_kw)
    torch.cuda.empty_cache()
    reset_launch_counts()
    res, dt = sa_build.run(corpus, cfg, "cuda", sb=sb)
    launched = launch_counts()
    st = res.stats
    log(f"phase 10: {name} {alg} [{label}]: {dt:.3f} s wall, t_merge_s {st['t_merge_s']}, "
        f"t_build_s {st['t_build_s']}, merge_fetch_rounds {st['merge_fetch_rounds']}, "
        f"merge_fetch_requests {st['merge_fetch_requests']}, merge_fetch_bytes "
        f"{st['merge_fetch_bytes']}, merge_cursor_peak_windows "
        f"{st['merge_cursor_peak_windows']}, merge_pieces {st['merge_pieces']}, "
        f"peak_resident_bytes {st['peak_resident_bytes']}; launches {launched}")
    if st["dropped"] or st["unresolved"]:
        raise AssertionError(f"phase 10: {name} {alg} [{label}]: {st}")
    if not st["peak_records"] <= st["capacity_records"]:
        raise AssertionError(f"phase 10: {name} {alg} [{label}]: peak_records over capacity")
    if not use_pallas and any(launched.values()):
        raise AssertionError(f"phase 10: {name} {alg} [{label}]: plain path launched {launched}")
    return res, dt, launched


def phase_merges(dev, reads=MERGE_READS, text_log2=MERGE_TEXT_LOG2,
                 stream_reads=STREAM_MERGE_READS):
    """Phase 10 (see the module docstring).  Returns the launches of each
    kernel-path build, by build."""
    import dataclasses

    import numpy as np

    from repro_torch.config import SuperblockConfig
    from repro_torch.core.store import FlakyBackend, InMemoryBackend
    from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
    from repro_torch.launch import sa_build

    cells = [(f"reads {reads} x 200", synth_dna_reads(reads, FULL_READ_LEN, seed=0),
              "window_gather"),
             (f"text 2^{text_log2}", synth_token_corpus(1 << text_log2, 4, seed=0)[0],
              "prefix_pack")]
    builds = [("kway", "kernels", True, "host"), ("kway", "plain", False, "host"),
              ("rerank", "kernels", True, "host"), ("rerank", "plain", False, "host"),
              ("rerank", "kernels, device merge", True, "device")]
    counts, refs = {}, {}
    for name, corpus, kernel in cells:
        ref, _, launched = merge_build(name, "kernels", corpus, "merge_path", True)
        refs[name] = ref
        counts[f"{name} merge_path"] = launched
        kept = {}
        for alg, label, use_pallas, backend in builds:
            res, _, launched = merge_build(name, label, corpus, alg, use_pallas, backend)
            if not np.array_equal(res.suffix_array, ref.suffix_array):
                raise AssertionError(f"phase 10: {name} {alg} [{label}]: SA != merge_path's")
            if not np.array_equal(res.lcp, ref.lcp):
                raise AssertionError(f"phase 10: {name} {alg} [{label}]: LCP != merge_path's")
            if use_pallas:
                if launched[kernel] <= 0:
                    raise AssertionError(
                        f"phase 10: {name} {alg} [{label}]: {kernel} not launched")
                counts[f"{name} {alg} [{label}]"] = launched
            if backend == "host":
                kept[(alg, label)] = (dataclasses.asdict(res.footprint),
                                      stats_without_walls(res.stats))
            del res
        for alg in ("kway", "rerank"):
            if kept[(alg, "kernels")] != kept[(alg, "plain")]:
                raise AssertionError(f"phase 10: {name} {alg}: kernel and plain paths "
                                     "differ (Footprint or stats)")
        log(f"phase 10: {name}: kway and rerank (host and device merge) SA and LCP == "
            f"merge_path's; kernels == plain (Footprint, stats); 0 dropped, 0 unresolved, "
            f"peak_records <= capacity_records; {kernel} launched on the kernel path")

    # the reads again, from a store that fails every third call twice
    name, corpus, _ = cells[0]
    clean = refs[name]
    flaky = FlakyBackend(InMemoryBackend(corpus, sa_build.make_config("base", "cuda"),
                                         device=dev),
                         fail_every=3, failures_per_call=2)
    res, dt, launched = merge_build(name, "kernels, flaky store", flaky, "merge_path", True,
                                    store_retries=3, store_backoff_s=0.0)
    st = res.stats
    retry = ("store_retry_attempts", "store_retried_calls")
    if not (np.array_equal(res.suffix_array, clean.suffix_array)
            and np.array_equal(res.lcp, clean.lcp)
            and dataclasses.asdict(res.footprint) == dataclasses.asdict(clean.footprint)
            and ({k: v for k, v in stats_without_walls(st).items() if k not in retry}
                 == {k: v for k, v in stats_without_walls(clean.stats).items()
                     if k not in retry})):
        raise AssertionError("phase 10: the retried build != the fault-free build")
    if not (flaky.injected > 0 and st["store_retry_attempts"] > 0
            and st["store_retried_calls"] > 0 and launched["window_gather"] > 0):
        raise AssertionError(f"phase 10: no fault injected or retried: {st}, {launched}")
    counts[f"{name} merge_path [kernels, flaky store]"] = launched
    log(f"phase 10: {name} from a flaky store with store_retries=3: {dt:.3f} s wall; "
        f"injected {flaky.injected}, retry_attempts {st['store_retry_attempts']}, "
        f"retried_calls {st['store_retried_calls']} (gather calls {flaky.gather_calls}, "
        f"reads {flaky.read_calls}); SA, LCP, Footprint and stats == the fault-free "
        f"build's (walls and retry counters aside)")
    del res, clean, refs

    # kway and rerank streaming from the chunked store under a budget
    small = synth_dna_reads(stream_reads, FULL_READ_LEN, seed=0)
    name = f"reads {stream_reads} x 200"
    mem, _, _ = merge_build(name, "kernels, memory", small, "merge_path", True)
    budget = small.size * 4 // 4
    for alg in ("kway", "rerank"):
        res, dt, launched = merge_build(
            name, "kernels, streaming", small, alg, True, store_backend="chunked",
            cache_budget_bytes=budget)
        st = res.stats
        if not np.array_equal(res.suffix_array, mem.suffix_array):
            raise AssertionError(f"phase 10: streaming {alg}: SA != the in-memory build's")
        if st["store_backend"] != "chunked" or st["peak_resident_bytes"] > budget:
            raise AssertionError(f"phase 10: streaming {alg}: peak_resident_bytes "
                                 f"{st['peak_resident_bytes']} > budget {budget}: {st}")
        counts[f"{name} {alg} [kernels, streaming]"] = launched
        log(f"phase 10: {name} {alg} streaming: {dt:.3f} s wall; peak_resident_bytes "
            f"{st['peak_resident_bytes']} of budget {budget}, cache hits "
            f"{st['store_cache_hits']} / misses {st['store_cache_misses']}; SA == the "
            f"in-memory build's")
    return counts


# phase 11: the stats a journaled build moves (its own flags and count, and the
# spills of the memory store's runs), and those the sanitizer's audit reads move
# through the build's backend (as in repro) beside its flag
JOURNAL_MOVES = ("journaled", "journal_hits", "spilled_runs", "spilled_bytes")
SANITIZER_MOVES = ("sanitized", "store_cache_hits", "store_cache_misses",
                   "store_cache_hit_rate")


class Killed(Exception):
    """Raised at a pipeline point to kill a build (phase 11)."""


def probed(fn, label=None, at=0):
    """Run ``fn`` with the superblock module's ``pipeline_point`` (the build
    calls it by that name) watched: ``Killed`` is raised at the ``at``-th
    occurrence of ``label``, and the launch counts are read at the first
    ``spill:drain``, the end of phase 2.  Returns (fn's result, or None when
    killed; the occurrences of each label; the phase-2 launches)."""
    from repro_torch.core import superblock
    from repro_torch.kernels import launch_counts

    real = superblock.pipeline_point
    seen, phase2 = {}, {}

    def probe(lbl):
        real(lbl)
        seen[lbl] = seen.get(lbl, 0) + 1
        if lbl == "spill:drain" and not phase2:
            phase2.update(launch_counts())
        if lbl == label and seen[lbl] == at:
            raise Killed(lbl)

    superblock.pipeline_point = probe
    try:
        return fn(), seen, phase2
    except Killed:
        return None, seen, phase2
    finally:
        superblock.pipeline_point = real


def resume_build(what, corpus, spill_dir, kill=(None, 0), sanitize=True, depth=1,
                 **sb_kw):
    """One phase-11 build of ``corpus`` (S = 4, LCP) through the launcher's
    code path, journaled in ``spill_dir``, its launch counts set to 0 just
    before and read just after; killed at ``kill`` = (label, occurrence).
    Returns (result or None, wall, launches, phase-2 launches, labels seen)."""
    import torch

    from repro_torch.config import SuperblockConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sa_build

    sb = SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True,
                          spill_dir=spill_dir, resume=True, sanitize=sanitize,
                          pipeline_depth=depth, **sb_kw)
    cfg = sa_build.make_config("base", "cuda")
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, seen, phase2 = probed(lambda: sa_build.run(corpus, cfg, "cuda", sb=sb), *kill)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = launch_counts()
    if out is None:
        log(f"phase 11: {what}: killed at {kill[0]} #{kill[1]} after {dt:.3f} s; "
            f"launches {launched}")
        if not os.path.exists(os.path.join(spill_dir, "build.journal")):
            raise AssertionError(f"phase 11: {what}: no journal left to resume")
        return None, dt, launched, phase2, seen
    res = out[0]
    st = res.stats
    log(f"phase 11: {what}: {dt:.3f} s wall, t_stage_s {st['t_stage_s']}, t_build_s "
        f"{st['t_build_s']}, t_merge_s {st['t_merge_s']}; journal_hits "
        f"{st['journal_hits']}, spilled {st['spilled_runs']} runs "
        f"({st['spilled_bytes']} B), store_cache_hits {st['store_cache_hits']}, "
        f"peak_resident_bytes {st['peak_resident_bytes']}; launches {launched} "
        f"(phase 2: {phase2})")
    if not (st["journaled"] and st["sanitized"] == sanitize):
        raise AssertionError(f"phase 11: {what}: {st}")
    if st["dropped"] or st["unresolved"] or st["peak_records"] > st["capacity_records"]:
        raise AssertionError(f"phase 11: {what}: {st}")
    if os.path.exists(os.path.join(spill_dir, "build.journal")):
        raise AssertionError(f"phase 11: {what}: the finished build kept its journal")
    return res, dt, launched, phase2, seen


def same_build(what, res, want, moved=()):
    """``res`` against ``want`` = (SA, LCP, Footprint, stats): the SA and LCP
    bit for bit, the Footprint, and every stat but the walls and ``moved``;
    returns the stats that differ, for the log."""
    import dataclasses

    import numpy as np

    sa, lcp, fp, stats = want
    if not np.array_equal(res.suffix_array, sa):
        raise AssertionError(f"phase 11: {what}: SA differs")
    if not np.array_equal(res.lcp, lcp):
        raise AssertionError(f"phase 11: {what}: LCP differs")
    if dataclasses.asdict(res.footprint) != fp:
        raise AssertionError(f"phase 11: {what}: Footprint {res.footprint} != {fp}")
    got = stats_without_walls(res.stats)
    want_st = stats_without_walls(stats)
    diff = {k: (want_st.get(k), v) for k, v in got.items() if want_st.get(k) != v}
    if set(diff) - set(moved):
        raise AssertionError(f"phase 11: {what}: stats differ beyond {moved}: {diff}")
    return diff


def kept_build(res):
    import dataclasses

    import numpy as np

    return (np.array(res.suffix_array), np.array(res.lcp),
            dataclasses.asdict(res.footprint), dict(res.stats))


def unjournaled_cell(name, corpus):
    """A phase-8 kernel build of ``corpus`` (S = 4, LCP), as a phase-11 cell:
    (name, corpus, (SA, LCP, Footprint, stats), wall)."""
    from repro_torch.config import SuperblockConfig
    from repro_torch.launch import sa_build

    res, dt = sa_build.run(corpus, sa_build.make_config("base", "cuda"), "cuda",
                           sb=SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS,
                                               emit_lcp=True))
    log(f"phase 11: {name} unjournaled: {dt:.3f} s wall")
    return name, corpus, kept_build(res), dt


def phase_resume(reads_cell, text_cell, stream_reads=STREAM_MERGE_READS):
    """Phase 11 (see the module docstring).  ``reads_cell`` and ``text_cell``
    are (name, corpus, (SA, LCP, Footprint, stats), wall) of phase 8's
    unjournaled kernel build.  Returns the launches of each build, by build."""
    import shutil
    import tempfile

    from repro_torch.config import SuperblockConfig
    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.launch import sa_build

    counts = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    spill = lambda tag: os.path.join(tmp, tag)  # noqa: E731
    try:
        name, corpus, base, base_wall = reads_cell
        # (i) uninterrupted: journaled, then journaled and sanitized
        res, wall_j, launched, _, _ = resume_build(f"{name} journaled", corpus,
                                                   spill("j"), sanitize=False)
        diff = same_build(f"{name} journaled", res, base, JOURNAL_MOVES)
        counts[f"{name} journaled"] = launched
        journaled = kept_build(res)
        del res
        res, wall_i, launched, _, _ = resume_build(f"{name} journaled, sanitized",
                                                   corpus, spill("i"))
        diff_i = same_build(f"{name} journaled, sanitized", res, base,
                            JOURNAL_MOVES + SANITIZER_MOVES)
        if launched["window_gather"] <= 0 or launched["merge_path"] <= 0:
            raise AssertionError(f"phase 11: {name}: a kernel not launched: {launched}")
        counts[f"{name} journaled, sanitized"] = launched
        del res
        log(f"phase 11: {name}: unjournaled {base_wall:.3f} s, journaled "
            f"{wall_j:.3f} s ({100 * (wall_j / base_wall - 1):+.1f} %), journaled and "
            f"sanitized {wall_i:.3f} s ({100 * (wall_i / base_wall - 1):+.1f} %); SA, "
            f"LCP and Footprint == the unjournaled build's; stats that moved: journal {diff}, "
            f"journal and sanitizer {diff_i}")

        # (ii) killed at the last block's build and resumed, journaled as the
        # first build of (i) (the sanitizer's cost is that build's).  The
        # killed attempt runs with no worker, so each block's record is
        # appended as its run is written (with one, the last record waits on
        # its spill's write, and the kill would find it pending); the resumed
        # one runs as (i)
        d = spill("ii")
        _, wall_k, launched, _, _ = resume_build(
            f"{name} killed at the last build:block", corpus, d, depth=0,
            kill=("build:block", OOC_SUPERBLOCKS), sanitize=False)
        res, wall_r, launched, _, _ = resume_build(f"{name} resumed after it", corpus, d,
                                                   sanitize=False)
        same_build(f"{name} resumed (ii)", res, journaled,
                   ("journal_hits", "spilled_runs", "spilled_bytes"))
        if res.stats["journal_hits"] != OOC_SUPERBLOCKS - 1:
            raise AssertionError(f"phase 11: (ii) journal_hits {res.stats['journal_hits']}")
        counts[f"{name} resumed after the last build:block"] = launched
        del res
        log(f"phase 11: {name}: killed at the last build:block after {wall_k:.3f} s, "
            f"resumed in {wall_r:.3f} s with journal_hits {OOC_SUPERBLOCKS - 1}: == (i)'s "
            f"journaled build")

        # (iii) killed at the merge's first rank, after every block is durable
        d = spill("iii")
        _, wall_k, _, _, _ = resume_build(f"{name} killed at merge:rank", corpus, d,
                                          kill=("merge:rank", 1), sanitize=False)
        res, wall_r, launched, phase2, _ = resume_build(f"{name} resumed after it",
                                                        corpus, d, sanitize=False)
        same_build(f"{name} resumed (iii)", res, journaled,
                   ("journal_hits", "spilled_runs", "spilled_bytes"))
        if res.stats["journal_hits"] != OOC_SUPERBLOCKS:
            raise AssertionError(f"phase 11: (iii) journal_hits {res.stats['journal_hits']}")
        if not phase2 or any(phase2.values()):
            raise AssertionError(f"phase 11: (iii) phase 2 launched {phase2}")
        want_mp = counts[f"{name} journaled"]["merge_path"]
        if launched["merge_path"] != want_mp:
            raise AssertionError(f"phase 11: (iii) merge_path {launched['merge_path']} "
                                 f"launches, (i) {want_mp}")
        counts[f"{name} resumed after merge:rank"] = launched
        del res
        log(f"phase 11: {name}: killed at merge:rank after {wall_k:.3f} s, resumed in "
            f"{wall_r:.3f} s with journal_hits {OOC_SUPERBLOCKS}: == (i)'s journaled build; "
            f"phase 2 "
            f"launched nothing, merge_path {launched['merge_path']} times as in (i)")
        del journaled

        # the text cell, killed at the merge's first rank and resumed
        name, corpus, base, base_wall = text_cell
        d = spill("text")
        _, wall_k, launched, _, _ = resume_build(f"{name} killed at merge:rank", corpus,
                                                 d, kill=("merge:rank", 1),
                                                 sanitize=False)
        if launched["prefix_pack"] <= 0:
            raise AssertionError(f"phase 11: {name}: prefix_pack not launched: {launched}")
        counts[f"{name} journaled, killed at merge:rank"] = launched
        res, wall_r, launched, _, _ = resume_build(f"{name} resumed after it", corpus, d,
                                                   sanitize=False)
        same_build(f"{name} resumed", res, base, JOURNAL_MOVES)
        if res.stats["journal_hits"] != OOC_SUPERBLOCKS or launched["prefix_pack"]:
            raise AssertionError(f"phase 11: {name}: journal_hits "
                                 f"{res.stats['journal_hits']}, launches {launched}")
        if launched["merge_path"] <= 0:
            raise AssertionError(f"phase 11: {name}: merge_path not launched: {launched}")
        counts[f"{name} resumed after merge:rank"] = launched
        del res
        log(f"phase 11: {name}: killed at merge:rank after {wall_k:.3f} s, resumed in "
            f"{wall_r:.3f} s (unjournaled, phase 8: {base_wall:.3f} s) with journal_hits "
            f"{OOC_SUPERBLOCKS}, prefix_pack launched 0 times: == phase 8's build")

        # a streaming build killed in its merge and resumed
        small = synth_dna_reads(stream_reads, FULL_READ_LEN, seed=0)
        budget = small.size * 4 // 4
        name = f"reads {stream_reads} x 200 streaming"
        sb = SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True,
                              store_backend="chunked", cache_budget_bytes=budget)
        cfg = sa_build.make_config("base", "cuda")
        (ref, wall_u), seen, _ = probed(lambda: sa_build.run(small, cfg, "cuda", sb=sb))
        refills = seen["merge:refill"]
        d = spill("stream")
        kw = dict(store_backend="chunked", cache_budget_bytes=budget)
        _, wall_k, _, _, _ = resume_build(f"{name} killed at merge:refill",
                                          small, d, kill=("merge:refill", refills // 4),
                                          **kw)
        res, wall_r, launched, _, _ = resume_build(f"{name} resumed after it", small, d,
                                                   **kw)
        diff = same_build(f"{name} resumed", res, kept_build(ref),
                          JOURNAL_MOVES + SANITIZER_MOVES)
        st = res.stats
        if st["journal_hits"] != OOC_SUPERBLOCKS or st["peak_resident_bytes"] > budget:
            raise AssertionError(f"phase 11: {name}: {st}")
        if launched["merge_path"] <= 0:
            raise AssertionError(f"phase 11: {name}: merge_path not launched: {launched}")
        counts[f"{name} resumed after merge:refill"] = launched
        log(f"phase 11: {name}: unjournaled {wall_u:.3f} s; journaled and sanitized, "
            f"killed at merge:refill #{refills // 4} of {refills} after {wall_k:.3f} s, "
            f"resumed in {wall_r:.3f} s with journal_hits {OOC_SUPERBLOCKS}; "
            f"peak_resident_bytes {st['peak_resident_bytes']} of budget {budget}; == the "
            f"unjournaled build but {diff}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def count_name(n: int) -> str:
    """1000000 -> "1M", 125000 -> "125K", 500 -> "500"."""
    for unit, size in (("M", 10**6), ("K", 10**3)):
        if n >= size and n % size == 0:
            return f"{n // size}{unit}"
    return str(n)


def scheme_references(builds):
    """In-core kernel-path scheme builds of ``builds`` ((name, corpus)
    pairs), as phase 5 makes them: (SAs, Footprints) by name."""
    from repro_torch.launch import sa_build

    sas, fps = {}, {}
    for name, corpus in builds:
        res, dt = sa_build.run(corpus, sa_build.make_config("base", "cuda"), "cuda")
        log(f"phase 12: {name} scheme reference: {dt:.3f} s wall")
        sas[name], fps[name] = res.suffix_array, res.footprint
    return sas, fps


def mode_build(name, corpus, mode):
    """One build through the launcher's ``run`` in ``mode`` on the card:
    (result, wall, launches, peak bytes, per-round walls of a doubling
    build)."""
    import torch

    from repro_torch.core import prefix_doubling
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sa_build

    walls = []
    real = prefix_doubling._round

    def timed_round(*args, **kw):  # the round loop synchronises every round
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefix_doubling._round = timed_round
    reset_launch_counts()
    try:
        res, dt = sa_build.run(corpus, sa_build.make_config("base", "cuda"), "cuda",
                               mode=mode)
    finally:
        prefix_doubling._round = real
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = res.stats["num_suffixes"]
    log(f"phase 12: {name}: {dt:.3f} s wall, {n / dt:.0f} suffixes/s, peak "
        f"{peak / 2**30:.2f} GiB, launches {launched}")
    sa_build.report(res, dt, mode)
    if any(launched.values()):
        raise AssertionError(f"phase 12: {name}: a kernel launched: {launched}")
    if res.stats["dropped"] or res.stats.get("unresolved", 0):
        raise AssertionError(f"phase 12: {name}: {res.stats}")
    return res, dt, launched, peak, walls


def phase_build_modes(dev, reads_corpus, text_tokens, incore_sa, scheme_fp):
    """Phase 12 (see the module docstring).  ``incore_sa`` and ``scheme_fp``
    hold phase 5's kernel-path SAs and Footprints by build.  Returns the
    launches of each build, by build."""
    import numpy as np
    import torch

    from repro_torch.data.corpus import flatten_reads_with_separators, synth_token_corpus
    from repro_torch.data.dedup import dedup_corpus, find_duplicate_spans
    from repro_torch.kernels import launch_counts, reset_launch_counts

    counts = {}
    r, l = reads_corpus.shape
    name = f"terasort reads {count_name(r)} x {l}"
    res, dt, counts[name], _, _ = mode_build(name, reads_corpus, "terasort")
    if not np.array_equal(res.suffix_array, incore_sa[READS_BUILD]):
        raise AssertionError(f"phase 12: {name}: SA != the in-core scheme build's")
    scheme, tera = scheme_fp[READS_BUILD].shuffle, res.footprint.shuffle
    if scheme * (l + 9) != tera * 16:
        raise AssertionError(f"phase 12: shuffle ratio {scheme}/{tera} != 16/{l + 9}")
    log(f"phase 12: {name}: SA == phase 5's in-core SA; shuffle scheme/terasort "
        f"{scheme}/{tera} = 16/{l + 9} ({scheme / tera:.6f}); materialized "
        f"{res.footprint.materialized} B")
    del res
    phase_profile([(name, reads_corpus)], mode="terasort", phase=12)

    name = f"doubling text 2^{text_tokens.shape[0].bit_length() - 1}"
    res, dt, counts[name], _, walls = mode_build(name, text_tokens, "doubling")
    if not np.array_equal(res.suffix_array, incore_sa[TEXT_BUILD]):
        raise AssertionError(f"phase 12: {name}: SA != the in-core scheme build's")
    log(f"phase 12: {name}: SA == phase 5's in-core SA; rounds {res.stats['rounds']}, "
        f"round walls {[round(w, 4) for w in walls]} s")
    del res
    phase_profile([(name, text_tokens)], mode="doubling", phase=12)

    cut = reads_corpus[:OOC_READS]
    name = f"doubling reads {count_name(cut.shape[0])} flattened"
    res, dt, counts[name], _, walls = mode_build(name, cut, "doubling")
    flat = torch.from_numpy(flatten_reads_with_separators(cut)).to(dev)
    sa = torch.from_numpy(res.suffix_array).to(dev)
    check_permutation(sa, torch.arange(flat.shape[0], device=dev))
    # text order across the separators: shift the tokens up one so that only
    # the stream's end (0) stops a compare and the separator compares as 1
    check_sampled_order(flat + 1, sa, sa, seed=7)
    log(f"phase 12: {name}: {flat.shape[0]} tokens, permutation ok, {PAIR_SAMPLES} "
        f"sampled pairs ordered; rounds {res.stats['rounds']}, round walls "
        f"{[round(w, 4) for w in walls]} s")
    del res, flat, sa

    toks, planted = synth_token_corpus(1 << DEDUP_LOG2, 4, seed=0,
                                       dup_fraction=DEDUP_FRACTION, dup_span=DEDUP_SPAN)
    name = f"dedup text 2^{DEDUP_LOG2}"
    reset_launch_counts()
    t0 = time.perf_counter()
    spans, keeps, stats = {}, {}, {}
    for mode in ("scheme", "doubling"):
        spans[mode] = set(find_duplicate_spans(toks, device=dev, mode=mode))
        _, keeps[mode], stats[mode] = dedup_corpus(toks, device=dev, mode=mode)
    dt = time.perf_counter() - t0
    counts[name] = launch_counts()
    if any(counts[name].values()):
        raise AssertionError(f"phase 12: {name}: a kernel launched: {counts[name]}")
    if not (spans["scheme"] == spans["doubling"] and stats["scheme"] == stats["doubling"]
            and np.array_equal(keeps["scheme"], keeps["doubling"])):
        raise AssertionError(f"phase 12: {name}: modes differ: {stats}")
    keep = keeps["scheme"]
    intact = [(s, d, n) for s, d, n in planted
              if np.array_equal(toks[s:s + n], toks[d:d + n])]
    missed = [p for p in intact if keep[p[0]:p[0] + p[2]].all()
              and keep[p[1]:p[1] + p[2]].all()]
    if not intact or missed:
        raise AssertionError(f"phase 12: {name}: {len(missed)} of {len(intact)} "
                             f"planted spans kept twice")
    log(f"phase 12: {name}: {dt:.3f} s for both modes (find + dedup each), "
        f"{len(spans['scheme'])} spans, scheme == doubling (spans, mask, stats "
        f"{stats['scheme']}); all {len(intact)} intact planted spans of "
        f"{len(planted)} masked once")
    return counts


def ranks_worker(rank, d, work):
    """One gloo rank of phase 13 (a ``torch.multiprocessing`` spawn target):
    every build of ``RANKS_BUILDS`` on the corpora in ``work``, each between
    two barriers, with its launches, peak memory and collective traffic
    reset just before it and read just after.  Writes ``rank{rank}.pkl``
    (and rank 0 each build's suffix array as ``{build}.npy``)."""
    import dataclasses
    import hashlib
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.core.pipeline import refine_indices
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import sa_build

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'rdzv')}",
                            rank=rank, world_size=d)
    try:
        corpora = {c: np.load(os.path.join(work, f"{c}.npy")) for c in ("reads", "text")}
        gidx = np.load(os.path.join(work, "gidx.npy"))
        out = {}
        for name, corpus, mode, kernels in RANKS_BUILDS:
            cfg = sa_build.make_config("base", "cuda", use_pallas=kernels)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            distributed.reset_traffic()
            dist.barrier()
            t0 = time.perf_counter()
            if mode == "refine":
                sa = refine_indices(corpora[corpus], gidx, cfg=cfg, device="cuda")
                fp = stats = None
            else:
                res, _ = sa_build.run(corpora[corpus], cfg, "cuda", mode=mode)
                sa, fp, stats = (res.suffix_array, dataclasses.asdict(res.footprint),
                                 res.stats)
                del res
            torch.cuda.synchronize()
            dist.barrier()
            out[name] = dict(
                wall=time.perf_counter() - t0, launches=launch_counts(),
                peak=torch.cuda.max_memory_allocated(), traffic=dict(distributed.TRAFFIC),
                footprint=fp, stats=stats, n=int(sa.shape[0]),
                digest=hashlib.sha256(np.ascontiguousarray(sa).tobytes()).hexdigest())
            if rank == 0:
                np.save(os.path.join(work, f"{name}.npy"), sa)
            del sa
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(d, work, worker=None, timeout=900):
    """Run ``worker`` (phase 13's ``ranks_worker`` by default) on d
    processes; every one is stopped on the way out.  Returns each rank's
    results."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(worker or ranks_worker, args=(d, work), nprocs=d,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{d} ranks not done in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return read_ranks(d, work)


def read_ranks(d, work):
    """Each rank's ``rank{rank}.pkl`` in ``work``."""
    import pickle

    out = []
    for rank in range(d):
        with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def launcher_ranks(d, reads):
    """``repro_torch.launch.sa_build`` under ``torchrun`` with d ranks on the
    card: it must exit 0, and rank 0 alone print d ``per_device_counts``
    with nothing dropped or unresolved."""
    import ast

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(d), "-m", "repro_torch.launch.sa_build",
         "--reads", str(reads), "--read-len", str(FULL_READ_LEN)],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 13: torchrun exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    stats = [ast.literal_eval(x[len("stats: "):]) for x in lines if x.startswith("stats: ")]
    choice = [x for x in proc.stderr.splitlines() if x.startswith("process group:")]
    if (len(stats) != 1 or len(stats[0]["per_device_counts"]) != d
            or stats[0]["dropped"] or stats[0]["unresolved"]):
        raise AssertionError(f"phase 13: torchrun printed {lines}")
    log(f"phase 13: torchrun --nproc-per-node {d} repro_torch.launch.sa_build "
        f"--reads {reads} --read-len {FULL_READ_LEN}: exit 0 in {dt:.1f} s; "
        f"{choice}; {lines[0]}; stats {stats[0]}")


def phase_ranks(dev, reads=RANKS_READS, text_log2=RANKS_TEXT_LOG2, d=RANKS_D):
    """Phase 13 (see the module docstring).  Returns the launches of each
    build, summed over the ranks, by build."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
    from repro_torch.launch import sa_build

    corpora = {"reads": synth_dna_reads(reads, FULL_READ_LEN, seed=0),
               "text": synth_token_corpus(1 << text_log2, 4, seed=0)[0]}
    label = {"reads": f"reads {count_name(reads)} x {FULL_READ_LEN}",
             "text": f"text 2^{text_log2}"}
    refs = {}
    for c, corpus in corpora.items():
        res, dt = sa_build.run(corpus, sa_build.make_config("base", "cuda"), "cuda")
        refs[c] = res.suffix_array
        log(f"phase 13: {label[c]} one rank (the reference, kernels): {dt:.3f} s wall, "
            f"{res.stats['num_suffixes'] / dt:.0f} suffixes/s")
        del res
    rng = np.random.default_rng(13)
    gidx = rng.choice(refs["reads"], size=RANKS_REFINE, replace=False)
    want = {"reads": refs["reads"], "text": refs["text"],
            "refine": refs["reads"][np.isin(refs["reads"], gidx)]}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 13: the parent holds {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
        f"on the card before the ranks start")

    counts = {}
    with tempfile.TemporaryDirectory() as work:
        for c, corpus in corpora.items():
            np.save(os.path.join(work, f"{c}.npy"), corpus)
        np.save(os.path.join(work, "gidx.npy"), gidx)
        t0 = time.perf_counter()
        ranks = spawn_ranks(d, work)
        log(f"phase 13: {d} gloo ranks on one card: spawn to exit {time.perf_counter() - t0:.1f} s")
        sas = {name: np.load(os.path.join(work, f"{name}.npy")) for name, *_ in RANKS_BUILDS}
    for name, corpus, mode, kernels in RANKS_BUILDS:
        r = [res[name] for res in ranks]
        for i, x in enumerate(r[1:], 1):
            if (x["digest"], x["footprint"], x["stats"]) != (
                    r[0]["digest"], r[0]["footprint"], r[0]["stats"]):
                raise AssertionError(f"phase 13: {name}: rank {i} != rank 0")
        if not np.array_equal(sas[name], want["refine" if mode == "refine" else corpus]):
            raise AssertionError(f"phase 13: {name}: SA != the one-rank build's")
        stats = r[0]["stats"] or {}
        if stats.get("dropped") or stats.get("unresolved"):
            raise AssertionError(f"phase 13: {name}: {stats}")
        launched = {k: sum(x["launches"][k] for x in r) for k in r[0]["launches"]}
        full = f"{d} ranks {label[corpus]} {name.split(' ', 1)[1]}"
        counts[full] = launched
        if kernels and not launched["bucket_hist"]:
            raise AssertionError(f"phase 13: {name}: bucket_hist not launched: {launched}")
        if not kernels and any(launched.values()):
            raise AssertionError(f"phase 13: {name}: plain path launched {launched}")
        wall = max(x["wall"] for x in r)
        n = r[0]["n"]
        walls = ", ".join(f"{x:.3f}" for x in (y["wall"] for y in r))
        log(f"phase 13: {full}: {wall:.3f} s wall (largest rank; {walls}), "
            f"{n / wall:.0f} suffixes/s, "
            f"peak GiB {[round(x['peak'] / 2**30, 2) for x in r]} "
            f"(sum {sum(x['peak'] for x in r) / 2**30:.2f}), exchange bytes a rank "
            f"{[x['traffic']['exchange_bytes'] for x in r]} in "
            f"{r[0]['traffic']['exchanges']} exchanges, gathered bytes a rank "
            f"{[x['traffic']['gather_bytes'] for x in r]}, launches {launched}")
        if stats:
            log(f"phase 13: {full}: stats {stats}")
    for c, kernel in (("reads", "window_gather"), ("text", "prefix_pack")):
        name = f"{c} scheme"
        a, b = ranks[0][f"{name} kernels"], ranks[0][f"{name} plain"]
        if (a["digest"], a["footprint"], a["stats"]) != (b["digest"], b["footprint"],
                                                           b["stats"]):
            raise AssertionError(f"phase 13: {name}: kernels != plain")
        if not counts[f"{d} ranks {label[c]} scheme kernels"][kernel]:
            raise AssertionError(f"phase 13: {name} kernels: {kernel} not launched")
    log(f"phase 13: every build equals its one-rank build, every rank rank 0's, kernels "
        f"== plain (SA, Footprint, stats), nothing dropped or unresolved")
    launcher_ranks(d, RANKS_LAUNCH_READS)
    return counts


# phase 14: the out-of-core, journaled, indexed and streaming builds on
# RANKS_D gloo ranks on the one card.  (a) and (c) at OOC_RANKS_READS reads
# (every rank runs the whole merge); the device merge, the streaming build
# and the launcher run at smaller read counts (the device merge's refiner
# ranks its tiles collectively; streaming thrashes the chunked cache on
# every rank at once)
OOC_RANKS_READS = 20_000
OOC_RANKS_DEVICE_READS = 2_000
OOC_RANKS_STREAM_READS = 500
OOC_RANKS_LAUNCH_READS = 10_000
OOC_RANKS_SEEDS, OOC_RANKS_SEED_LEN = 4096, 24
# phase 13's builds under --nccl (one rank a card): the reads scheme build
# and TeraSort over RANKS_READS reads
NCCL_INCORE = ("scheme", "terasort")


class Killed(Exception):
    """The simulated crash of phase 14 (c), raised on every rank."""


def digest(a) -> str:
    """sha256 of an integer array's values as int64."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a, np.int64).tobytes()).hexdigest()


def file_digests(path, names=("suffix_array.npy", "lcp.npy", "corpus.sachunk")):
    import hashlib

    out = {}
    for name in names:
        h = hashlib.sha256()
        with open(os.path.join(path, name), "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
        out[name] = h.hexdigest()
    return out


def ooc_rank_job(job, work, ranks):
    """One job of phase 14 on this rank; returns what the parent checks."""
    import dataclasses

    import numpy as np

    import repro_torch.core.superblock as sbmod
    from repro_torch.config import SuperblockConfig
    from repro_torch.launch import sa_build
    from repro_torch.serve.sa_engine import SuffixArrayIndex

    corpus = np.load(os.path.join(work, f"{job['corpus']}.npy"))
    cfg = sa_build.make_config("base", "cuda")
    if job["kind"] == "open":
        seeds = list(np.load(os.path.join(work, "seeds.npy")))
        idx = SuffixArrayIndex.open(os.path.join(work, job["index"]),
                                    store_backend="memory", device="cuda")
        counts = idx.count(seeds)
        hits = idx.align(seeds)
        out = dict(counts=digest(np.asarray(counts)),
                   align=digest(np.array([x for h in hits for p in h for x in p],
                                         np.int64)),
                   hits=int(np.asarray(counts).sum()), seeds=len(seeds),
                   engine_stats=idx.engine.engine_stats())
        idx.close()
        return out
    if job["kind"] in ("scheme", "terasort"):
        res, _ = sa_build.run(corpus, cfg, "cuda", mode=job["kind"])
        return dict(sa=digest(res.suffix_array), n=int(res.suffix_array.shape[0]),
                    stats=stats_without_walls(res.stats))
    kw = dict(job["sb"])
    if job.get("index"):
        kw.update(spill_dir=os.path.join(work, job["index"]), write_manifest=True)
    sb = SuperblockConfig(**kw)
    kill = job.get("kill")
    real = sbmod.pipeline_point
    if kill:
        seen = [0]

        def probe(label):
            real(label)
            if label == kill[0]:
                seen[0] += 1
                if seen[0] == kill[1]:
                    raise Killed(label)

        sbmod.pipeline_point = probe
    try:
        res = sbmod.build_suffix_array_superblock(corpus, cfg=cfg, sb=sb, device="cuda")
    except Killed:
        return dict(killed=True)
    finally:
        sbmod.pipeline_point = real
    if kill:
        raise AssertionError(f"phase 14: {job['name']}: the build passed {kill}")
    out = dict(sa=digest(res.suffix_array), lcp=digest(res.lcp),
               n=int(res.suffix_array.shape[0]),
               footprint=dataclasses.asdict(res.footprint),
               stats=stats_without_walls(res.stats))
    if job.get("index"):
        out["files"] = file_digests(sb.spill_dir)
    return out


def run_rank_jobs(ranks, work, jobs):
    """Every job of ``jobs`` on this rank, each between two barriers with its
    launches, peak memory and collective traffic reset just before it and
    read just after; writes ``rank{rank}.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.kernels import launch_counts, reset_launch_counts

    out = {}
    for job in jobs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        distributed.reset_traffic()
        dist.barrier()
        t0 = time.perf_counter()
        res = ooc_rank_job(job, work, ranks)
        torch.cuda.synchronize()
        dist.barrier()
        res.update(wall=time.perf_counter() - t0, launches=launch_counts(),
                   peak=torch.cuda.max_memory_allocated(),
                   traffic=dict(distributed.TRAFFIC))
        out[job["name"]] = res
    with open(os.path.join(work, f"rank{ranks.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def ooc_ranks_worker(rank, d, work):
    """One gloo rank of phase 14 on the one card (a
    ``torch.multiprocessing`` spawn target)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import world

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'rdzv')}",
                            rank=rank, world_size=d)
    try:
        with open(os.path.join(work, "jobs.json")) as f:
            run_rank_jobs(world(), work, json.load(f))
    finally:
        dist.destroy_process_group()


def nccl_rank(work) -> int:
    """One rank of ``--nccl`` under ``torchrun`` (one rank a card): joins the
    process group as the launcher does (``sa_build.init_ranks``, which picks
    NCCL there) and runs the jobs in ``work``."""
    import torch.distributed as dist

    from repro_torch.launch import sa_build

    ranks = sa_build.init_ranks("cuda")
    try:
        if ranks.rank == 0:
            with open(os.path.join(work, "backend.txt"), "w") as f:
                f.write(dist.get_backend())
        with open(os.path.join(work, "jobs.json")) as f:
            run_rank_jobs(ranks, work, json.load(f))
    finally:
        dist.destroy_process_group()
    return 0


def one_rank_index(dev, work, corpus, sa, lcp):
    """The one-rank index directory of phase 8's reads cell, as a one-rank
    out-of-core build writes it (int64 SA and LCP, the corpus serialized
    from the memory store), and its answers to phase 14's seeds through
    ``SuffixArrayIndex.open`` on the memory store."""
    import numpy as np

    from repro_torch.core import index_io
    from repro_torch.core.store import InMemoryBackend
    from repro_torch.launch import sa_build
    from repro_torch.serve.sa_engine import SuffixArrayIndex

    cfg = sa_build.make_config("base", "cuda")
    path = os.path.join(work, "ix_one_rank")
    backend = InMemoryBackend(corpus, cfg, device=dev)
    index_io.save_index(path, cfg, backend, np.asarray(sa, np.int64),
                        np.asarray(lcp, np.int64))
    backend.close()
    seeds = list(np.load(os.path.join(work, "seeds.npy")))
    idx = SuffixArrayIndex.open(path, store_backend="memory", device=dev)
    counts = idx.count(seeds)
    hits = idx.align(seeds)
    answers = dict(counts=digest(np.asarray(counts)),
                   align=digest(np.array([x for h in hits for p in h for x in p],
                                         np.int64)))
    idx.close()
    return file_digests(path), answers


def write_seeds(work, corpus, m=OOC_RANKS_SEED_LEN, seed=14):
    """``OOC_RANKS_SEEDS`` alignment seeds: ``m``-token windows of random
    reads."""
    import numpy as np

    count = OOC_RANKS_SEEDS
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, corpus.shape[0], count)
    offs = rng.integers(0, corpus.shape[1] - m, count)
    seeds = np.stack([corpus[r, o : o + m] for r, o in zip(rows, offs)]).astype(np.int64)
    np.save(os.path.join(work, "seeds.npy"), seeds)


def ooc_jobs(reads_label):
    """Phase 14's jobs (a)-(e), in order."""
    s = dict(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True)
    return [
        dict(name=f"(a) {reads_label}", kind="superblock", corpus="reads", sb=s),
        dict(name=f"(b) reads {count_name(OOC_RANKS_DEVICE_READS)} x 200 device merge",
             kind="superblock", corpus="device_reads", sb=dict(s, merge_backend="device")),
        dict(name=f"(c) {reads_label} journaled, killed at merge:rank #1",
             kind="superblock", corpus="reads", sb=dict(s, resume=True), index="ix_c",
             kill=("merge:rank", 1)),
        dict(name=f"(c) {reads_label} journaled, resumed", kind="superblock",
             corpus="reads", sb=dict(s, resume=True), index="ix_c"),
        dict(name="(d) open (c)'s index, count and align", kind="open", corpus="reads",
             index="ix_c"),
        dict(name=f"(e) reads {OOC_RANKS_STREAM_READS} x 200 streaming",
             kind="superblock", corpus="stream_reads", index="ix_e",
             sb=dict(s, store_backend="chunked", cache_budget_bytes=0)),
    ]


def check_same_on_ranks(name, r, keys):
    for i, x in enumerate(r[1:], 1):
        for k in keys:
            if x.get(k) != r[0].get(k):
                raise AssertionError(f"phase 14: {name}: rank {i}'s {k} != rank 0's")


def report_ranks(phase, name, r, backend="gloo"):
    """Log a D-rank run's wall (the largest rank's, barrier to barrier), each
    rank's peak memory and traffic; returns its launches summed over the
    ranks."""
    launched = {k: sum(x["launches"][k] for x in r) for k in r[0]["launches"]}
    wall = max(x["wall"] for x in r)
    walls = ", ".join(f"{x['wall']:.3f}" for x in r)
    n = r[0].get("n")
    log(f"{phase}: {len(r)} {backend} ranks {name}: {wall:.3f} s wall (largest rank; "
        f"{walls})"
        + (f", {n / wall:.0f} suffixes/s" if n else "")
        + f", peak GiB {[round(x['peak'] / 2**30, 2) for x in r]}, exchange bytes a "
        f"rank {[x['traffic']['exchange_bytes'] for x in r]} in "
        f"{r[0]['traffic']['exchanges']} exchanges, gathered bytes a rank "
        f"{[x['traffic']['gather_bytes'] for x in r]}, launches {launched}")
    if "stats" in r[0]:
        log(f"{phase}: {name}: stats {r[0]['stats']}")
    return launched


def launcher_ooc_ranks(d, reads, work):
    """(f): ``repro_torch.launch.sa_build`` under ``torchrun`` with d ranks,
    out of core, journaled into an index directory; then
    ``repro_torch.launch.serve`` finds the first read's first 8 tokens in
    it."""
    import ast

    from repro_torch.data.corpus import synth_dna_reads

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    ix = os.path.join(work, "ix_f")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(d), "-m", "repro_torch.launch.sa_build",
         "--reads", str(reads), "--read-len", str(FULL_READ_LEN), "--superblocks",
         str(OOC_SUPERBLOCKS), "--index-dir", ix, "--resume"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 14 (f): torchrun exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    stats = [ast.literal_eval(x[len("stats: "):]) for x in lines if x.startswith("stats: ")]
    if (len(stats) != 1 or stats[0]["dropped"] or stats[0]["unresolved"]
            or not stats[0]["journaled"] or stats[0]["superblocks"] != OOC_SUPERBLOCKS
            or not lines[0].startswith("out-of-core: ")):
        raise AssertionError(f"phase 14 (f): torchrun printed {lines}")
    pattern = ",".join(map(str, synth_dna_reads(reads, FULL_READ_LEN, seed=0)[0, :8]))
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--index-dir", ix,
         "--pattern", pattern], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=300)
    answer = [x for x in serve.stdout.splitlines() if x.startswith("  pattern ")]
    if serve.returncode != 0 or len(answer) != 1 or "count=0" in answer[0]:
        raise AssertionError(f"phase 14 (f): serve exited {serve.returncode}: "
                             f"{serve.stdout[-2000:]} {serve.stderr[-2000:]}")
    log(f"phase 14 (f): torchrun --nproc-per-node {d} repro_torch.launch.sa_build "
        f"--reads {reads} --superblocks {OOC_SUPERBLOCKS} --index-dir --resume: exit 0 "
        f"in {dt:.1f} s; {lines[0]}; {[x for x in lines if x.startswith('resume:')]}; "
        f"then repro_torch.launch.serve:{answer[0]}")


def ooc_references(dev, work, reads, ref):
    """Phase 14's one-rank references, with the corpora and seeds written
    into ``work``: phase 8's reads cell (``ref`` when it has ``reads``
    reads, else built here) with its index directory and answers, the
    device merge's one-rank build and the streaming build's in-memory SA.
    Returns (the reads cell's label, the expected digests by job tag, the
    one-rank index files, its answers, the streaming budget)."""
    import numpy as np

    from repro_torch.config import SuperblockConfig
    from repro_torch.core.superblock import build_suffix_array_superblock
    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.launch import sa_build

    if ref is not None and ref[0].shape[0] == reads:
        corpus, sa, lcp = ref
    else:
        corpus = synth_dna_reads(reads, FULL_READ_LEN, seed=0)
        sa, lcp = incore_reference(dev, corpus, "phase 14")
    cfg = sa_build.make_config("base", "cuda")
    device_reads = synth_dna_reads(OOC_RANKS_DEVICE_READS, FULL_READ_LEN, seed=0)
    t0 = time.perf_counter()
    dres = build_suffix_array_superblock(
        device_reads, cfg=cfg, device=dev,
        sb=SuperblockConfig(num_superblocks=OOC_SUPERBLOCKS, emit_lcp=True,
                            merge_backend="device"))
    log(f"phase 14: one rank, the device merge's reference: "
        f"{time.perf_counter() - t0:.3f} s")
    stream_reads = synth_dna_reads(OOC_RANKS_STREAM_READS, FULL_READ_LEN, seed=0)
    want = {"(a)": (digest(sa), digest(lcp)),
            "(b)": (digest(dres.suffix_array), digest(dres.lcp)),
            "(e)": digest(sa_build.run(stream_reads, cfg, "cuda")[0].suffix_array)}
    for key, c in (("reads", corpus), ("device_reads", device_reads),
                   ("stream_reads", stream_reads)):
        np.save(os.path.join(work, f"{key}.npy"), c)
    write_seeds(work, corpus)
    one_files, one_answers = one_rank_index(dev, work, corpus, sa, lcp)
    label = f"reads {count_name(reads)} x {FULL_READ_LEN} out-of-core"
    # the streaming job's budget: a quarter of its corpus bytes
    return label, want, one_files, one_answers, stream_reads.size * 4 // 4


def free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"the parent holds {torch.cuda.memory_allocated() / 2**20:.1f} MiB on the "
        f"card before the ranks start")


def check_ooc_job(phase, job, r, want, one_files, one_answers, budget, backend="gloo"):
    """Hold one job's results on every rank to its one-rank reference;
    returns its launches summed over the ranks."""
    name = job["name"]
    check_same_on_ranks(name, r, ("sa", "lcp", "footprint", "stats", "files",
                                  "counts", "align", "engine_stats", "killed"))
    launched = report_ranks(phase, name, r, backend)
    x = r[0]
    tag = name[:3]
    if job["kind"] in ("scheme", "terasort"):
        if x["sa"] != want["scheme"] or x["stats"].get("unresolved"):
            raise AssertionError(f"{phase}: {name}: SA != the one-rank build's")
        return launched
    if job.get("kill"):
        if not x.get("killed"):
            raise AssertionError(f"{phase}: {name}: not killed")
    elif job["kind"] == "open":
        if (x["counts"], x["align"]) != (one_answers["counts"], one_answers["align"]):
            raise AssertionError(f"{phase}: {name}: answers != the one-rank index's")
        if not launched["pattern_search"]:
            raise AssertionError(f"{phase}: {name}: pattern_search not launched: "
                                 f"{launched}")
        log(f"{phase}: {name}: {x['seeds']} seeds, {x['hits']} hits, counts and "
            f"align == the one-rank index's on every rank; engine_stats "
            f"{x['engine_stats']}")
    else:
        st = x["stats"]
        if st["dropped"] or st["unresolved"]:
            raise AssertionError(f"{phase}: {name}: {st}")
        if tag == "(e)":
            if x["sa"] != want["(e)"]:
                raise AssertionError(f"{phase}: {name}: SA != the in-memory build's")
            if st["peak_resident_bytes"] > budget:
                raise AssertionError(f"{phase}: {name}: peak_resident_bytes "
                                     f"{st['peak_resident_bytes']} > {budget}")
        elif (x["sa"], x["lcp"]) != want["(b)" if tag == "(b)" else "(a)"]:
            raise AssertionError(f"{phase}: {name}: SA or LCP != the one-rank build's")
        if tag == "(a)" and not (launched["merge_path"] and launched["window_gather"]):
            raise AssertionError(f"{phase}: {name}: launches {launched}")
        if "resumed" in name:
            if st["journal_hits"] != OOC_SUPERBLOCKS:
                raise AssertionError(f"{phase}: {name}: journal_hits "
                                     f"{st['journal_hits']}")
            if x["files"] != one_files:
                raise AssertionError(f"{phase}: {name}: index files != the one-rank "
                                     f"build's")
    if job["kind"] == "superblock" and "resumed" not in name and not launched[
            "bucket_hist"]:
        raise AssertionError(f"{phase}: {name}: bucket_hist not launched: {launched}")
    return launched


def phase_ranks_ooc(dev, reads=OOC_READS, d=RANKS_D, ref=None):
    """Phase 14 (see the module docstring).  ``ref`` is phase 8's reads cell
    (corpus, SA, LCP), or None to build it here.  Returns the launches of
    each run, summed over the ranks."""
    import tempfile

    log(f"phase 14: host cores {os.cpu_count()}")
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_ooc_") as work:
        label, want, one_files, one_answers, budget = ooc_references(dev, work, reads,
                                                                     ref)
        del ref
        jobs = ooc_jobs(label)
        jobs[-1]["sb"]["cache_budget_bytes"] = budget
        with open(os.path.join(work, "jobs.json"), "w") as f:
            json.dump(jobs, f)
        free_card()
        t0 = time.perf_counter()
        ranks = spawn_ranks(d, work, ooc_ranks_worker)
        log(f"phase 14: {d} gloo ranks on one card: spawn to exit "
            f"{time.perf_counter() - t0:.1f} s")
        for job in jobs:
            counts[f"{d} ranks {job['name']}"] = check_ooc_job(
                "phase 14", job, [x[job["name"]] for x in ranks], want, one_files,
                one_answers, budget)
        log("phase 14: every D-rank build equals its one-rank build, every rank rank "
            "0's; (c) adopted every block on every rank and wrote the one-rank "
            "build's index files; (d) answered as the one-rank index")
        launcher_ooc_ranks(d, OOC_RANKS_LAUNCH_READS, work)
    return counts


def phase_nccl(dev, reads=RANKS_READS, ooc_reads=OOC_READS, d=4):
    """``--nccl``: phase 13's reads scheme build and TeraSort, and phase 14
    (a) and (c), under ``torchrun --nproc-per-node d`` with one rank a card,
    where ``sa_build.backend_for`` picks NCCL.  Each must equal its one-rank
    build."""
    import tempfile

    import numpy as np

    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.launch import sa_build

    import torch

    if torch.cuda.device_count() < d:
        raise AssertionError(f"--nccl: {torch.cuda.device_count()} cards, {d} needed")
    log(f"--nccl: host cores {os.cpu_count()}, {torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as work:
        label, want, one_files, one_answers, budget = ooc_references(dev, work,
                                                                     ooc_reads, None)
        rank_reads = synth_dna_reads(reads, FULL_READ_LEN, seed=0)
        res, dt = sa_build.run(rank_reads, sa_build.make_config("base", "cuda"), "cuda")
        want["scheme"] = digest(res.suffix_array)
        log(f"--nccl: reads {count_name(reads)} x 200 one rank (the reference): "
            f"{dt:.3f} s")
        del res
        np.save(os.path.join(work, "rank_reads.npy"), rank_reads)
        jobs = ([dict(name=f"reads {count_name(reads)} x 200 {mode}", kind=mode,
                      corpus="rank_reads") for mode in NCCL_INCORE]
                + [j for j in ooc_jobs(label) if j["name"][:3] in ("(a)", "(c)")])
        with open(os.path.join(work, "jobs.json"), "w") as f:
            json.dump(jobs, f)
        free_card()
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(d), os.path.join(HERE, "chip_smoke.py"),
             "--nccl-rank", work],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=1500)
        log(f"--nccl: torchrun --nproc-per-node {d}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0:
            raise AssertionError(f"--nccl: torchrun exited {proc.returncode}: "
                                 f"{proc.stdout[-3000:]} {proc.stderr[-6000:]}")
        with open(os.path.join(work, "backend.txt")) as f:
            backend = f.read().strip()
        choice = [x for x in proc.stderr.splitlines() if x.startswith("process group:")]
        log(f"--nccl: backend {backend}; {choice}")
        if backend != "nccl":
            raise AssertionError(f"--nccl: the ranks joined over {backend}")
        ranks = read_ranks(d, work)
        for job in jobs:
            check_ooc_job("--nccl", job, [x[job["name"]] for x in ranks], want,
                          one_files, one_answers, budget, backend)
        log("--nccl: every build over NCCL equals its one-rank build, every rank "
            "rank 0's; (c) adopted every block and wrote the one-rank build's "
            "index files")


# phase 15: LM serving on the card.  (a) LM_ARCH at full width in bf16
# through repro_torch.launch.lm_serve's path, the prompt longer than the
# local layers' 512-token window; (b) LM_ARCH in float32 at full width:
# prefill + one decode step against the forward over the longer sequence,
# and the windowed decode against the full one; (c) ServeEngine on (b)'s
# model; (d) every other full config one card holds, bf16; (e) the tiny
# configs in float32, card against the CPU
LM_ARCH = "gemma3-1b"
LM_BATCH, LM_PROMPT, LM_MAX_SEQ, LM_GEN = 4, 1024, 2048, 32
LM_CHECK_BATCH, LM_CHECK_LEN, LM_CHECK_MAX_SEQ = 2, 600, 640
LM_ENGINE_REQS, LM_ENGINE_SLOTS, LM_ENGINE_NEW, LM_ENGINE_PROMPTS = 8, 4, 16, (16, 64)
LM_OTHERS = ("granite-moe-3b-a800m", "hymba-1.5b", "minicpm-2b", "xlstm-125m",
             "musicgen-large", "internvl2-2b", "granite-20b", "gemma3-27b")
LM_LEFT_OUT = {"mixtral-8x7b": "46.7 B parameters are 87 GiB in bf16, more than "
                               "one card's 80 GB"}
LM_OTHER_BATCH, LM_OTHER_PROMPT, LM_OTHER_GEN = 2, 256, 8
LM_TINY = ("tiny-gemma3", "tiny-granite", "tiny-minicpm", "tiny-mixtral",
           "tiny-granite-moe", "tiny-hymba", "tiny-xlstm", "tiny-musicgen",
           "tiny-internvl2")
# float32 tolerances on the card (TF32 off for matmuls and cuDNN): rtol, and
# atol scaled by max(1, max |reference|), as the CPU tests hold the port to
# repro: 2e-4 for logits over the same sequence, 2e-3 for a decode step
LM_TOL, LM_DECODE_TOL = 2e-4, 2e-3


def lm_close(name, got, want, tol):
    """Max |got - want| (float64 on the host); raises past rtol = ``tol``,
    atol = ``tol`` x max(1, max |want|)."""
    import numpy as np

    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or np.any(np.abs(got - want) > tol * (scale + np.abs(want))):
        raise AssertionError(f"phase 15: {name}: max |err| {err} past {tol} "
                             f"(scale {scale:.3f})")
    return err, scale


def ring_caches(cfg, cache, length, max_seq):
    """The windowed decode's ring caches holding what a full cache holds for
    positions below ``length`` (slot = position mod the layer's window)."""
    import torch

    out = {}
    for i in range(cfg.num_layers):
        w = min(cfg.attention.window_for_layer(i, max_seq), max_seq)
        pos = torch.arange(max(0, length - w), length, device=cache["k"].device)
        layer = {}
        for kv in ("k", "v"):
            ring = torch.zeros((cache[kv].shape[1], w, *cache[kv].shape[3:]),
                               dtype=cache[kv].dtype, device=cache[kv].device)
            ring[:, pos % w] = cache[kv][i][:, pos]
            layer[kv] = ring
        out[f"layer_{i:02d}"] = layer
    return out


def lm_step_profile(model, params, cache, pos, tok):
    """One decode step under the profiler: (wall ms, device ms, kernel
    launches, device time by kind)."""
    dt, ms, launches = profiled(lambda: model.decode_step(params, cache, tok, pos))
    return dt * 1e3, sum(ms.values()), sum(launches.values()), by_kind(ms)


def phase_lm(dev):
    """Phase 15 (see the module docstring).  Returns the SA kernels'
    launches over the phase (none may launch)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import lm_serve
    from repro_torch.models import transformer
    from repro_torch.models.model import Model, params_from_reference
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.serve.engine import Request, ServeEngine, schedule_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    gib = 2.0 ** 30

    # (a) full width, bf16, through the launcher's path
    cfg = get_arch(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = lm_serve.serve(LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_MAX_SEQ, device=dev,
                         log=lambda m: log(f"phase 15: (a) {m}"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(rep["last"].float()).all() or rep["sample"].shape != (LM_BATCH, LM_GEN):
        raise AssertionError("phase 15: (a) non-finite logits or a short sample")
    model, params, cache, pos = rep["model"], rep["params"], rep["cache"], rep["pos"]
    tok = torch.argmax(rep["last"], dim=-1).to(torch.int32)[:, None]
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    bound_ms = 1e3 * (weight_bytes + cache_bytes) / PEAK_BYTES_PER_S
    step_ms, busy_ms, launches, kinds = lm_step_profile(model, params, cache, pos, tok)
    log(f"phase 15: (a) {LM_ARCH} bf16 {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {model.num_params()} params: prefill "
        f"{LM_BATCH}x{LM_PROMPT} {rep['prefill_s']:.4f} s, decode {LM_GEN} steps "
        f"{rep['decode_s']:.4f} s ({rep['tok_s']:.1f} tok/s batched, "
        f"{1e3 * rep['decode_s'] / LM_GEN:.2f} ms a step), peak {peak / gib:.2f} GiB, "
        f"wall {wall:.1f} s")
    log(f"phase 15: (a) one decode step profiled: wall {step_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / step_ms:.1f} %), {launches} kernel launches; "
        f"byte bound {bound_ms:.3f} ms ({weight_bytes / 1e9:.3f} GB of weights + "
        f"{cache_bytes / 1e9:.3f} GB of cache at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    log(f"  by kind: {kinds}")
    del rep, model, params, cache, pos, tok

    # (b) full width, float32: prefill + decode against the forward; the
    # windowed decode against the full one
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model = Model(cfg32)
    params = model.init(torch.Generator(dev).manual_seed(1), device=dev)
    rng = np.random.default_rng(15)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (LM_CHECK_BATCH, LM_CHECK_LEN + 1)),
                           dtype=torch.int32, device=dev)
    s = LM_CHECK_LEN
    full = model.forward(params, tokens=toks)
    logits, cache = model.prefill(params, tokens=toks[:, :s], max_seq=LM_CHECK_MAX_SEQ)
    errs = {"prefill": lm_close("(b) prefill", logits[:, -1], full[:, s - 1], LM_TOL)}
    del logits
    ring = ring_caches(cfg32, cache, s, LM_CHECK_MAX_SEQ)
    posb = torch.full((LM_CHECK_BATCH,), s, dtype=torch.int32, device=dev)
    ld, _ = model.decode_step(params, cache, toks[:, s:s + 1], posb)
    errs["decode"] = lm_close("(b) decode", ld[:, 0], full[:, s], LM_DECODE_TOL)
    lw, _ = transformer.decode_step_windowed(cfg32, params, ring, toks[:, s:s + 1], posb)
    errs["windowed"] = lm_close("(b) windowed", lw[:, 0], ld[:, 0], LM_DECODE_TOL)
    log(f"phase 15: (b) {LM_ARCH} float32 (TF32 off), {LM_CHECK_BATCH}x{s} prompt past the "
        f"{cfg.attention.sliding_window}-token window: max |err| (logit scale) prefill vs "
        f"forward {errs['prefill'][0]:.3e} ({errs['prefill'][1]:.2f}), decode vs forward "
        f"{errs['decode'][0]:.3e} ({errs['decode'][1]:.2f}), windowed ring vs full cache "
        f"{errs['windowed'][0]:.3e}; tolerances {LM_TOL} / {LM_DECODE_TOL} x scale")
    del full, ld, lw, cache, ring

    # (c) the engine on (b)'s model: each request retires when its lengths
    # say, and its greedy tokens are the teacher-forced forward's argmax
    lo, hi = LM_ENGINE_PROMPTS
    lens = [int(n) for n in rng.integers(lo, hi + 1, LM_ENGINE_REQS)]
    eng = ServeEngine(model, params, batch_slots=LM_ENGINE_SLOTS, max_seq=128, device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                    max_new=LM_ENGINE_NEW) for i, n in enumerate(lens)]
    for r in reqs:
        eng.submit(r)
    retired = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        alive = eng.step()
        retired.update((r.rid, eng.steps) for r in reqs if r.done and r.rid not in retired)
        if not alive and not eng.queue:
            break
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = schedule_steps(lens, [LM_ENGINE_NEW] * LM_ENGINE_REQS, LM_ENGINE_SLOTS)
    if [retired.get(i) for i in range(LM_ENGINE_REQS)] != want:
        raise AssertionError(f"phase 15: (c) retire steps {retired} != {want}")
    worst = 0.0
    for r in reqs:
        seq = torch.as_tensor([r.prompt + r.generated], dtype=torch.int32, device=dev)
        lg = model.forward(params, tokens=seq)[0, len(r.prompt) - 1:-1].double()
        chosen = torch.take_along_dim(
            lg, torch.as_tensor(r.generated, device=dev)[:, None], dim=1)[:, 0]
        gap = float((lg.max(dim=1).values - chosen).max())
        scale = max(1.0, float(lg.abs().max()))
        if len(r.generated) != LM_ENGINE_NEW or gap > LM_DECODE_TOL * scale:
            raise AssertionError(f"phase 15: (c) request {r.rid}: {len(r.generated)} "
                                 f"tokens, chosen logit {gap} below the forward's max")
        worst = max(worst, gap / scale)
    log(f"phase 15: (c) ServeEngine {LM_ARCH} float32: {LM_ENGINE_REQS} requests of "
        f"{lens} prompt tokens over {LM_ENGINE_SLOTS} slots, {LM_ENGINE_NEW} new each: "
        f"{eng.steps} steps in {dt:.3f} s ({1e3 * dt / eng.steps:.2f} ms a step), every "
        f"request retired at the step its lengths fix {want}; every token the forward's "
        f"argmax within {worst:.2e} of the logit scale")
    del model, params, eng

    # (d) the other families, bf16, each drawn directly on the card
    for name in LM_OTHERS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ocfg = get_arch(name)
        model = Model(ocfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        orng = np.random.default_rng(0)
        if ocfg.input_mode == "embeddings":
            inp = {"embeds": torch.as_tensor(
                orng.normal(size=(LM_OTHER_BATCH, LM_OTHER_PROMPT, ocfg.d_model)),
                dtype=torch.bfloat16, device=dev)}
        else:
            inp = {"tokens": torch.as_tensor(
                orng.integers(1, ocfg.vocab_size, (LM_OTHER_BATCH, LM_OTHER_PROMPT)),
                dtype=torch.int32, device=dev)}
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, **inp, max_seq=LM_OTHER_PROMPT + LM_OTHER_GEN)
        last = logits[:, -1]
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        del logits
        posd = torch.full((LM_OTHER_BATCH,), LM_OTHER_PROMPT, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for _ in range(LM_OTHER_GEN):
            nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            ld, cache = model.decode_step(params, cache, nxt, posd)
            last = ld[:, 0]
            finite &= bool(torch.isfinite(last).all())
            posd = posd + 1
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if not finite:
            raise AssertionError(f"phase 15: (d) {name}: non-finite logits")
        log(f"phase 15: (d) {name} bf16 ({model.num_params() / 1e9:.3f} B params, "
            f"{ocfg.input_mode}): init {t_init:.3f} s, prefill {LM_OTHER_BATCH}x"
            f"{LM_OTHER_PROMPT} {t_pre:.4f} s, {LM_OTHER_GEN} decode steps {t_dec:.4f} s "
            f"({LM_OTHER_BATCH * LM_OTHER_GEN / t_dec:.1f} tok/s), peak {peak / gib:.2f} GiB, "
            f"logits finite")
        del model, params, cache, last, ld, inp
    for name, why in LM_LEFT_OUT.items():
        log(f"phase 15: (d) {name} left out: {why}")

    # (e) the tiny configs, float32: the card against the CPU on one set of
    # weights
    torch.cuda.empty_cache()
    worst = {}
    for name in LM_TINY:
        tcfg = dataclasses.replace(get_arch(name), param_dtype="float32",
                                   compute_dtype="float32")
        cpu_model, card_model = Model(tcfg), Model(tcfg)
        cpu = cpu_model.init(torch.Generator().manual_seed(0), device="cpu")
        card = params_from_reference(card_model, tree_map(lambda t: t.numpy(), cpu),
                                     device=dev)
        trng = np.random.default_rng(0)
        toks = trng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
        if tcfg.input_mode == "embeddings":
            inp = {"embeds": trng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)}
        else:
            inp = {"tokens": toks}
        pre = {k: v[:, :8] for k, v in inp.items()}
        errs = []
        for mdl, p in ((cpu_model, cpu), (card_model, card)):
            fw = mdl.forward(p, **inp)
            pl, c = mdl.prefill(p, **pre, max_seq=12)
            dl, _ = mdl.decode_step(p, c, toks[:, 8:9], np.full((2,), 8, np.int32))
            errs.append((fw, pl, dl, mdl.loss(p, {**inp, "labels": toks})[0]))
        (fc, pc, dc, lc), (fg, pg, dg, lg_) = errs
        worst[name] = max(lm_close(f"(e) {name} forward", fg, fc, LM_TOL)[0],
                          lm_close(f"(e) {name} prefill", pg, pc, LM_TOL)[0],
                          lm_close(f"(e) {name} decode", dg, dc, LM_DECODE_TOL)[0],
                          lm_close(f"(e) {name} loss", lg_, lc, LM_TOL)[0])
    log("phase 15: (e) tiny configs float32, card vs CPU on the same weights, max |err| "
        "over forward, prefill, decode and loss: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    launched = launch_counts()
    if any(launched.values()):
        raise AssertionError(f"phase 15: an SA kernel launched: {launched}")
    return {f"lm {LM_ARCH} serve": launched}


# phase 16: LM training on the card.  (a) TRAIN_ARCH at full width in bf16
# through repro_torch.launch.train's path; (b) TRAIN_ARCH in float32 cut to
# one local:global period, one step on the card against the CPU, then two
# microbatches against one; (c) (a)'s state saved and restored; (d) a
# kill-and-resume run of TRAIN_TINY; (e) the tiny configs, card against CPU
TRAIN_ARCH = "gemma3-1b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 8, 512, 1e-3
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_LEN = 6, 2, 600
TRAIN_TINY = "tiny-minicpm"
# float32, TF32 off: the loss within LM_TOL of its scale, grad_norm within
# TRAIN_NORM_TOL, every leaf of the state after a step within TRAIN_STATE_TOL
# (rtol, and atol scaled by max(1, max |reference|)), as the CPU tests hold
# the port to repro; lr within 2 float32 ulps (cos on the card and on the CPU)
TRAIN_NORM_TOL, TRAIN_STATE_TOL, TRAIN_LR_RTOL = 1e-3, 2e-4, 2.4e-7
# a kill-and-resume run's losses against the uninterrupted run's: repro's own
# test's rtol
TRAIN_RESUME_RTOL = 1e-6


def train_moments(state_params, gen):
    """Nonzero AdamW moments (m ~ 0.01 N(0, 1), v ~ 1e-4 U(0, 1) + 1e-5) for
    every leaf, drawn from ``gen`` on the params' device: from zero moments
    the first update is lr * sign(g), and a grad within round-off of zero
    would take another sign on the card than on the CPU."""
    import torch

    from repro_torch.models.params import tensor_map

    def draw(fn):
        return tensor_map(lambda p: fn(p.shape, dtype=torch.float32, device=p.device,
                                       generator=gen), state_params)

    m = tensor_map(lambda t: t.mul_(0.01), draw(torch.randn))
    v = tensor_map(lambda t: t.mul_(1e-4).add_(1e-5), draw(torch.rand))
    return m, v


def train_state(params, gen):
    """A TrainState at step 3 with a float32 master copy and drawn moments."""
    import torch

    from repro_torch.models.params import tensor_leaves, tensor_map
    from repro_torch.train.step import TrainState

    m, v = train_moments(params, gen)
    dev = tensor_leaves(params)[0].device
    return TrainState(params, {
        "step": torch.tensor(3, dtype=torch.int32, device=dev),
        "master": tensor_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": m, "v": v})


def train_close(name, got, want, tol):
    """Max |got - want| over a state tree, leaf by leaf on ``got``'s device
    (want is moved there); raises past rtol = ``tol``, atol = ``tol`` x
    max(1, max |want|) of each leaf."""
    import torch

    from repro_torch.models.params import tensor_leaves

    worst = 0.0
    for i, (g, w) in enumerate(zip(tensor_leaves(got), tensor_leaves(want), strict=True)):
        w = w.to(g.device).double()
        g = g.double()
        scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        err = (g - w).abs()
        if not bool(torch.isfinite(g).all()) or bool((err > tol * (scale + w.abs())).any()):
            raise AssertionError(f"phase 16: {name}: leaf {i} max |err| "
                                 f"{float(err.max())} past {tol} (scale {scale:.3f})")
        worst = max(worst, float(err.max()) / scale if err.numel() else 0.0)
    return worst


def train_metrics_close(name, got, want):
    """Loss, lr and grad_norm of two steps' metrics; returns their errors."""
    errs = {"loss": lm_close(f"{name} loss", got["loss"], want["loss"], LM_TOL)[0],
            "grad_norm": lm_close(f"{name} grad_norm", got["grad_norm"], want["grad_norm"],
                                  TRAIN_NORM_TOL)[0]}
    lr_g, lr_w = float(got["lr"]), float(want["lr"])
    if abs(lr_g - lr_w) > TRAIN_LR_RTOL * abs(lr_w):
        raise AssertionError(f"phase 16: {name}: lr {lr_g} != {lr_w}")
    errs["lr"] = abs(lr_g - lr_w)
    return errs


def layer_params_backward_ms(params, layers, reps=3):
    """CUDA-event time of the autograd of ``transformer.layer_params``'
    per-layer reads ``a[i]`` of every stacked leaf: the select backward
    materialises a full-size grad of each stacked leaf for every layer and
    autograd sums them.  Returns (ms, bytes that work moves: a zero fill, a
    slice copy and an accumulate of the whole leaf a layer)."""
    import torch

    from repro_torch.models.params import tensor_leaves

    live = [t.detach().requires_grad_(True) for t in tensor_leaves(params["blocks"])]
    ones = [torch.ones_like(a[0]) for a in live]

    def once():
        outs = [a[i] for i in range(layers) for a in live]
        torch.autograd.grad(outs, live, grad_outputs=ones * layers)

    ms = time_ms(once, reps)
    nbytes = sum(a.numel() * a.element_size() for a in live)
    return ms, layers * 4 * nbytes


def phase_train(dev):
    """Phase 16 (see the module docstring).  Returns the SA kernels'
    launches over the phase (none may launch)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import ShardingPolicy, TrainConfig, get_arch
    from repro_torch.data.loader import DeterministicLoader
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as lm_train
    from repro_torch.models.model import Model
    from repro_torch.models.params import tensor_leaves, tensor_map
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.sharding.rules import make_mesh
    from repro_torch.train.loop import run_training
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    gib = 2.0 ** 30
    mesh, policy = make_mesh((1, 1), ("data", "model")), ShardingPolicy()

    # (a) full width, bf16, through the launcher's path; the launcher's step
    # is wrapped to time each step (synchronized) and keep the last state
    cfg = get_arch(TRAIN_ARCH)
    real_make = lm_train.make_train_step
    rec = {"walls": []}

    def timed_make(*a, **kw):
        step, ssh, bsh = real_make(*a, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec.update(step=step, state=out[0], batch=batch)
            return out

        return run, ssh, bsh

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_train.make_train_step = timed_make
    t0 = time.perf_counter()
    try:
        res, model = lm_train.train(TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                    seq=TRAIN_SEQ, lr=TRAIN_LR, schedule="cosine", device=dev,
                                    log=lambda m: log(f"phase 16: (a) {m}"))
    finally:
        lm_train.make_train_step = real_make
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    if not (np.isfinite(losses).all() and len(losses) == TRAIN_STEPS and losses[-1] < losses[0]):
        raise AssertionError(f"phase 16: (a) losses {losses} not finite and falling")
    step_s = float(np.median(rec["walls"][1:]))
    tok = TRAIN_BATCH * TRAIN_SEQ
    state, batch, step = rec["state"], rec["batch"], rec["step"]
    state_bytes = sum(t.numel() * t.element_size() for t in tensor_leaves(state))
    log(f"phase 16: (a) {TRAIN_ARCH} bf16 {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {model.num_params()} params, {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}: losses {[round(x, 4) for x in losses]}; step walls "
        f"{[round(x, 4) for x in rec['walls']]} s, median past the first {step_s:.4f} s "
        f"({tok / step_s:.0f} tokens/s); peak {peak / gib:.2f} GiB (state "
        f"{state_bytes / 1e9:.3f} GB, no remat); wall {wall:.1f} s")
    dt, ms, launches = profiled(lambda: step(state, batch))
    busy = sum(ms.values())
    log(f"phase 16: (a) one train step profiled: wall {dt * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / (dt * 1e3):.1f} %), {sum(launches.values())} kernel "
        f"launches")
    log(f"  by kind: {by_kind(ms)}")
    for key, t in sorted(ms.items(), key=lambda x: -x[1])[:6]:
        log(f"  {t:9.2f} ms  {key[:100]}")
    sel_ms, sel_bytes = layer_params_backward_ms(state.params, cfg.num_layers)
    log(f"phase 16: (a) layer_params' select backward over the stacked leaves: "
        f"{sel_ms:.3f} ms a step ({sel_bytes / 1e9:.2f} GB moved, byte bound "
        f"{1e3 * sel_bytes / PEAK_BYTES_PER_S:.3f} ms)")
    tcfg_a = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1, decay_steps=TRAIN_STEPS)
    with torch.no_grad():
        opt_ms = time_ms(lambda: adamw_update(tcfg_a, state.params, state.params, state.opt), 3)
    # each param: its grad (bf16) and m, v, master read, m, v, master and the
    # bf16 param written
    opt_bytes = sum(t.numel() for t in tensor_leaves(state.params)) * (2 + 12 + 12 + 2)
    log(f"phase 16: (a) adamw_update alone on (a)'s state: {opt_ms:.3f} ms a step (byte "
        f"bound {1e3 * opt_bytes / PEAK_BYTES_PER_S:.3f} ms for {opt_bytes / 1e9:.2f} GB)")

    # (c) (a)'s state saved and restored onto the card, bit for bit
    need = state_bytes * 1.1
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)  # in the checkout: 14 GB
    ckpt_root = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(HERE, "build"))
    try:
        free = shutil.disk_usage(ckpt_root).free
        if free < need:
            raise AssertionError(f"phase 16: (c) {free / 1e9:.1f} GB free under {ckpt_root}, "
                                 f"{need / 1e9:.1f} GB needed")
        mgr = CheckpointManager(ckpt_root, keep=1)
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, state, extra={"step": TRAIN_STEPS}, blocking=True)
        t_save = time.perf_counter() - t0
        on_disk = dir_bytes(os.path.join(ckpt_root, f"step_{TRAIN_STEPS:08d}"))
        target = tensor_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
        t0 = time.perf_counter()
        back, extra = mgr.restore(target, device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        for i, (g, w) in enumerate(zip(tensor_leaves(back), tensor_leaves(state), strict=True)):
            bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(w.dtype)
            same = torch.equal(g.view(bits), w.view(bits)) if bits else torch.equal(g, w)
            if not same or g.device != w.device or g.dtype != w.dtype:
                raise AssertionError(f"phase 16: (c) leaf {i} differs after restore")
        if extra != {"step": TRAIN_STEPS}:
            raise AssertionError(f"phase 16: (c) extra {extra}")
        log(f"phase 16: (c) CheckpointManager save (blocking) of (a)'s state, "
            f"{len(tensor_leaves(state))} leaves: {on_disk / 1e9:.3f} GB on disk in "
            f"{t_save:.2f} s ({on_disk / t_save / 1e9:.2f} GB/s); restore onto the card "
            f"{t_restore:.2f} s ({on_disk / t_restore / 1e9:.2f} GB/s, warm page cache); "
            f"every leaf bit-equal ({free / 1e9:.0f} GB were free)")
        del back
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    del res, model, state, batch, step, rec
    torch.cuda.empty_cache()

    # (b) float32 at full width, one local:global period: a step on the card
    # against the CPU from one state and batch; then two microbatches
    cfg32 = dataclasses.replace(cfg, num_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    card_model, cpu_model = Model(cfg32), Model(cfg32)
    gen = torch.Generator(dev).manual_seed(16)
    state = train_state(card_model.init(torch.Generator(dev).manual_seed(1), device=dev), gen)
    cpu_state = tensor_map(lambda t: t.cpu(), state)
    rng = np.random.default_rng(16)
    shape = (TRAIN_CHECK_BATCH, TRAIN_CHECK_LEN)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, shape).astype(np.int32),
             "labels": rng.integers(1, cfg.vocab_size, shape).astype(np.int32)}
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=20)

    def one_step(mdl, st, tc):
        fn = make_train_step(mdl, mesh, policy, tc, TRAIN_CHECK_BATCH, TRAIN_CHECK_LEN,
                             donate=False)[0]
        t0 = time.perf_counter()
        out = fn(st, batch)
        if st.opt["step"].is_cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (new_card, met_card), t_card = one_step(card_model, state, tcfg)
    (new_cpu, met_cpu), t_cpu = one_step(cpu_model, cpu_state, tcfg)
    errs = train_metrics_close("(b) card vs CPU", met_card, met_cpu)
    errs["state"] = train_close("(b) card vs CPU", new_card, new_cpu, TRAIN_STATE_TOL)
    del new_cpu, cpu_state
    (new_mb, met_mb), t_mb = one_step(card_model, state,
                                      dataclasses.replace(tcfg, microbatches=2))
    errs_mb = train_metrics_close("(b) microbatches 2 vs 1", met_mb, met_card)
    errs_mb["state"] = train_close("(b) microbatches 2 vs 1", new_mb, new_card, TRAIN_STATE_TOL)
    log(f"phase 16: (b) {TRAIN_ARCH} float32 (TF32 off), {TRAIN_CHECK_LAYERS} layers "
        f"({card_model.num_params()} params), one step of {TRAIN_CHECK_BATCH}x"
        f"{TRAIN_CHECK_LEN} tokens past the {cfg.attention.sliding_window}-token window "
        f"from one state (moments drawn, step 3): card {t_card:.3f} s, CPU {t_cpu:.3f} s; "
        f"loss {float(met_card['loss']):.6f} (|err| {errs['loss']:.3e}), grad_norm "
        f"{float(met_card['grad_norm']):.6f} (|err| {errs['grad_norm']:.3e}), lr |err| "
        f"{errs['lr']:.3e}, every leaf of the new state within {errs['state']:.3e} of its "
        f"scale; microbatches=2 against 1 on the card ({t_mb:.3f} s): loss |err| "
        f"{errs_mb['loss']:.3e}, grad_norm {errs_mb['grad_norm']:.3e}, state "
        f"{errs_mb['state']:.3e}; tolerances {LM_TOL} / {TRAIN_NORM_TOL} / {TRAIN_STATE_TOL}")
    del state, new_card, new_mb, card_model, cpu_model
    torch.cuda.empty_cache()

    # (d) kill and resume on the card: faults retried, a preemption's final
    # checkpoint, the resumed run's losses the uninterrupted run's
    tiny = dataclasses.replace(get_arch(TRAIN_TINY), param_dtype="float32",
                               compute_dtype="float32")
    tmodel = Model(tiny)
    ttc = TrainConfig(learning_rate=1e-5, warmup_steps=2, decay_steps=50)
    tstep = make_train_step(tmodel, mesh, policy, ttc, 4, 16, donate=False)[0]
    toks = (np.arange(1, 20_001) * 7 % (tiny.vocab_size - 1) + 1).astype(np.int32)
    loader = DeterministicLoader(toks, batch=4, seq_len=16, seed=3)
    t0 = time.perf_counter()
    full = run_training(tmodel, tstep, loader, ttc, steps=10, seed=5, device=dev)
    with tempfile.TemporaryDirectory() as d:
        fault = FaultInjector(fail_steps=[3, 7], max_failures_per_step=2)
        part = run_training(tmodel, tstep, loader, ttc, steps=10, ckpt_dir=d, ckpt_every=3,
                            preempt_at=6, fault=fault, seed=5, device=dev)
        resumed = run_training(tmodel, tstep, loader, ttc, steps=10, ckpt_dir=d,
                               resume=True, ckpt_every=100, fault=fault, seed=5, device=dev)
    t_d = time.perf_counter() - t0
    if (part.final_step, resumed.restored_from, resumed.final_step) != (6, 6, 10) or \
            (part.retries, resumed.retries, fault.injected) != (2, 2, 4):
        raise AssertionError(f"phase 16: (d) steps {part.final_step}/{resumed.restored_from}/"
                             f"{resumed.final_step}, retries {part.retries}/{resumed.retries}"
                             f"/{fault.injected}")
    np.testing.assert_allclose(part.losses + resumed.losses, full.losses,
                               rtol=TRAIN_RESUME_RTOL)
    err_d = max(abs(a - b) / abs(b) for a, b in zip(part.losses + resumed.losses, full.losses,
                                                      strict=True))
    log(f"phase 16: (d) {TRAIN_TINY} float32 on the card, 10 steps: preempted at step 6 "
        f"with faults at steps 3 and 7 (twice each), resumed from step 6: losses equal to "
        f"the uninterrupted run's within {err_d:.2e} (rtol {TRAIN_RESUME_RTOL}), "
        f"{part.retries} + {resumed.retries} retries of {fault.injected} faults; "
        f"{t_d:.2f} s for the three runs")

    # (e) the tiny configs, float32: one step, the card against the CPU
    worst = {}
    for name in LM_TINY:
        tcfg_e = dataclasses.replace(get_arch(name), param_dtype="float32",
                                     compute_dtype="float32")
        cpu_model, card_model = Model(tcfg_e), Model(tcfg_e)
        cpu = train_state(cpu_model.init(torch.Generator().manual_seed(0), device="cpu"),
                          torch.Generator().manual_seed(1))
        card = tensor_map(lambda t: t.to(dev), cpu)
        trng = np.random.default_rng(0)
        b = {"labels": trng.integers(0, tcfg_e.vocab_size, (2, 16)).astype(np.int32)}
        if tcfg_e.input_mode == "embeddings":
            b["embeds"] = trng.normal(size=(2, 16, tcfg_e.d_model)).astype(np.float32)
        else:
            b["tokens"] = trng.integers(0, tcfg_e.vocab_size, (2, 16)).astype(np.int32)
        outs = []
        for mdl, st in ((cpu_model, cpu), (card_model, card)):
            fn = make_train_step(mdl, mesh, policy, tcfg, 2, 16, donate=False)[0]
            outs.append(fn(st, b))
        (nc, mc), (ng, mg) = outs
        e = train_metrics_close(f"(e) {name}", mg, mc)
        worst[name] = max(e["loss"], train_close(f"(e) {name}", ng, nc, TRAIN_STATE_TOL))
    log("phase 16: (e) tiny configs float32, one train step, card vs CPU from one state, "
        "max |err| over the loss and every leaf of the new state (of its scale): "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    launched = launch_counts()
    if any(launched.values()):
        raise AssertionError(f"phase 16: an SA kernel launched: {launched}")
    return {f"lm {TRAIN_ARCH} train": launched}


AB_BUILD = ("-m", "repro_torch.launch.sa_build", "--reads", str(OOC_READS),
            "--read-len", str(FULL_READ_LEN), "--superblocks", str(OOC_SUPERBLOCKS))


def merge_ab(parent, pairs):
    """Phase 8's reads cell (no LCP) through ``repro_torch.launch.sa_build``,
    from the checkout at ``parent`` and from this one, in turns (parent,
    change, change, parent, ...), ``pairs`` runs of each, each tree's
    kernels built first: every run's wall and ``t_merge_s``, each tree's
    median and quartiles, and the pairs the change wins."""
    import re
    import statistics

    trees = {"parent": os.path.abspath(parent), "change": HERE}

    def run(tree, *args):
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[tree], "src"))
        return subprocess.run([sys.executable, *args], cwd=trees[tree], env=env,
                              capture_output=True, text=True, check=True).stdout

    run("parent", "-c", "from repro_torch.kernels import _build; _build.build()")
    walls = {tree: [] for tree in trees}
    for i in range(pairs):
        for tree in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
            out = run(tree, *AB_BUILD)
            wall = float(re.search(r" time=([0-9.]+)s", out).group(1))
            merge = float(re.search(r"'t_merge_s': ([0-9.]+)", out).group(1))
            walls[tree].append((wall, merge))
            log(f"merge A/B: run {i} {tree}: wall {wall:.2f} s, t_merge_s {merge:.2f}")
    for j, what in enumerate(("wall", "t_merge_s")):
        for tree, runs in walls.items():
            q1, q2, q3 = statistics.quantiles([r[j] for r in runs], n=4)
            log(f"merge A/B: {tree} {what} over {len(runs)} runs: median "
                f"{q2:.3f} s, quartiles {q1:.3f} / {q3:.3f} s")
        wins = sum(c[j] < p[j] for p, c in zip(walls["parent"], walls["change"]))
        log(f"merge A/B: the change's {what} is lower in {wins} of {pairs} pairs")


def gather_ab(parent, rounds):
    """window_gather against the parent tree's kernel, in one call, on the
    full reads corpus at M = 2^22 and 2^14 (k = 26): this tree's kernel as
    built, and the kernel of the checkout at ``parent``, built beside it.
    Each is held to the plain version, then both are timed in turns
    (parent, change, change, parent, ...), ``rounds`` times, through their
    ctypes calls; at 2^14 the profiler also gives each one's device time a
    launch.  Then pattern_cmp's ms a call with ``_build.launcher``'s cache
    and without it, in turns."""
    import ctypes
    import statistics

    import torch

    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.kernels import _build
    from repro_torch.kernels import window_gather as wg_mod

    lib = _build.BUILD_DIR / "parent" / "libwindow_gather.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    os.path.join(parent, "src/repro_torch/kernels/csrc/window_gather.cu")],
                   check=True, capture_output=True, text=True)
    parent_fn = ctypes.CDLL(str(lib)).window_gather_launch
    # the parent's launcher takes no vector-path flag
    parent_fn.argtypes = [a for i, a in enumerate(wg_mod._ARGTYPES) if i != 8]
    parent_fn.restype = ctypes.c_int
    fns = {"parent": parent_fn,
           "change": _build.launcher("window_gather", "window_gather_launch",
                                     wg_mod._ARGTYPES)}

    def gather_with(name):
        """A ctypes call of the tree's launcher, the same host path for both
        but the change's vector-path flag."""
        def gather(corpus, rows, offs, k):
            (r, l), m = corpus.shape, rows.shape[0]
            out = torch.empty((m, k), dtype=torch.int32, device=corpus.device)
            flag = [] if name == "parent" else [int(wg_mod._vector_path(corpus))]
            err = fns[name](corpus.data_ptr(), rows.data_ptr(), offs.data_ptr(),
                            out.data_ptr(), m, k, r, l, *flag,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"window_gather {name}: cudaError {err}")
            return out
        return gather

    gathers = {name: gather_with(name) for name in fns}

    corpus = torch.from_numpy(synth_dna_reads(FULL_READS, FULL_READ_LEN, seed=0)).cuda()
    k = 26
    for m in (GATHER_M, GATHER_SMALL_M):
        times = {name: [] for name in gathers}
        for i in range(rounds):
            for name in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
                o = gather_timing(gathers[name], corpus, k, m)
                times[name].append(o["ms"])
        log(f"gather A/B: M={m}, k={k}, corpus {tuple(corpus.shape)}, bound "
            f"{o['bound_ms']:.4f} ms ({o['bound_by']}); both == plain")
        rows, offs = gather_requests(*corpus.shape, m, corpus.device)
        for name, ts in times.items():
            device = ""
            if m == GATHER_SMALL_M:
                gather = gathers[name]
                launch_ms = device_ms(lambda: gather(corpus, rows, offs, k),
                                      "window_gather")
                device = f"; device {launch_ms:.4f} ms a launch"
            log(f"gather A/B: M={m} {name}: median {statistics.median(ts):.4f} ms, "
                f"min {min(ts):.4f}, max {max(ts):.4f} over {len(ts)} "
                f"({', '.join(f'{t:.4f}' for t in ts)}){device}")
        wins = sum(c < p for p, c in zip(times["parent"], times["change"], strict=True))
        log(f"gather A/B: M={m}: the change faster in {wins} of {rounds} pairs")
    del corpus
    torch.cuda.empty_cache()

    # pattern_cmp's CUDA-event ms a call through its wrapper, host launch
    # path included, with the launcher's cache of configured functions and
    # without it (emptied before every launch, as when each launch looked
    # the symbol up and set its argtypes), in turns
    from repro_torch.kernels import cases
    from repro_torch.kernels import pattern_cmp as pc_mod

    args = [torch.from_numpy(a).cuda() for a in cases.cmp_inputs(QUERY_BATCH, k)]
    cached = _build.launcher

    def uncached(*a):
        _build._FUNCS.clear()
        return cached(*a)

    pcmp = {"cached": [], "uncached": []}
    try:
        for i in range(2 * rounds):
            for name in ("cached", "uncached") if i % 2 == 0 else ("uncached", "cached"):
                _build.launcher = cached if name == "cached" else uncached
                pcmp[name].append(time_ms(lambda: pc_mod.pattern_cmp(*args), 200))
    finally:
        _build.launcher = cached
    for name, ts in pcmp.items():
        log(f"pattern_cmp A/B: launcher {name}: median {statistics.median(ts):.4f} ms a "
            f"call (B={QUERY_BATCH}, K={k}, 200 calls a run), min {min(ts):.4f}, max "
            f"{max(ts):.4f} over {len(ts)} ({', '.join(f'{t:.4f}' for t in ts)})")
    wins = sum(c < u for c, u in zip(pcmp["cached"], pcmp["uncached"], strict=True))
    log(f"pattern_cmp A/B: cached faster in {wins} of {2 * rounds} pairs")


def main(argv) -> int:
    """No arguments: every phase.  ``--stream-reads N [N ...]``: phases 1-2
    and then only phase 9's streaming build, once for each read count (a
    scaling run).  ``--merge-ab PARENT PAIRS``: phases 1-2 and then
    ``merge_ab``; ``--gather-ab PARENT ROUNDS``: phases 1-2 and then
    ``gather_ab``; ``--merges READS LOG2``: phases 1-2 and then phase 10 at
    READS reads and a 2^LOG2-token text; ``--resume READS LOG2`` and
    ``--build-modes READS LOG2``: phases 1-2 and then phase 11 or 12 at
    those sizes; ``--ranks READS LOG2 D``: phases 1-2 and then phase 13 at
    those sizes on D ranks; ``--ranks-ooc READS D``: phases 1-2 and then
    phase 14 at READS reads on D ranks; ``--lm``: phases 1-2 and then
    phase 15; ``--train``: phases 1-2 and then phase 16; ``--nccl``: phases 1-2 and then ``phase_nccl`` on four cards.
    None of these prints a result line (``--nccl-rank`` is one rank of
    ``--nccl``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
    from repro_torch.kernels import _build

    if argv[:1] == ["--nccl-rank"] and len(argv) == 2:
        return nccl_rank(argv[1])  # one rank of --nccl, under torchrun

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"phase 2: built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if argv[:1] == ["--stream-reads"]:
        for reads in map(int, argv[1:]):
            phase_streaming(dev, None, reads)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--merge-ab"] and len(argv) == 3:
        merge_ab(argv[1], int(argv[2]))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--gather-ab"] and len(argv) == 3:
        gather_ab(argv[1], int(argv[2]))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--merges"] and len(argv) == 3:
        t0 = time.perf_counter()
        phase_merges(dev, int(argv[1]), int(argv[2]))
        log(f"phase 10: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--resume"] and len(argv) == 3:
        t0 = time.perf_counter()
        reads = synth_dna_reads(int(argv[1]), FULL_READ_LEN, seed=0)
        text = synth_token_corpus(1 << int(argv[2]), 4, seed=0)[0]
        phase_resume(unjournaled_cell(f"reads {argv[1]} x 200 out-of-core", reads),
                     unjournaled_cell(f"text 2^{argv[2]} out-of-core", text))
        log(f"phase 11: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--build-modes"] and len(argv) == 3:
        reads = synth_dna_reads(int(argv[1]), FULL_READ_LEN, seed=0)
        text = synth_token_corpus(1 << int(argv[2]), 4, seed=0)[0]
        sas, fps = scheme_references([(READS_BUILD, reads), (TEXT_BUILD, text)])
        t0 = time.perf_counter()
        phase_build_modes(dev, reads, text, sas, fps)
        log(f"phase 12: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--ranks-ooc"] and len(argv) == 3:
        t0 = time.perf_counter()
        phase_ranks_ooc(dev, int(argv[1]), int(argv[2]))
        log(f"phase 14: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv == ["--nccl"]:
        phase_nccl(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv == ["--lm"]:
        t0 = time.perf_counter()
        phase_lm(dev)
        log(f"phase 15: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv == ["--train"]:
        t0 = time.perf_counter()
        phase_train(dev)
        log(f"phase 16: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv[:1] == ["--ranks"] and len(argv) == 4:
        t0 = time.perf_counter()
        phase_ranks(dev, int(argv[1]), int(argv[2]), int(argv[3]))
        log(f"phase 13: {time.perf_counter() - t0:.1f} s")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    reads_corpus = synth_dna_reads(FULL_READS, FULL_READ_LEN, seed=0)
    text_tokens, _ = synth_token_corpus(FULL_TEXT, 4, seed=0)
    log(f"corpora synthesized in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kern = phase_kernels(dev, reads_corpus, text_tokens)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_small_builds(dev)
    phase_small_indexes(dev)
    phase_small_out_of_core(dev)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, incore_sa, scheme_fp = phase_full_builds(dev, reads_corpus, text_tokens)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_profile([(READS_BUILD, reads_corpus), (TEXT_BUILD, text_tokens)])
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    query_counts, query_report, incore_lcp, reads_index = phase_queries(
        dev, reads_corpus, text_tokens)
    kern["pattern_search"] = query_report[READS_QUERY]["search"]
    counts.update(query_counts)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(phase_reopen(dev, reads_index))
    del reads_index
    log(f"phase 9 (reopen): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ooc_counts, ooc_report, tiles, ooc_ref = phase_out_of_core(
        dev, reads_corpus, text_tokens, incore_sa, incore_lcp)
    counts.update(ooc_counts)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(phase_streaming(dev, ooc_ref[READS_OOC]))
    log(f"phase 9 (streaming): {time.perf_counter() - t0:.1f} s")
    kern["merge_path"] = tiles["largest"]
    t0 = time.perf_counter()
    counts.update(phase_merges(dev))
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r = ooc_report[(TEXT_OOC, "kernels")]
    text_cell = (TEXT_OOC, ooc_ref[TEXT_OOC][0],
                 (*ooc_ref[TEXT_OOC][1:], r["footprint"], r["stats"]), r["wall_s"])
    reads_cell = unjournaled_cell(f"reads {RESUME_READS // 1000}K x 200 out-of-core",
                                  synth_dna_reads(RESUME_READS, FULL_READ_LEN, seed=0))
    counts.update(phase_resume(reads_cell, text_cell))
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(phase_build_modes(dev, reads_corpus, text_tokens, incore_sa, scheme_fp))
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    del reads_corpus, text_tokens, incore_sa, incore_lcp, reads_cell, text_cell
    t0 = time.perf_counter()
    counts.update(phase_ranks(dev))
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(phase_ranks_ooc(dev, OOC_RANKS_READS, ref=ooc_ref[READS_OOC]))
    del ooc_ref
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(phase_lm(dev))
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(phase_train(dev))
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")

    sources = {
        "prefix_pack": ("src/repro_torch/kernels/csrc/prefix_pack.cu",
                        "src/repro/kernels/prefix_pack.py:46"),
        "window_gather": ("src/repro_torch/kernels/csrc/window_gather.cu",
                          "src/repro/kernels/window_gather.py:33"),
        "pattern_cmp": ("src/repro_torch/kernels/csrc/pattern_cmp.cu",
                        "src/repro/kernels/pattern_cmp.py:59"),
        "pattern_search": ("src/repro_torch/kernels/csrc/pattern_cmp.cu",
                           "src/repro/kernels/pattern_cmp.py:59"),
        "merge_path": ("src/repro_torch/kernels/csrc/merge_path.cu",
                       "src/repro/kernels/merge_path.py:52"),
        "bucket_hist": ("src/repro_torch/kernels/csrc/bucket_hist.cu",
                        "src/repro/kernels/bucket_hist.py:38"),
        "bitonic_sort": ("src/repro_torch/kernels/csrc/bitonic_sort.cu",
                         "src/repro/kernels/bitonic_sort.py:74"),
    }
    # no path of src/repro runs it: its launches are the sum over every
    # main-path run, which must be 0
    no_path = {"bitonic_sort": "no path of src/repro runs it; held to its plain "
                               "version in phase 3 only"}
    launches = {k: (sum(c[k] for c in counts.values()) if k in no_path
                    else counts[KERNEL_BUILD[k]][k]) for k in sources}
    for k in sources:
        if k in no_path and launches[k]:
            raise AssertionError(f"{k} launched {launches[k]} times on the main "
                                 f"paths, which no path of src/repro does")
        if k not in no_path and launches[k] <= 0:
            raise AssertionError(f"{k} was not launched in the {KERNEL_BUILD[k]} run")
    log("kernels: " + "; ".join(
        (f"{k} launches={launches[k]} over all {len(counts)} runs ({no_path[k]})"
         if k in no_path else
         f"{k} launches={launches[k]} in the {KERNEL_BUILD[k]} run "
         f"(by run: {', '.join(f'{b} {c[k]}' for b, c in counts.items())})")
        + f" equal=True max_abs_err={kern[k]['max_abs_err']}" for k in sources))
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k],
         "max_abs_err": kern[k]["max_abs_err"],
         "ms": kern[k]["ms"], "plain_ms": kern[k]["plain_ms"],
         "bound_ms": kern[k]["bound_ms"], "bound_by": kern[k]["bound_by"],
         "library_ms": kern[k].get("library_ms"),
         **({"library": kern[k]["library"]} if "library" in kern[k] else {}),
         **{x: kern[k][x] for x in ("cuda_launches", "tiles", "d512") if x in kern[k]},
         **({"note": no_path[k]} if k in no_path else {})}
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
