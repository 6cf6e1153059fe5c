#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases,
each of which fails loudly:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel to its plain PyTorch version on the card with
   ``torch.equal``, at the kernel-test shapes (``pattern_cmp``'s edge rows
   included) and at the full-size shapes of phases 5 and 7, and time both;
4. small end-to-end builds on the card (kernels on) against the numpy oracle,
   and small ``SuffixArrayIndex`` builds whose count/locate/align answers
   are held to brute force;
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
   ``engine_stats()``; ``pattern_cmp`` must launch on the kernel engine and
   not on the plain one; every range is checked at its edges against the
   tokens, and 2^20 sampled LCP values against a direct compare;
8. the out-of-core build: the 2^26-token text of phase 5 and its reads cut
   to ``OOC_READS`` reads (same read length, alphabet and seed), with
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
   plain ranks and timed.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.
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
PAIR_SAMPLES = 1 << 20
READS_BUILD, TEXT_BUILD = "reads 1M x 200", "text 2^26"
READS_QUERY, TEXT_QUERY = "reads query", "text query"
# phase 8's reads cell: the corpus of phase 5 cut to OOC_READS reads (same
# read length, alphabet and seed) so three builds fit the time limit (the
# wall that forced the cut is in PERF.md); its profiled build is smaller
# still, since the profiler's bookkeeping grows with the merge's op count
OOC_READS = 125_000
OOC_PROFILE_READS = 5_000
READS_OOC = f"reads {OOC_READS // 1000}K x 200 out-of-core"
TEXT_OOC = "text 2^26 out-of-core"
# the full-size run whose main path each kernel lies on
KERNEL_BUILD = {"prefix_pack": TEXT_BUILD, "window_gather": READS_BUILD,
                "pattern_cmp": READS_QUERY, "merge_path": READS_OOC}
# phase 8: superblocks of the out-of-core cells; full-size merge tiles of
# phase 3 (C = 4 runs x 4096 heads)
OOC_SUPERBLOCKS = 4
MERGE_C = 4 * 4096
# phase 7: (seeds, seed length) per index, sent as count batches of QUERY_BATCH
QUERY_BATCH = 4096
QUERIES = {READS_QUERY: (1 << 16, 24), TEXT_QUERY: (1 << 14, 16)}
HOT_FRACTION = 0.25


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
    for r, l, m, k in cases.GATHER_SHAPES:
        args = [torch.from_numpy(a).to(dev) for a in cases.gather_inputs(r, l, m)]
        check_equal(f"window_gather r={r} l={l} m={m} k={k}",
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
    for name, keys, block in merge_cases:
        keys = torch.from_numpy(keys).to(dev)
        check_equal(f"merge_path_ranks {name}",
                    mp_mod.merge_path_ranks(keys, block=block),
                    ref.merge_path_ranks_ref(keys))
    log("phase 3: kernels == plain versions at the tests/test_kernels.py shapes "
        "and the edge rows of pattern_cmp and merge_path_ranks")

    out = {}
    # prefix_pack at the text Map's shape: the 2^26 tokens plus the K-token halo
    cfg = make_config("base", "cuda")
    k = cfg.prefix_len
    flat = torch.from_numpy(np.concatenate(
        [text_tokens, np.zeros(k, np.int32)])).to(dev)
    got = pp_mod.prefix_pack(flat, cfg)
    want = ref.prefix_pack_ref(flat, cfg)
    check_equal("prefix_pack full size", got, want)
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

    # window_gather at the refinement fetch's chunk: 2^22 requests, k = 26,
    # on the full-size 1 M x 200 corpus (rows/offsets incl. out-of-range)
    corpus = torch.from_numpy(reads_corpus).to(dev)
    r, l = corpus.shape
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.integers(-1, r + 1, size=(GATHER_M,)).astype(np.int32)).to(dev)
    offs = torch.from_numpy(rng.integers(0, l + 2, size=(GATHER_M,)).astype(np.int32)).to(dev)
    got = wg_mod.window_gather(corpus, rows, offs, k)
    want = ref.window_gather_ref(corpus, rows, offs, k)
    check_equal("window_gather full size", got, want)
    valid = (rows >= 0) & (rows < r)
    tokens_read = int(torch.where(
        valid, (l - offs.clamp(0, l)).clamp(max=k), 0).sum())
    # bytes: the two index arrays, the corpus tokens these requests really
    # read, the windows written; no arithmetic beyond the indexing
    bound_ms, bound_by = byte_or_op_bound(
        8 * GATHER_M + 4 * min(tokens_read, r * l) + 4 * GATHER_M * k, 0)
    out["window_gather"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: wg_mod.window_gather(corpus, rows, offs, k), 20),
        plain_ms=time_ms(lambda: ref.window_gather_ref(corpus, rows, offs, k), 3),
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f"M={GATHER_M}, k={k}, corpus {r}x{l}",
    )
    del got, want, corpus, rows, offs

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
    _, dev_ms, launches = profiled(lambda: [pc_mod.pattern_cmp(*args) for _ in range(200)])
    key = next(key for key in dev_ms if "pattern_cmp" in key)
    log(f"phase 3: pattern_cmp B={b}: device time {dev_ms[key] / launches[key]:.4f} ms "
        f"a launch (profiler, {launches[key]} launches); CUDA events "
        f"{out['pattern_cmp']['ms']:.4f} ms a call, host launch path included")
    # merge_path_ranks at the merge's full tile, C = 4 x 4096: four words (the
    # depth-0 key words and the index words) and the widest row a reads
    # merge can build (every window level, the tie column, the index words)
    wide = (-(-(FULL_READ_LEN + 1) // k) + 2) * cfg.key_words + 3
    for w in (4, wide):
        keys = torch.from_numpy(merge_tile_keys(MERGE_C, w)).to(dev)
        got = mp_mod.merge_path_ranks(keys)
        check_equal(f"merge_path_ranks C={MERGE_C} W={w}", got,
                    ref.merge_path_ranks_ref(keys))
        m = merge_path_timing(keys)
        log(f"phase 3: merge_path_ranks synthetic tile C={MERGE_C} W={w}: kernel "
            f"{m['ms']:.4f} ms (device {m['device_ms']:.4f} ms a launch), plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
    for name, o in out.items():
        log(f"phase 3: {name} full size ({o['shape']}): kernel {o['ms']:.4f} ms, "
            f"plain {o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}), "
            f"max|err| {o['max_abs_err']}")
    return out


def merge_tile_keys(c, w):
    """A synthetic merge tile of ``c`` rows and ``w`` words: about 16 rows
    share each leading word and the next words tie often, as neighbouring
    suffixes of a real tile do; the last two are the index words (unique).
    Seeded by ``c + w``."""
    import numpy as np

    rng = np.random.default_rng(c + w)
    keys = np.zeros((c, w), np.int32)
    keys[:, 0] = rng.integers(0, max(1, c // 16), size=c)  # ~16 rows a value
    keys[:, 1 : w - 2] = rng.integers(0, 3, size=(c, w - 3))
    keys[:, w - 1] = rng.permutation(c)  # index words: hi 0, lo unique
    return keys


def merge_path_bound(c, w):
    """(bound ms, by): C·W·4 bytes read and C·4 written against 2·C² int32
    operations (every pair is compared on word 0)."""
    return byte_or_op_bound(4 * c * w + 4 * c, 2 * c * c)


def merge_path_timing(keys, device_time=True):
    """Kernel (CUDA events and, with ``device_time``, the profiler's device
    time) and plain times of ``merge_path_ranks`` on ``keys``, with its
    bound."""
    from repro_torch.kernels import merge_path as mp_mod
    from repro_torch.kernels import ref

    c, w = keys.shape
    bound_ms, bound_by = merge_path_bound(c, w)
    out = dict(ms=time_ms(lambda: mp_mod.merge_path_ranks(keys), 20),
               plain_ms=time_ms(lambda: ref.merge_path_ranks_ref(keys), 3),
               bound_ms=bound_ms, bound_by=bound_by)
    if device_time:
        _, dev_ms, launches = profiled(
            lambda: [mp_mod.merge_path_ranks(keys) for _ in range(20)])
        key = next(key for key in dev_ms if "merge_path" in key)
        out["device_ms"] = dev_ms[key] / launches[key]
    return out


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
        if launched["pattern_cmp"] <= 0:
            raise AssertionError(f"phase 4: {name}: pattern_cmp not launched: {launched}")
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
    return counts, {name: results[(name, True)].suffix_array for name, _ in builds}


KERNEL_CLASSES = (  # substring of a kernel's name -> what it belongs to
    ("prefix_pack", "prefix_pack"), ("window_gather", "window_gather"),
    ("pattern_cmp", "pattern_cmp"), ("merge_path", "merge_path"),
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


def by_kind(ms):
    out = {}
    for key, t in ms.items():
        cls = next((c for sub, c in KERNEL_CLASSES if sub in key), "elementwise")
        out[cls] = out.get(cls, 0.0) + t
    return ", ".join(f"{c} {t:.1f} ms" for c, t in sorted(out.items(), key=lambda x: -x[1]))


def phase_profile(builds):
    """Where one kernel-path build of each cell spends its device time."""
    import torch

    from repro_torch.launch import sa_build

    for name, corpus in builds:
        cfg = sa_build.make_config("base", "cuda")
        torch.cuda.empty_cache()
        dt, ms, _ = profiled(lambda c=corpus, g=cfg: sa_build.run(c, g, "cuda"))
        busy = sum(ms.values())
        log(f"phase 6: {name} profiled: wall {dt * 1e3:.1f} ms, device busy "
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

    counts, report, lcps = {}, {}, {}
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
        if launched["pattern_cmp"] <= 0:
            raise AssertionError(f"{name}: pattern_cmp not launched: {launched}")

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
            p95_ms=float(np.percentile(lat_ms, 95)), peak_gib=peak / 2**30)
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
        log(f"phase 7: {name}: one more batch profiled: wall {dt * 1e3:.1f} ms, "
            f"device busy {busy:.1f} ms ({100 * busy / (dt * 1e3):.1f} % of wall); "
            f"by kind: {by_kind(ms)}")
        log(f"phase 7: {name}: {'align' if corpus.ndim == 2 else 'locate'} of "
            f"{len(seeds)} seeds of {m}: {sum(len(h) for h in hits)} hits; "
            f"launches {launched}; kernel == plain engine (ranges, hits, "
            f"engine_stats), the hit batch's ranges checked at their edges, "
            f"{PAIR_SAMPLES} sampled LCP values exact, every seed found")
        lcps[name] = idx.lcp
        idx.close()
        del idx, eng, sa
    return counts, report, lcps


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


def incore_reference(dev, corpus):
    """In-core SA and LCP of a reads corpus on the kernel path (one
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
    r, l = corpus.shape
    sb = math.ceil(math.log2(l + 1))
    expected = ((torch.arange(r, device=dev)[:, None] << sb)
                | torch.arange(l + 1, device=dev)[None, :]).reshape(-1)
    check_permutation(sa, expected)
    flat, pos = token_layout(corpus, sa, sb)
    check_sampled_order(flat, pos, sa, seed=7)
    check_sampled_lcp(flat, pos, torch.from_numpy(res.lcp).to(dev), seed=13)
    log(f"phase 8: in-core reference of the {r}-read corpus: "
        f"{time.perf_counter() - t0:.3f} s; permutation ok, {PAIR_SAMPLES} sampled "
        f"pairs ordered, {PAIR_SAMPLES} sampled LCP values exact")
    return res.suffix_array, res.lcp


def phase_out_of_core(dev, reads_corpus, text_tokens, incore_sa, incore_lcp):
    """The out-of-core build (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import SuperblockConfig
    from repro_torch.data.corpus import synth_dna_reads
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels import merge_path as mp_mod
    from repro_torch.launch import sa_build

    want_sa = {TEXT_OOC: incore_sa[TEXT_BUILD]}
    want_lcp = {TEXT_OOC: incore_lcp[TEXT_QUERY]}
    if OOC_READS == reads_corpus.shape[0]:
        ooc_reads = reads_corpus
        want_sa[READS_OOC] = incore_sa[READS_BUILD]
        want_lcp[READS_OOC] = incore_lcp[READS_QUERY]
    else:
        ooc_reads = synth_dna_reads(OOC_READS, FULL_READ_LEN, seed=0)
        want_sa[READS_OOC], want_lcp[READS_OOC] = incore_reference(dev, ooc_reads)
    cells = [(READS_OOC, ooc_reads), (TEXT_OOC, text_tokens)]
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
                                         peak_gib=peak / 2**30, stats=st)
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
        # CUDA events only: a launch takes over a millisecond, so the host
        # launch path is noise here, and phase 3 reads the profiler's
        # device time at the same C
        m = merge_path_timing(keys, device_time=False)
        m.update(max_abs_err=max_abs_err(got, want), shape=tuple(keys.shape))
        tile_report[kind] = m
        log(f"phase 8: merge_path_ranks on the {kind} tile of the reads merge "
            f"(C, W) = {tuple(keys.shape)}: kernel == plain, ranks a permutation; "
            f"kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']})")
    return counts, report, tile_report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
    from repro_torch.kernels import _build

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

    t0 = time.perf_counter()
    reads_corpus = synth_dna_reads(FULL_READS, FULL_READ_LEN, seed=0)
    text_tokens, _ = synth_token_corpus(FULL_TEXT, 4, seed=0)
    log(f"corpora synthesized in {time.perf_counter() - t0:.1f} s")

    kern = phase_kernels(dev, reads_corpus, text_tokens)
    phase_small_builds(dev)
    phase_small_indexes(dev)
    phase_small_out_of_core(dev)
    counts, incore_sa = phase_full_builds(dev, reads_corpus, text_tokens)
    phase_profile([(READS_BUILD, reads_corpus), (TEXT_BUILD, text_tokens)])
    query_counts, _, incore_lcp = phase_queries(dev, reads_corpus, text_tokens)
    counts.update(query_counts)
    ooc_counts, _, tiles = phase_out_of_core(dev, reads_corpus, text_tokens,
                                             incore_sa, incore_lcp)
    counts.update(ooc_counts)
    kern["merge_path"] = tiles["largest"]

    sources = {
        "prefix_pack": ("src/repro_torch/kernels/csrc/prefix_pack.cu",
                        "src/repro/kernels/prefix_pack.py:46"),
        "window_gather": ("src/repro_torch/kernels/csrc/window_gather.cu",
                          "src/repro/kernels/window_gather.py:33"),
        "pattern_cmp": ("src/repro_torch/kernels/csrc/pattern_cmp.cu",
                        "src/repro/kernels/pattern_cmp.py:59"),
        "merge_path": ("src/repro_torch/kernels/csrc/merge_path.cu",
                       "src/repro/kernels/merge_path.py:52"),
    }
    log("kernels: " + "; ".join(
        f"{k} launches={counts[KERNEL_BUILD[k]][k]} in the {KERNEL_BUILD[k]} run "
        f"(by run: {', '.join(f'{b} {c[k]}' for b, c in counts.items())}) "
        f"equal=True max_abs_err={kern[k]['max_abs_err']}" for k in sources))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[KERNEL_BUILD[k]][k],
         "max_abs_err": kern[k]["max_abs_err"],
         "ms": kern[k]["ms"], "plain_ms": kern[k]["plain_ms"],
         "bound_ms": kern[k]["bound_ms"], "bound_by": kern[k]["bound_by"],
         "library_ms": None}
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
