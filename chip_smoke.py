#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases,
each of which fails loudly:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel to its plain PyTorch version on the card with
   ``torch.equal``, at the kernel-test shapes and at the full-size shapes of
   phase 5, and time both;
4. small end-to-end builds on the card (kernels on) against the numpy oracle;
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
   share and device time by kind of kernel.

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
# the full-size build whose main path each kernel lies on
KERNEL_BUILD = {"prefix_pack": TEXT_BUILD, "window_gather": READS_BUILD}


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
    log("phase 3: kernels == plain versions at the tests/test_kernels.py shapes")

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
    for name, o in out.items():
        log(f"phase 3: {name} full size ({o['shape']}): kernel {o['ms']:.4f} ms, "
            f"plain {o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}), "
            f"max|err| {o['max_abs_err']}")
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
        if counts[name][kernel] <= 0:
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
    return counts


KERNEL_CLASSES = (  # substring of a kernel's name -> what it belongs to
    ("prefix_pack", "prefix_pack"), ("window_gather", "window_gather"),
    ("gather", "gather"),
    ("RadixSort", "sort"), ("radix", "sort"), ("sort", "sort"),
    ("scan", "scan"), ("scatter", "scatter"), ("index", "index"),
    ("reduce", "reduce"), ("Memcpy", "memcpy"), ("Memset", "memset"),
)


def phase_profile(builds):
    """Where one kernel-path build of each cell spends its device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import sa_build

    for name, corpus in builds:
        cfg = sa_build.make_config("base", "cuda")
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, dt = sa_build.run(corpus, cfg, "cuda")
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
        busy = sum(ms.values())
        by_class = {}
        for key, t in ms.items():
            cls = next((c for sub, c in KERNEL_CLASSES if sub in key), "elementwise")
            by_class[cls] = by_class.get(cls, 0.0) + t
        log(f"phase 6: {name} profiled: wall {dt * 1e3:.1f} ms, device busy "
            f"{busy:.1f} ms ({100 * busy / (dt * 1e3):.1f} % of wall)")
        log("  by kind: " + ", ".join(
            f"{c} {t:.1f} ms" for c, t in sorted(by_class.items(), key=lambda x: -x[1])))
        for key, t in sorted(ms.items(), key=lambda x: -x[1])[:6]:
            log(f"  {t:9.2f} ms  {key[:100]}")


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
    counts = phase_full_builds(dev, reads_corpus, text_tokens)
    phase_profile([(READS_BUILD, reads_corpus), (TEXT_BUILD, text_tokens)])

    sources = {
        "prefix_pack": ("src/repro_torch/kernels/csrc/prefix_pack.cu",
                        "src/repro/kernels/prefix_pack.py:46"),
        "window_gather": ("src/repro_torch/kernels/csrc/window_gather.cu",
                          "src/repro/kernels/window_gather.py:33"),
    }
    log("kernels: " + "; ".join(
        f"{k} launches={counts[KERNEL_BUILD[k]][k]} in the {KERNEL_BUILD[k]} build "
        f"(by build: {', '.join(f'{b} {c[k]}' for b, c in counts.items())}) "
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
