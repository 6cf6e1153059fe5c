"""The port's out-of-core build against ``repro.core.superblock``, on the CPU:
whole multi-superblock builds give the same suffix array, LCP array,
``Footprint`` and ``stats`` (the wall times ``t_*_s`` aside), and the
``benchmarks/baselines/BENCH_merge.json`` merge-path counters hold exactly.
Also the ``merge_path_ranks`` plain version against the JAX reference and
the JAX kernel in interpret mode, and the index facade over a
multi-superblock build."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig as RefSuperblockConfig
from repro.core.superblock import build_suffix_array_superblock as ref_build
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.serve.sa_engine import SuffixArrayIndex as RefIndex
from repro_torch import SuffixArrayIndex
from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.core.superblock import build_suffix_array_superblock
from repro_torch.data.corpus import synth_dna_reads, synth_token_corpus
from repro_torch.kernels import ref
from repro_torch.kernels.cases import (
    MERGE_EDGE, MERGE_SHAPES, merge_edge_inputs, merge_inputs)

K4 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4: deep ties
BASE = dict(vocab_size=4, packing="base")  # benchmarks/scaling.py's config


def _build_both(corpus, lengths=None, cfg=K4, **sb):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_build(corpus, lengths=lengths, cfg=RefConfig(**cfg),
                         sb=RefSuperblockConfig(**sb))
        got = build_suffix_array_superblock(
            corpus, lengths=lengths, cfg=SAConfig(**cfg),
            sb=SuperblockConfig(**sb), device="cpu")
    return want, got


def _walls_apart(stats):
    return {k: v for k, v in stats.items() if not k.startswith("t_")}


def _assert_same(want, got, oracle=None):
    np.testing.assert_array_equal(got.suffix_array, want.suffix_array)
    if oracle is not None:
        np.testing.assert_array_equal(got.suffix_array, oracle)
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(want.footprint)
    assert _walls_apart(got.stats) == _walls_apart(want.stats)
    assert sorted(got.stats) == sorted(want.stats)
    if want.lcp is None:
        assert got.lcp is None
    else:
        np.testing.assert_array_equal(got.lcp, want.lcp)
    assert got.stats["dropped"] == got.stats["unresolved"] == 0


# ---------------------------------------------------------------------------
# the BENCH_merge.json corpora (benchmarks/scaling.py run_merge)
# ---------------------------------------------------------------------------


BENCH = {  # corpus, superblocks, merge_path_{roundtrips, requests, bytes, peak}
    "reads_random": (lambda: synth_dna_reads(96, 16, seed=3), 4,
                     (5, 1632, 48960, 25104)),
    "reads_repetitive": (lambda: np.tile(np.array([1, 2] * 6, np.int32), (48, 1)),
                         3, (4, 624, 18720, 11850)),
    "text_random": (lambda: synth_token_corpus(768, 4, seed=3)[0], 4,
                    (7, 846, 25380, 7356)),
}


@pytest.mark.parametrize("name", sorted(BENCH))
def test_bench_merge_corpora_match_repro_and_baseline(name):
    make, s, (rounds, requests, nbytes, peak) = BENCH[name]
    corpus = make()
    want, got = _build_both(corpus, cfg=BASE, num_superblocks=s)
    _assert_same(want, got, _oracle(corpus))
    assert got.stats["merge_fetch_rounds"] == rounds
    assert got.stats["merge_fetch_requests"] == requests
    assert got.stats["merge_fetch_bytes"] == nbytes
    assert got.footprint.peak_resident_bytes == peak
    assert got.stats["superblocks"] == s


def _oracle(corpus, lengths=None):
    if corpus.ndim == 1:
        return naive_sa_text(corpus)
    return naive_sa_reads(corpus, lengths)


# ---------------------------------------------------------------------------
# the switches of the merge
# ---------------------------------------------------------------------------


def _variable():
    rng = np.random.default_rng(1)
    lens = rng.integers(0, 11, size=(30,)).astype(np.int32)
    reads = np.zeros((30, 11), np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.integers(1, 5, size=(n,))
    return reads, lens


READS = np.random.default_rng(5).integers(1, 5, size=(48, 12)).astype(np.int32)
REPETITIVE = np.tile(np.array([1, 2] * 6, np.int32), (36, 1))
TEXT = np.random.default_rng(2).integers(1, 5, size=(600,)).astype(np.int32)
ATAT = np.tile(np.array([1, 2], np.int32), 120)
VAR, VAR_LENS = _variable()
CASES = {
    # name: (corpus, lengths, SAConfig overrides, SuperblockConfig overrides)
    "variable": (VAR, VAR_LENS, {}, {}),
    "variable-lcp-device": (VAR, VAR_LENS, {}, dict(emit_lcp=True,
                                                   merge_backend="device")),
    "reads-lcp": (READS, None, {}, dict(emit_lcp=True)),
    "reads-tile2": (READS, None, {}, dict(merge_tile=2)),
    "reads-tile2-depth0-lcp": (READS, None, {}, dict(merge_tile=2, pipeline_depth=0,
                                                     emit_lcp=True)),
    "reads-device": (READS, None, {}, dict(merge_backend="device")),
    "reads-budget": (READS, None, {}, dict(num_superblocks=0,
                                           max_records_per_run=200)),
    "reads-cap3-depth2": (READS, None, {}, dict(request_capacity=3,
                                                pipeline_depth=2)),
    "repetitive-device-lcp": (REPETITIVE, None, {}, dict(merge_backend="device",
                                                         emit_lcp=True)),
    "text-lcp": (TEXT, None, {}, dict(emit_lcp=True)),
    "text-depth0": (TEXT, None, {}, dict(pipeline_depth=0)),
    "atat": (ATAT, None, {}, {}),
    "atat-device-lcp": (ATAT, None, {}, dict(merge_backend="device", emit_lcp=True)),
    "atat-cap3": (ATAT, None, {}, dict(request_capacity=3, samples_per_block=1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_out_of_core_build_matches_repro(name):
    corpus, lengths, cfg, sb = CASES[name]
    sb = {"num_superblocks": 3, **sb}
    want, got = _build_both(corpus, lengths, cfg={**K4, **cfg}, **sb)
    _assert_same(want, got, _oracle(corpus, lengths))
    if sb.get("emit_lcp"):
        single = build_suffix_array_superblock(
            corpus, lengths=lengths, cfg=SAConfig(**K4),
            sb=SuperblockConfig(emit_lcp=True), device="cpu")
        np.testing.assert_array_equal(got.lcp, single.lcp)


def test_merge_path_kernel_route_matches_repro():
    """``use_pallas=True``: the JAX package ranks tiles with its Pallas
    kernel in interpret mode, the port (on the CPU) with the kernel's plain
    version; the builds agree."""
    reads = np.random.default_rng(11).integers(1, 5, size=(30, 11)).astype(np.int32)
    want, got = _build_both(reads, cfg={**K4, "use_pallas": True}, num_superblocks=3)
    _assert_same(want, got, naive_sa_reads(reads))


@pytest.mark.parametrize("corpus", ["reads", "text"])
def test_pipeline_depth_keeps_the_traffic(corpus):
    """The pipelined build (staging prefetch, background writes, refill
    prefetch) issues the synchronous build's requests and bytes, bit for
    bit, and matches ``repro`` at every depth.  As in ``repro``, the
    resident peak grows by the prefetched keys, and the round count may
    differ, since a prefetch batch is cut into capacity rounds apart from
    its refill."""
    data = READS if corpus == "reads" else TEXT
    runs = {}
    for d in (0, 1, 3):
        want, got = _build_both(data, num_superblocks=4, emit_lcp=True,
                                pipeline_depth=d)
        _assert_same(want, got)
        runs[d] = got
    for d in (1, 3):
        np.testing.assert_array_equal(runs[d].suffix_array, runs[0].suffix_array)
        np.testing.assert_array_equal(runs[d].lcp, runs[0].lcp)
        got, want = (dataclasses.asdict(r.footprint) for r in (runs[d], runs[0]))
        assert got.pop("peak_resident_bytes") >= want.pop("peak_resident_bytes")
        assert got == want
        got, want = (_walls_apart(r.stats) for r in (runs[d], runs[0]))
        for key in ("pipeline_depth", "peak_resident_bytes", "merge_fetch_rounds"):
            got.pop(key), want.pop(key)
        assert got == want


# ---------------------------------------------------------------------------
# the index facade over a multi-superblock build
# ---------------------------------------------------------------------------


def test_index_build_with_superblocks_matches_repro():
    reads = synth_dna_reads(40, 24, seed=4, paired_end=True)
    sb = dict(num_superblocks=3)
    want = RefIndex.build(reads, cfg=RefConfig(vocab_size=4),
                          sb=RefSuperblockConfig(**sb))
    got = SuffixArrayIndex.build(reads, cfg=SAConfig(vocab_size=4),
                                 sb=SuperblockConfig(**sb), device="cpu")
    assert got.build_stats["superblocks"] == 3
    assert _walls_apart(got.build_stats) == _walls_apart(want.build_stats)
    np.testing.assert_array_equal(got.sa, want.sa)
    np.testing.assert_array_equal(got.lcp, want.lcp)
    rng = np.random.default_rng(0)
    pats = [reads[i, o : o + m].astype(np.int64) for i, o, m in zip(
        rng.integers(0, 80, 30), rng.integers(0, 20, 30), rng.integers(1, 12, 30),
        strict=True)]
    np.testing.assert_array_equal(got.count(pats), want.count(pats))
    assert got.align(pats[:8]) == want.align(pats[:8])
    assert got.stats() == want.stats()


# ---------------------------------------------------------------------------
# merge_path_ranks: the plain version against the JAX reference and kernel
# ---------------------------------------------------------------------------


def _ranks_match_repro(keys, block):
    got = ref.merge_path_ranks_ref(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_kernels.merge_path_ranks_ref(jnp.asarray(keys))))
    np.testing.assert_array_equal(
        got, np.asarray(ref_ops.merge_path_ranks(jnp.asarray(keys), block=block)))
    return got


@pytest.mark.parametrize("c,w,block", MERGE_SHAPES)
def test_merge_path_ranks_ref_matches_repro(c, w, block):
    keys = merge_inputs(c, w)
    got = _ranks_match_repro(keys, block)
    assert sorted(got.tolist()) == list(range(c))


@pytest.mark.parametrize("name", MERGE_EDGE)
def test_merge_path_ranks_edge_rows_match_repro(name):
    """Duplicates, one and 64 words, a single row, C = 1000, negative and
    int32-extreme words: strictly-less counts, as the JAX kernel gives them
    (its int32-max padding rows are never less than a real row)."""
    keys = merge_edge_inputs(name)
    got = _ranks_match_repro(keys, 128)
    brute = [sum(tuple(r) < tuple(row) for r in keys.tolist())
             for row in keys.tolist()]
    np.testing.assert_array_equal(got, brute)
