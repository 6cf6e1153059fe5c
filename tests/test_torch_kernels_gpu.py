"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips itself without one.  The file
imports neither jax nor ``repro``, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import SAConfig
from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels import bitonic_sort as bs_mod
from repro_torch.kernels import bucket_hist as bh_mod
from repro_torch.kernels import merge_path as mp_mod
from repro_torch.kernels import pattern_cmp as pc_mod
from repro_torch.kernels import prefix_pack as pp_mod
from repro_torch.kernels import run_groups as rg_mod
from repro_torch.kernels import window_gather as wg_mod
from repro_torch.kernels.cases import (
    CMP_EDGE_K, CMP_SHAPES, GATHER_CASES, GATHER_IDS, GATHER_LARGE,
    GATHER_SHAPES, HIST_BLOCK, HIST_EDGE, HIST_FAULT,
    HIST_SHAPES, LEVEL_CASES, LEVEL_K, MERGE_EDGE, MERGE_RUN_EDGE, MERGE_RUNS, MERGE_SHAPES,
    PACK_BLOCK, PACK_CFGS, PACK_EDGE, PACK_IDS, PACK_LENGTHS, RUN_GROUPS_CASES,
    RUN_GROUPS_LARGE, RUN_GROUPS_MODES, SEARCH_CFG,
    SEARCH_CORPORA, SORT_EDGE, SORT_FAULT, SORT_LARGE, SORT_SHAPES,
    cmp_edge_inputs, cmp_inputs,
    fault_arrays, gather_case, hist_edge_inputs, hist_inputs, level_args,
    level_case, level_windows, merge_edge_inputs,
    merge_inputs, merge_run_edge_inputs, merge_runs_inputs, pack_edge_tokens,
    pack_tokens, run_groups_tensors, run_keys, search_args, search_corpus,
    search_patterns, sort_edge_inputs, sort_inputs, sorted_rows)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", PACK_CFGS, ids=PACK_IDS)
@pytest.mark.parametrize("n", PACK_LENGTHS)
def test_prefix_pack_kernel_on_card(cuda, kw, n):
    toks = torch.from_numpy(pack_tokens(kw, n)).to(cuda)
    before = pp_mod.prefix_pack.launches
    got = ops.prefix_pack(toks, SAConfig(**kw), block=PACK_BLOCK)
    torch.cuda.synchronize()
    assert pp_mod.prefix_pack.launches == before + 1
    assert torch.equal(got, ref.prefix_pack_ref(toks, SAConfig(**kw)))


@pytest.mark.gpu
@pytest.mark.parametrize("kw", PACK_CFGS, ids=PACK_IDS)
@pytest.mark.parametrize("name", PACK_EDGE)
@pytest.mark.parametrize("block", [PACK_BLOCK, 512, 60])
def test_prefix_pack_kernel_edges_on_card(cuda, kw, name, block):
    """Lengths no multiple of a thread's 8 positions or of a tile, views
    that start 1 or 2 tokens into their storage (4-byte loads), tokens
    outside [0, 2^bits) (the bit words packed directly), a tile of
    ``block`` positions that is no multiple of 8 (rounded up to 64)."""
    toks, off = pack_edge_tokens(kw, name)
    toks = torch.from_numpy(toks).to(cuda)[off:]
    assert pp_mod._vector_path(toks) is (off == 0)
    before = pp_mod.prefix_pack.launches
    got = ops.prefix_pack(toks, SAConfig(**kw), block=block)
    torch.cuda.synchronize()
    assert pp_mod.prefix_pack.launches == before + 1
    assert torch.equal(got, ref.prefix_pack_ref(toks, SAConfig(**kw)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*GATHER_CASES, GATHER_LARGE],
                         ids=[*GATHER_IDS, "large"])
def test_window_gather_kernel_on_card(cuda, case):
    corpus, rows, offs, k = gather_case(case, cuda)
    before = wg_mod.window_gather.launches
    got = ops.window_gather(corpus, rows, offs, k)
    torch.cuda.synchronize()
    assert wg_mod.window_gather.launches == before + 1
    assert torch.equal(got, ref.window_gather_ref(corpus, rows, offs, k))


@pytest.mark.gpu
def test_window_gather_refuses_what_it_cannot_launch(cuda):
    """A window too wide for a tile of 4 requests in shared memory is a
    refused launch: it raises and is not counted."""
    corpus, rows, offs, _ = gather_case(GATHER_SHAPES[0], cuda)
    before = wg_mod.window_gather.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        wg_mod.window_gather(corpus, rows, offs, 10_000)
    assert wg_mod.window_gather.launches == before


def _pattern_cmp_on_card(cuda, arrays, block):
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = pc_mod.pattern_cmp.launches
    got = ops.pattern_cmp(*args, block=block)
    torch.cuda.synchronize()
    assert pc_mod.pattern_cmp.launches == before + 1
    assert torch.equal(got, ref.pattern_cmp_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", CMP_SHAPES)
def test_pattern_cmp_kernel_on_card(cuda, n, k, block):
    _pattern_cmp_on_card(cuda, cmp_inputs(n, k), block)


@pytest.mark.gpu
@pytest.mark.parametrize("k", CMP_EDGE_K)
def test_pattern_cmp_kernel_edge_rows_on_card(cuda, k):
    _pattern_cmp_on_card(cuda, cmp_edge_inputs(k), 256)


@pytest.mark.gpu
@pytest.mark.parametrize("k", LEVEL_K)
@pytest.mark.parametrize("name", LEVEL_CASES)
def test_pattern_cmp_level_kernel_on_card(cuda, name, k):
    """One window level on the card against its plain version on the same
    card tensors: every row of a case in play at its level (the edge rows
    of ``level_case`` included, windows shuffled), rows out of play set on a
    first level and untouched on a later one, with and without ``levels``,
    and a level with no row in play, one launch a call; then
    ``compare_levels`` to the end, kernel against plain."""
    from repro_torch.core.search import compare_levels

    case = level_case(name, k)
    args = [torch.from_numpy(a).to(cuda) for a in level_args(case, k)]
    idle = list(args)
    idle[0], idle[1] = args[0][:0], torch.full_like(args[1], -1)
    for first in (True, False):
        for call in (args, idle):
            for with_levels in (True, False):
                got = [a.clone() for a in call]
                want = [a.clone() for a in call]
                if not first:
                    got[3], want[3] = got[2], want[2]
                if not with_levels:
                    got[9] = want[9] = None
                before = (pc_mod.pattern_cmp.launches, pc_mod.pattern_cmp_level.launches)
                ops.pattern_cmp_level(*got)
                torch.cuda.synchronize()
                assert (pc_mod.pattern_cmp.launches, pc_mod.pattern_cmp_level.launches) == (
                    before[0], before[1] + 1)
                ref.pattern_cmp_level_ref(*want)
                for g, w in zip(got, want, strict=True):
                    assert g is w is None or torch.equal(g, w)

    def fetch(gidx, lv):
        return torch.from_numpy(level_windows(case["suffix"], gidx, lv, k)).to(cuda)

    q = case["t0"].shape[0]
    loop = (torch.arange(q, device=cuda),
            *(torch.from_numpy(case[c]).to(cuda) for c in ("pat_rows", "plen", "t0", "pi")),
            k, 5)
    lv_k, lv_p = (torch.zeros(q, dtype=torch.int32, device=cuda) for _ in range(2))
    got = compare_levels(fetch, ops.pattern_cmp_level, *loop, levels=lv_k)
    want = compare_levels(fetch, ref.pattern_cmp_level_ref, *loop, levels=lv_p)
    assert all(torch.equal(g, w) for g, w in zip((*got, lv_k), (*want, lv_p)))


@pytest.mark.gpu
def test_index_kernel_and_plain_engines_agree_on_card(cuda):
    """A small index on the card: the engine on the kernel and the engine on
    the plain compare give the same ranges and counters."""
    import numpy as np

    from repro_torch import ShardedSAEngine, SuffixArrayIndex
    from repro_torch.core.store import CorpusStore
    from repro_torch.data.corpus import synth_dna_reads

    reads = synth_dna_reads(64, 48, seed=1, paired_end=True)
    idx = SuffixArrayIndex.build(reads, cfg=SAConfig(vocab_size=4, use_pallas=True),
                                 device=cuda)
    rng = np.random.default_rng(0)
    pats = [reads[i, o : o + m].astype(np.int64) for i, o, m in zip(
        rng.integers(0, 128, 60), rng.integers(0, 40, 60), rng.integers(0, 30, 60),
        strict=True)]
    before = launch_counts()
    got = idx.engine.ranges(pats)
    launched = launch_counts()
    assert launched["pattern_search"] == before["pattern_search"] + 2  # a bound each
    assert launched["pattern_cmp"] == before["pattern_cmp"]
    store = CorpusStore(None, idx.cfg, backend=idx.store.backend)
    plain = ShardedSAEngine(store, idx.sa, lcp=idx.lcp, use_pallas=False)
    np.testing.assert_array_equal(plain.ranges(pats), got)
    assert launch_counts() == launched
    assert plain.engine_stats() == idx.engine.engine_stats()
    for c in ("rounds", "requests", "request_bytes", "response_bytes",
              "peak_windows"):
        assert getattr(store, c) == getattr(idx.store, c), c


@pytest.mark.gpu
def test_chunked_index_kernel_and_plain_engines_agree_on_card(cuda, tmp_path):
    """An index reopened on the chunked store keeps the round loop: its
    cache counters follow one backend call a capacity chunk, so it compares
    a window level a ``pattern_cmp_level`` launch, and equals the plain
    engine."""
    import numpy as np

    from repro_torch import ShardedSAEngine, SuffixArrayIndex
    from repro_torch.core.store import CorpusStore
    from repro_torch.data.corpus import synth_dna_reads

    reads = synth_dna_reads(64, 48, seed=1, paired_end=True)
    cfg = SAConfig(vocab_size=4, use_pallas=True)
    SuffixArrayIndex.build(reads, cfg=cfg, index_dir=str(tmp_path / "ix"),
                           device=cuda).close()
    idx = SuffixArrayIndex.open(str(tmp_path / "ix"), device=cuda)
    plain_idx = SuffixArrayIndex.open(str(tmp_path / "ix"), device=cuda)
    rng = np.random.default_rng(1)
    pats = [reads[i, o : o + m].astype(np.int64) for i, o, m in zip(
        rng.integers(0, 128, 60), rng.integers(0, 40, 60), rng.integers(0, 30, 60),
        strict=True)]
    before = launch_counts()
    got = idx.engine.ranges(pats)
    launched = launch_counts()
    assert launched["pattern_cmp_level"] > before["pattern_cmp_level"]
    assert (idx.engine.stats["compare_rounds"]
            == launched["pattern_cmp_level"] - before["pattern_cmp_level"])
    assert launched["pattern_cmp"] == before["pattern_cmp"]
    assert launched["pattern_search"] == before["pattern_search"]
    plain = ShardedSAEngine(plain_idx.store, plain_idx.sa, lcp=plain_idx.lcp,
                            use_pallas=False)
    np.testing.assert_array_equal(plain.ranges(pats), got)
    assert plain.engine_stats() == idx.engine.engine_stats()
    assert (plain_idx.store.backend.cache_hits, plain_idx.store.backend.cache_misses) == (
        idx.store.backend.cache_hits, idx.store.backend.cache_misses)
    idx.close()
    plain_idx.close()


@pytest.mark.gpu
@pytest.mark.parametrize("with_lcp", [True, False], ids=["lcp", "no-lcp"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("name", SEARCH_CORPORA)
def test_pattern_search_kernel_on_card(cuda, name, shards, with_lcp):
    """The CUDA search against its plain version on the same card tensors,
    at the CPU tests' corpora and boundary patterns, both bounds: bounds,
    levels and rounds equal."""
    from repro_torch import ShardedSAEngine
    from repro_torch.core.lcp import lcp_from_sa
    from repro_torch.core.store import CorpusStore

    corpus, sa = search_corpus(name)
    store = CorpusStore(corpus, SAConfig(**SEARCH_CFG), device=cuda)
    eng = ShardedSAEngine(store, sa, lcp=lcp_from_sa(store, sa) if with_lcp else None,
                          num_shards=shards, use_pallas=True)
    for upper in (False, True):
        args = search_args(eng, search_patterns(corpus), upper)
        before = pc_mod.pattern_search.launches
        got = ops.pattern_search(*args)
        torch.cuda.synchronize()
        assert pc_mod.pattern_search.launches == before + 1
        for g, w in zip(got, ref.pattern_search_ref(*args), strict=True):
            assert torch.equal(g, w)


def _merge_path_on_card(cuda, keys, block):
    keys = torch.from_numpy(keys).to(cuda)
    before = mp_mod.merge_path_ranks.launches
    got = ops.merge_path_ranks(keys, block=block)
    torch.cuda.synchronize()
    assert mp_mod.merge_path_ranks.launches == before + 1
    assert torch.equal(got, ref.merge_path_ranks_ref(keys))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("c,w,block", MERGE_SHAPES)
def test_merge_path_kernel_on_card(cuda, c, w, block):
    got = _merge_path_on_card(cuda, merge_inputs(c, w), block)
    assert torch.equal(torch.sort(got).values,
                       torch.arange(c, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("name", MERGE_EDGE)
def test_merge_path_kernel_edge_rows_on_card(cuda, name):
    _merge_path_on_card(cuda, merge_edge_inputs(name), 256)


@pytest.mark.gpu
@pytest.mark.parametrize("r", MERGE_RUNS)
@pytest.mark.parametrize("block", [256, 40])
def test_merge_path_kernel_sorted_runs_on_card(cuda, r, block):
    """Tiles of R sorted runs, as the merge builds them: one warp a row's
    searches (R <= 32) or atomics past that; ranks a permutation."""
    got = _merge_path_on_card(cuda, merge_runs_inputs(r), block)
    assert torch.equal(torch.sort(got).values,
                       torch.arange(got.shape[0], dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("name", MERGE_RUN_EDGE)
def test_merge_path_kernel_run_edges_on_card(cuda, name):
    _merge_path_on_card(cuda, merge_run_edge_inputs(name), 256)


def _out_of_core_on_card(cuda, corpus, oracle):
    import numpy as np

    from repro_torch.config import SuperblockConfig
    from repro_torch.core.superblock import build_suffix_array_superblock

    cfg = SAConfig(vocab_size=4, chars_per_word=2, key_words=2, use_pallas=True)
    sb = SuperblockConfig(num_superblocks=3, emit_lcp=True)
    before = mp_mod.merge_path_ranks.launches
    res = build_suffix_array_superblock(corpus, cfg=cfg, sb=sb, device=cuda)
    assert mp_mod.merge_path_ranks.launches > before
    np.testing.assert_array_equal(res.suffix_array, oracle)
    single = build_suffix_array_superblock(
        corpus, cfg=cfg, sb=SuperblockConfig(emit_lcp=True), device=cuda)
    np.testing.assert_array_equal(res.lcp, single.lcp)
    assert res.stats["superblocks"] == 3
    assert res.stats["dropped"] == res.stats["unresolved"] == 0


@pytest.mark.gpu
def test_out_of_core_reads_build_on_card(cuda):
    """Three superblocks of reads merged through the merge_path kernel: the
    oracle's SA, and the in-core build's LCP."""
    import numpy as np

    from repro_torch.core.oracle import naive_sa_reads

    reads = np.random.default_rng(5).integers(1, 5, size=(48, 12)).astype(np.int32)
    _out_of_core_on_card(cuda, reads, naive_sa_reads(reads))


@pytest.mark.gpu
def test_out_of_core_text_build_on_card(cuda):
    import numpy as np

    from repro_torch.core.oracle import naive_sa_text

    text = np.random.default_rng(2).integers(1, 5, size=(600,)).astype(np.int32)
    _out_of_core_on_card(cuda, text, naive_sa_text(text))



def _bucket_hist_on_card(cuda, arrays, block):
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = bh_mod.bucket_hist.launches
    got = ops.bucket_hist(*args, block=block)
    torch.cuda.synchronize()
    assert bh_mod.bucket_hist.launches == before + 1
    want = ref.bucket_hist_ref(*args)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", HIST_SHAPES)
def test_bucket_hist_kernel_on_card(cuda, n, d):
    bucket, hist = _bucket_hist_on_card(cuda, hist_inputs(n, d), HIST_BLOCK)
    assert int(hist.sum()) == n and int(bucket.max()) < d


@pytest.mark.gpu
def test_bucket_hist_kernel_fault_input_on_card(cuda):
    """Keys and a splitter at (int32 max, int32 max): the histogram counts
    no padding (the Pallas kernel's [1, 7, -3] against the reference's
    [1, 4, 0])."""
    arrays, block = fault_arrays(HIST_FAULT)
    _, hist = _bucket_hist_on_card(cuda, list(arrays.values()), block)
    assert hist.tolist() == [1, 4, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", HIST_EDGE)
@pytest.mark.parametrize("offset", [0, 1])
def test_bucket_hist_kernel_edge_inputs_on_card(cuda, name, offset):
    """Unsorted, repeated, no and the most splitters, one hot bucket; at
    offset 1 the keys are views that start one key into their storage."""
    arrays = hist_edge_inputs(name)
    kh, kl = (torch.from_numpy(a).to(cuda)[offset:] for a in arrays[:2])
    sh, sl = (torch.from_numpy(a).to(cuda) for a in arrays[2:])
    before = bh_mod.bucket_hist.launches
    got = ops.bucket_hist(kh, kl, sh, sl, block=HIST_BLOCK)
    torch.cuda.synchronize()
    assert bh_mod.bucket_hist.launches == before + 1
    for g, w in zip(got, ref.bucket_hist_ref(kh, kl, sh, sl), strict=True):
        assert torch.equal(g, w)
    assert int(got[1].sum()) == kh.shape[0]


def _bitonic_on_card(cuda, arrays, tile, offset=0):
    """One call of the op on the columns (each ``offset`` elements into its
    storage): one count on ``launches``, however many CUDA launches its plan
    makes, and one on ``cuda_launches`` for each step of the plan; keys and
    values as the plain version's."""
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    if offset:
        args = [torch.cat([a.new_zeros(offset), a])[offset:] for a in args]
    n = args[0].shape[0]
    before = bs_mod.bitonic_sort_tiles.launches
    before_cuda = bs_mod.bitonic_sort_tiles.cuda_launches
    got = ops.bitonic_sort_tiles(*args, tile=tile)
    torch.cuda.synchronize()
    assert bs_mod.bitonic_sort_tiles.launches == before + 1
    assert bs_mod.bitonic_sort_tiles.cuda_launches == before_cuda + (
        len(bs_mod.plan(n, tile)) if n else 0)
    want = ref.bitonic_sort_tiles_ref(*args, tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # values: the same multiset within every key group
    assert torch.equal(sorted_rows(*got), sorted_rows(*want))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n,tile", SORT_SHAPES)
def test_bitonic_sort_kernel_on_card(cuda, n, tile):
    _bitonic_on_card(cuda, sort_inputs(n, tile), tile)


@pytest.mark.gpu
def test_bitonic_sort_kernel_fault_input_on_card(cuda):
    """A real (int32 max, int32 max) row in a short tile is kept (the
    Pallas kernel returns values [8, 7, int32 max], the reference [8, 7, 9])."""
    arrays, tile = fault_arrays(SORT_FAULT)
    got = _bitonic_on_card(cuda, list(arrays.values()), tile)
    assert sorted(got[2].tolist()[1:]) == [7, 9] and got[2].tolist()[0] == 8


@pytest.mark.gpu
@pytest.mark.parametrize("name", SORT_EDGE)
def test_bitonic_sort_kernel_edges_on_card(cuda, name):
    """Tiles 1-4; ragged tiles of 4096, 2^16 and 2^20 (global passes and
    in-CTA merges); a tile above n; all-equal keys; int32 extremes with real
    (int32 max, int32 max) rows in a short tile; views off the 16-byte
    path."""
    kh, kl, v, tile, offset = sort_edge_inputs(name)
    _bitonic_on_card(cuda, [kh, kl, v], tile, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("n,tile", SORT_LARGE)
def test_bitonic_sort_kernel_large_tiles_on_card(cuda, n, tile):
    _bitonic_on_card(cuda, sort_inputs(n, tile), tile)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [0, 3, 1000, -4])
def test_bitonic_sort_kernel_refuses_other_tiles(cuda, tile):
    x = torch.zeros(16, dtype=torch.int32, device=cuda)
    before = bs_mod.bitonic_sort_tiles.launches
    with pytest.raises(ValueError, match="power of two"):
        bs_mod.bitonic_sort_tiles(x, x, x, tile=tile)
    assert bs_mod.bitonic_sort_tiles.launches == before


def _run_groups_on_card(keys, flags, eq_mode):
    """The kernel against its plain version (``torch.cummax``) on the same
    card tensors, bit for bit; one launch a call with rows (none without)."""
    before = rg_mod.run_groups.launches
    if eq_mode:
        got, want = ops.run_starts(flags), ref.run_starts_ref(flags)
    else:
        got, want = ops.run_groups(keys, flags), ref.run_groups_ref(keys, flags)
    torch.cuda.synchronize()
    assert rg_mod.run_groups.launches == before + (flags.shape[0] > 0)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", RUN_GROUPS_MODES)
@pytest.mark.parametrize("name", RUN_GROUPS_CASES)
def test_run_groups_kernel_on_card(cuda, name, mode):
    """Empty and one-row inputs, lengths around a tile and no multiple of a
    thread's rows, one run over every tile, every row distinct, padding rows
    at the end and in the middle, views one and three elements into their
    storage (4-byte loads); 0 to 3 key columns, and given flags with eq[0]
    false and true."""
    keys, flags = run_groups_tensors(name, mode, cuda)
    _run_groups_on_card(keys, flags, mode.startswith("eq"))


@pytest.mark.gpu
@pytest.mark.parametrize("runs", ["short", "one"])
def test_run_groups_kernel_large_on_card(cuda, runs):
    """2^27 rows and three key columns (32 768 tiles): short runs with 2 %
    padding rows, and one run over every tile."""
    n = RUN_GROUPS_LARGE
    gen = torch.Generator(device=cuda).manual_seed(27)
    if runs == "one":
        r = torch.zeros(n, dtype=torch.int64, device=cuda)
    else:
        r = torch.cumsum(torch.rand(n, device=cuda, generator=gen) < 0.25, 0)
    valid = (torch.rand(n, device=cuda, generator=gen) >= 0.02) | (runs == "one")
    keys = run_keys(r, 3, lambda a: a.to(torch.int32))
    del r
    _run_groups_on_card(keys, valid, False)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["int64", "strided", "cpu-column", "length", "int-flags"])
def test_run_groups_wrapper_refuses_on_card(cuda, what):
    """Card tensors the kernel does not take: an int64 or strided column, a
    column on the CPU, a column of another length, int flags."""
    col = torch.arange(8, dtype=torch.int32, device=cuda)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    keys, valid = {
        "int64": ([col.long()], valid),
        "strided": ([torch.arange(16, dtype=torch.int32, device=cuda)[::2]], valid),
        "cpu-column": ([col.cpu()], valid),
        "length": ([col[:7]], valid),
        "int-flags": ([col], col),
    }[what]
    before = rg_mod.run_groups.launches
    with pytest.raises(ValueError):
        rg_mod.run_groups(keys, valid)
    assert rg_mod.run_groups.launches == before


@pytest.mark.gpu
def test_in_core_build_launches_run_groups_on_card(cuda):
    """A small in-core reads build on the card launches the kernel once
    after the first sort and once a refinement round, and gives the CPU
    build's suffix array."""
    import numpy as np

    from repro_torch.core.pipeline import build_suffix_array
    from repro_torch.data.corpus import synth_dna_reads

    reads = synth_dna_reads(200, 48, seed=1)
    cfg = SAConfig(vocab_size=4, use_pallas=True)
    before = rg_mod.run_groups.launches
    res = build_suffix_array(reads, cfg=cfg, device=cuda)
    launched = rg_mod.run_groups.launches - before
    assert res.stats["iters"] >= 1
    assert launched == res.stats["iters"] + 1
    cpu = build_suffix_array(reads, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(res.suffix_array, cpu.suffix_array)
    assert res.stats["iters"] == cpu.stats["iters"]
