"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips itself without one.  The file
imports neither jax nor ``repro``, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import SAConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels import merge_path as mp_mod
from repro_torch.kernels import pattern_cmp as pc_mod
from repro_torch.kernels import prefix_pack as pp_mod
from repro_torch.kernels import window_gather as wg_mod
from repro_torch.kernels.cases import (
    CMP_EDGE_K, CMP_SHAPES, GATHER_SHAPES, MERGE_EDGE, MERGE_SHAPES, PACK_BLOCK,
    PACK_CFGS, PACK_IDS, PACK_LENGTHS, cmp_edge_inputs, cmp_inputs, gather_inputs,
    merge_edge_inputs, merge_inputs, pack_tokens)


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
@pytest.mark.parametrize("r,l,m,k", GATHER_SHAPES)
def test_window_gather_kernel_on_card(cuda, r, l, m, k):
    args = [torch.from_numpy(a).to(cuda) for a in gather_inputs(r, l, m)]
    before = wg_mod.window_gather.launches
    got = ops.window_gather(*args, k)
    torch.cuda.synchronize()
    assert wg_mod.window_gather.launches == before + 1
    assert torch.equal(got, ref.window_gather_ref(*args, k))


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
    before = pc_mod.pattern_cmp.launches
    got = idx.engine.ranges(pats)
    assert pc_mod.pattern_cmp.launches > before
    store = CorpusStore(None, idx.cfg, backend=idx.store.backend)
    plain = ShardedSAEngine(store, idx.sa, lcp=idx.lcp, use_pallas=False)
    launched = pc_mod.pattern_cmp.launches
    np.testing.assert_array_equal(plain.ranges(pats), got)
    assert pc_mod.pattern_cmp.launches == launched
    assert plain.engine_stats() == idx.engine.engine_stats()


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

