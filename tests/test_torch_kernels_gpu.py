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
from repro_torch.kernels import pattern_cmp as pc_mod
from repro_torch.kernels import prefix_pack as pp_mod
from repro_torch.kernels import window_gather as wg_mod
from repro_torch.kernels.cases import (
    CMP_EDGE_K, CMP_SHAPES, GATHER_SHAPES, PACK_BLOCK, PACK_CFGS, PACK_IDS,
    PACK_LENGTHS, cmp_edge_inputs, cmp_inputs, gather_inputs, pack_tokens)


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
