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
from repro_torch.kernels import prefix_pack as pp_mod
from repro_torch.kernels import window_gather as wg_mod
from repro_torch.kernels.cases import (
    GATHER_SHAPES, PACK_BLOCK, PACK_CFGS, PACK_IDS, PACK_LENGTHS, gather_inputs,
    pack_tokens)


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
