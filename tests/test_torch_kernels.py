"""Port kernels: the plain versions against ``repro.kernels.ref`` and the
Pallas kernels (interpret mode off the TPU), CPU dispatch and the registry.
The CUDA kernels themselves are held to their plain versions on the card by
``tests/test_torch_kernels_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.config import SAConfig as RefConfig
from repro.kernels import KERNEL_REGISTRY as REF_REGISTRY
from repro.kernels import ops as ref_ops
from repro.core.search import masked_cmp_np
from repro.kernels import ref as jref
from repro_torch.config import SAConfig
from repro_torch.core.search import masked_cmp
from repro_torch.kernels import KERNEL_REGISTRY, launch_counts, ops, ref
from repro_torch.kernels import pattern_cmp as pc_mod
from repro_torch.kernels import prefix_pack as pp_mod
from repro_torch.kernels import window_gather as wg_mod
from repro_torch.kernels.cases import (
    CMP_EDGE_K, CMP_SHAPES, GATHER_SHAPES, PACK_BLOCK, PACK_CFGS, PACK_IDS,
    PACK_LENGTHS, cmp_edge_inputs, cmp_inputs, gather_inputs, pack_tokens)


@pytest.mark.parametrize("kw", PACK_CFGS, ids=PACK_IDS)
@pytest.mark.parametrize("n", PACK_LENGTHS)
def test_prefix_pack_ref_matches_repro(kw, n):
    toks = pack_tokens(kw, n)
    before = launch_counts()
    got = ops.prefix_pack(torch.from_numpy(toks), SAConfig(**kw), block=PACK_BLOCK)
    assert launch_counts() == before  # CPU tensors take the plain version
    want_ref = jref.prefix_pack_ref(jnp.asarray(toks), RefConfig(**kw))
    want_kernel = ref_ops.prefix_pack(jnp.asarray(toks), RefConfig(**kw), block=PACK_BLOCK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    np.testing.assert_array_equal(
        ref.prefix_pack_ref(torch.from_numpy(toks), SAConfig(**kw)).numpy(),
        got.numpy())


@pytest.mark.parametrize("r,l,m,k", GATHER_SHAPES)
def test_window_gather_ref_matches_repro(r, l, m, k):
    corpus, rows, offs = gather_inputs(r, l, m)
    before = launch_counts()
    got = ops.window_gather(*map(torch.from_numpy, (corpus, rows, offs)), k)
    assert launch_counts() == before
    args = tuple(map(jnp.asarray, (corpus, rows, offs)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.window_gather_ref(*args, k)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_ops.window_gather(*args, k)))


def _pattern_cmp_matches_repro(arrays, block):
    before = launch_counts()
    got = ops.pattern_cmp(*map(torch.from_numpy, arrays), block=block)
    assert launch_counts() == before  # CPU tensors take the plain version
    jargs = tuple(map(jnp.asarray, arrays))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.pattern_cmp_ref(*jargs)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.pattern_cmp(*jargs, block=block)))
    cmp, matched = masked_cmp(*map(torch.from_numpy, arrays))
    want_cmp, want_matched = masked_cmp_np(*arrays)
    np.testing.assert_array_equal(cmp.numpy(), want_cmp)
    np.testing.assert_array_equal(matched.numpy(), want_matched)
    np.testing.assert_array_equal(cmp.numpy(), got.numpy()[:, 0])
    np.testing.assert_array_equal(matched.numpy(), got.numpy()[:, 1])


@pytest.mark.parametrize("n,k,block", CMP_SHAPES)
def test_pattern_cmp_ref_matches_repro(n, k, block):
    _pattern_cmp_matches_repro(cmp_inputs(n, k), block)


@pytest.mark.parametrize("k", CMP_EDGE_K)
def test_pattern_cmp_edge_rows_match_repro(k):
    """Rows beyond ``0 <= start <= stop <= k``: start > stop, stop > k,
    negative start, padding rows, negative and large tokens, k > 32."""
    _pattern_cmp_matches_repro(cmp_edge_inputs(k), 256)


def test_registry_keys_match_repro():
    assert sorted(KERNEL_REGISTRY) == sorted(REF_REGISTRY)
    for key, entry in KERNEL_REGISTRY.items():
        assert entry.op == REF_REGISTRY[key].op
        assert callable(getattr(ops, entry.op))
        if entry.ported:
            assert entry.ref == REF_REGISTRY[key].ref
            assert callable(getattr(ref, entry.ref))
        else:
            assert entry.roadmap


@pytest.mark.parametrize("key", sorted(k for k, e in KERNEL_REGISTRY.items()
                                       if not e.ported))
def test_unported_ops_raise(key):
    x = torch.zeros(4, dtype=torch.int32)
    args = {
        "bucket_hist": (x, x, x[:1], x[:1]),
        "bitonic_sort": (x, x, x),
        "merge_path": (x.reshape(2, 2),),
        "pattern_cmp": (x.reshape(2, 2), x.reshape(2, 2), x[:2], x[:2]),
    }[key]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(ops, KERNEL_REGISTRY[key].op)(*args)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never runs on the CPU."""
    toks = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pp_mod.prefix_pack(toks, SAConfig(vocab_size=4))
    with pytest.raises(ValueError, match="CUDA"):
        wg_mod.window_gather(toks.reshape(2, 4), toks[:2], toks[:2], 3)


def test_pattern_cmp_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 4), dtype=torch.int32)
    before = pc_mod.pattern_cmp.launches
    with pytest.raises(ValueError, match="CUDA"):
        pc_mod.pattern_cmp(x, x, x[0, :2], x[0, :2])
    assert pc_mod.pattern_cmp.launches == before


def test_merge_path_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the dispatch op takes the plain version and launches
    nothing; the kernel's own wrapper refuses it."""
    from repro_torch.kernels import merge_path as mp_mod

    keys = torch.tensor([[3, 1], [1, 2], [3, 1], [0, 9]], dtype=torch.int32)
    before = mp_mod.merge_path_ranks.launches
    assert ops.merge_path_ranks(keys).tolist() == [2, 1, 2, 0]
    with pytest.raises(ValueError, match="CUDA"):
        mp_mod.merge_path_ranks(keys)
    assert mp_mod.merge_path_ranks.launches == before

