"""Port encoding/types vs ``repro.core.encoding``/``repro.core.types``: the
same numpy inputs through both packages, compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.config import SAConfig as RefConfig
from repro.core import encoding as ref_enc
from repro.core import types as ref_types
from repro_torch.config import SAConfig
from repro_torch.core import encoding, types

CFGS = [  # tests/test_kernels.py CFGS
    dict(vocab_size=4, packing="base"),
    dict(vocab_size=4, packing="bits"),
    dict(vocab_size=4, chars_per_word=3, key_words=2, packing="base"),
    dict(vocab_size=255, packing="bits"),
]
IDS = [f"{c['packing']}-v{c['vocab_size']}-cpw{c.get('chars_per_word', 0)}"
       for c in CFGS]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", CFGS, ids=IDS)
def test_pack_words(kw):
    cfg = RefConfig(**kw)
    rng = np.random.default_rng(0)
    win = rng.integers(0, cfg.vocab_size + 1,
                       size=(5, 7, cfg.prefix_len)).astype(np.int32)
    got = encoding.pack_words(_t(win), SAConfig(**kw))
    _eq(got, ref_enc.pack_words(jnp.asarray(win), cfg))
    np.testing.assert_array_equal(
        encoding.unpack_words_np(got.numpy(), SAConfig(**kw)), win)


def test_pack_words_wraps_like_int32():
    """An explicit chars_per_word past the int31 capacity wraps as jnp does."""
    kw = dict(vocab_size=255, chars_per_word=5, key_words=2, packing="base")
    win = np.random.default_rng(1).integers(
        0, 256, size=(64, 10)).astype(np.int32)
    _eq(encoding.pack_words(_t(win), SAConfig(**kw)),
        ref_enc.pack_words(jnp.asarray(win), RefConfig(**kw)))


@pytest.mark.parametrize("r,l,m,k", [(8, 16, 5, 4), (32, 200, 64, 26),
                                     (3, 7, 17, 7)])
def test_window_at(r, l, m, k):
    rng = np.random.default_rng(r * l)
    corpus = rng.integers(1, 5, size=(r, l)).astype(np.int32)
    rows = rng.integers(-1, r + 1, size=(m,)).astype(np.int32)
    offs = rng.integers(-1, l + 2, size=(m,)).astype(np.int32)
    _eq(encoding.window_at(_t(corpus), _t(rows), _t(offs), k),
        ref_enc.window_at(jnp.asarray(corpus), jnp.asarray(rows),
                          jnp.asarray(offs), k))


def test_all_suffix_windows():
    reads = np.random.default_rng(2).integers(1, 5, size=(4, 9)).astype(np.int32)
    _eq(encoding.all_suffix_windows(_t(reads), 5),
        ref_enc.all_suffix_windows(jnp.asarray(reads), 5))


@pytest.mark.parametrize("kw", CFGS, ids=IDS)
@pytest.mark.parametrize("variable", [False, True], ids=["uniform", "variable"])
def test_make_records_reads(kw, variable):
    rng = np.random.default_rng(3)
    r, l = 9, 13
    reads = rng.integers(1, kw["vocab_size"] + 1, size=(r, l)).astype(np.int32)
    lens = np.full((r,), l, np.int32)
    if variable:
        lens = rng.integers(-1, l + 1, size=(r,)).astype(np.int32)
        reads = np.where(np.arange(l)[None, :] < lens[:, None], reads, 0)
    rec, valid = encoding.make_records_reads(
        _t(reads), _t(lens), SAConfig(**kw), read_id_base=5)
    want_rec, want_valid = ref_enc.make_records_reads(
        jnp.asarray(reads), jnp.asarray(lens), RefConfig(**kw), read_id_base=5)
    _eq(rec, want_rec)
    _eq(valid, want_valid)


@pytest.mark.parametrize("kw", CFGS, ids=IDS)
def test_make_records_text(kw):
    text = np.random.default_rng(4).integers(
        1, kw["vocab_size"] + 1, size=(101,)).astype(np.int32)
    for pos_base, n_emit in ((0, None), (40, 90)):
        _eq(encoding.make_records_text(_t(text), SAConfig(**kw),
                                       pos_base=pos_base, n_emit=n_emit),
            ref_enc.make_records_text(jnp.asarray(text), RefConfig(**kw),
                                      pos_base=pos_base, n_emit=n_emit))


@pytest.mark.parametrize("stride_bits", [1, 5, 8, 20])
def test_pack_unpack_index(stride_bits):
    rng = np.random.default_rng(stride_bits)
    read_id = rng.integers(0, 1 << (31 - stride_bits + 3), size=(200,)).astype(np.int32)
    read_id = np.minimum(read_id, np.iinfo(np.int32).max).astype(np.int32)
    offset = rng.integers(0, 1 << stride_bits, size=(200,)).astype(np.int32)
    hi, lo = types.pack_index(_t(read_id), _t(offset), stride_bits)
    want_hi, want_lo = ref_types.pack_index(jnp.asarray(read_id),
                                            jnp.asarray(offset), stride_bits)
    _eq(hi, want_hi)
    _eq(lo, want_lo)
    rid, off = types.unpack_index(hi, lo, stride_bits)
    want_rid, want_off = ref_types.unpack_index(want_hi, want_lo, stride_bits)
    _eq(rid, want_rid)
    _eq(off, want_off)
    _eq(rid, read_id)
    _eq(off, offset)
    np.testing.assert_array_equal(
        types.global_index(hi.numpy(), lo.numpy()),
        (read_id.astype(np.int64) << stride_bits) | offset)
