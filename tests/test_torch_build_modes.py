"""The port's TeraSort baseline, prefix doubling and rank store against
``repro.core.terasort``, ``repro.core.prefix_doubling`` and
``repro.core.store``'s ``mget_scalar``/``scatter_update`` (under a
one-device ``shard_map``): the same suffix array, every Footprint field and
every stats key, bit for bit, on the same numpy inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.config import SAConfig as RefConfig
from repro.core import distributed as ref_dist
from repro.core import store as ref_store
from repro.core.prefix_doubling import build_suffix_array_doubling as ref_doubling
from repro.core.terasort import build_suffix_array_terasort as ref_terasort
from repro_torch.config import SAConfig
from repro_torch.core import encoding, store
from repro_torch.core.oracle import doubling_sa_text, naive_sa_reads
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.core.prefix_doubling import _round, build_suffix_array_doubling
from repro_torch.core.terasort import _map_records, _suffix_words, build_suffix_array_terasort
from repro_torch.data.corpus import flatten_reads_with_separators, synth_token_corpus

K4 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4: many rounds
LAUNCHER = dict(vocab_size=4, samples_per_shard=512)


def _reads(seed=0, r=30, l=14):
    return np.random.default_rng(seed).integers(1, 5, size=(r, l)).astype(np.int32)


def _variable(seed=1, r=25, l=11):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, l + 1, size=(r,)).astype(np.int32)
    reads = np.zeros((r, l), np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.integers(1, 5, size=(n,))
    return reads, lens


def _same(got, want):
    np.testing.assert_array_equal(got.suffix_array, want.suffix_array)
    assert got.suffix_array.dtype == want.suffix_array.dtype == np.int64
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(want.footprint)
    assert got.stats == want.stats


VAR, VAR_LENS = _variable()
TERASORT_CASES = {
    # name: (reads, lengths, config overrides)
    "uniform": (_reads(), None, K4),
    "uniform-static": (_reads(), None, dict(K4, adaptive=False)),
    "launcher-config": (_reads(2, 20, 30), None, LAUNCHER),
    "bits": (_reads(3), None, dict(vocab_size=4, packing="bits")),
    "variable": (VAR, VAR_LENS, K4),
    "variable-static": (VAR, VAR_LENS, dict(K4, adaptive=False)),
    "duplicates": (np.tile(_reads(4, 4, 9), (4, 1)), None, dict(vocab_size=4)),
}


@pytest.mark.parametrize("name", sorted(TERASORT_CASES))
def test_terasort_matches_repro(name):
    reads, lens, kw = TERASORT_CASES[name]
    got = build_suffix_array_terasort(reads, lens, cfg=SAConfig(**kw), device="cpu")
    _same(got, ref_terasort(reads, lens, cfg=RefConfig(**kw)))
    if lens is None or not kw.get("adaptive", True):
        np.testing.assert_array_equal(got.suffix_array, naive_sa_reads(reads, lens))


def test_terasort_adaptive_capacity_drops_variable_reads_as_repro_does():
    """The adaptive capacity is the scheme Map's count of valid suffixes,
    but TeraSort ships its sentinel rows too: with reads shorter than L, the
    rows past that count (valid ones among them) are dropped.  Both packages
    do this; the static capacity keeps every suffix."""
    got = build_suffix_array_terasort(VAR, VAR_LENS, cfg=SAConfig(**K4), device="cpu")
    n_valid = int(np.sum(VAR_LENS + 1))
    assert got.stats["num_suffixes"] == n_valid
    assert got.stats["dropped"] == VAR.size + VAR.shape[0] - n_valid
    assert got.stats["emitted"] < n_valid


def test_terasort_map_records_equal_the_window_packing():
    """The chunked Map (shifted slices, several chunks) gives the records
    that ``pack_words(all_suffix_windows(...))`` gives."""
    reads, lens = VAR, VAR_LENS
    for kw in (K4, dict(vocab_size=4), dict(vocab_size=4, packing="bits")):
        cfg = SAConfig(**kw)
        r, l = reads.shape
        sb = int(np.ceil(np.log2(l + 1)))
        rec, n_valid = _map_records(torch.from_numpy(reads), torch.from_numpy(lens),
                                    cfg=cfg, stride_bits=sb, chunk=3 * (l + 1) + 2)
        w = _suffix_words(l, cfg)
        k = w * cfg.resolved_chars_per_word()
        padded = torch.nn.functional.pad(torch.from_numpy(reads), (0, k - l))
        words = encoding.pack_words(encoding.all_suffix_windows(padded, k)[:, : l + 1],
                                    cfg, n_words=w)
        offs = np.arange(l + 1)
        gidx = (np.arange(r)[:, None] << sb) | offs[None, :]
        want = np.concatenate([words.numpy(), (gidx >> 31)[..., None],
                               (gidx & (2**31 - 1))[..., None]], axis=-1)
        valid = offs[None, :] <= lens[:, None]
        want[~valid] = np.iinfo(np.int32).max
        np.testing.assert_array_equal(rec.numpy(), want.reshape(r * (l + 1), w + 2))
        assert int(n_valid) == int(valid.sum())


def test_scheme_shuffles_16_bytes_to_terasorts_l_plus_9():
    """The paper's central claim, the ratio of ``tests/test_sa_pipeline.py``:
    the scheme's 16-byte records against the (L+1)-token suffix plus index."""
    reads = _reads(7, 50, 30)
    cfg = SAConfig(vocab_size=4)
    scheme = build_suffix_array(reads, cfg=cfg, device="cpu")
    tera = build_suffix_array_terasort(reads, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(scheme.suffix_array, tera.suffix_array)
    assert scheme.footprint.shuffle * 39 == tera.footprint.shuffle * 16
    assert tera.footprint.materialized > 0 == scheme.footprint.materialized


def _text(seed=8, n=400):
    return np.random.default_rng(seed).integers(1, 5, size=(n,)).astype(np.int32)


DOUBLING_CASES = {
    # name: (text, config overrides)
    "random": (_text(), K4),
    "random-launcher": (_text(9, 500), LAUNCHER),
    "pathological": (np.tile(np.array([1, 2], np.int32), 100), K4),
    "flattened-reads": (flatten_reads_with_separators(_reads(11, 20, 6)), K4),
    "flattened-variable": (flatten_reads_with_separators(VAR, VAR_LENS), K4),
    "planted": (synth_token_corpus(600, 4, seed=2, dup_fraction=0.1, dup_span=24)[0],
                dict(vocab_size=4, packing="bits")),
    "one-token": (np.array([3], np.int32), K4),
    "two-tokens": (np.array([2, 2], np.int32), K4),
}


@pytest.mark.parametrize("name", sorted(DOUBLING_CASES))
def test_doubling_matches_repro(name):
    text, kw = DOUBLING_CASES[name]
    got = build_suffix_array_doubling(text, cfg=SAConfig(**kw), device="cpu")
    _same(got, ref_doubling(text, cfg=RefConfig(**kw)))
    np.testing.assert_array_equal(got.suffix_array, doubling_sa_text(text))
    assert got.stats["dropped"] == got.stats["unresolved"] == 0


def test_doubling_takes_fewer_rounds_than_the_scheme_on_repetitive_text():
    text = np.tile(np.array([1, 2], np.int32), 100)
    scheme = build_suffix_array(text, cfg=SAConfig(**K4), device="cpu")
    dbl = build_suffix_array_doubling(text, cfg=SAConfig(**K4), device="cpu")
    np.testing.assert_array_equal(scheme.suffix_array, dbl.suffix_array)
    assert dbl.stats["rounds"] < scheme.stats["rounds"]


def test_doubling_retries_with_more_slack_when_rounds_run_out():
    """A ``max_rounds`` cut leaves ties: both packages retry with doubled
    slack and report the same unresolved count after the last attempt."""
    import repro.core.prefix_doubling as ref_mod
    import repro_torch.core.prefix_doubling as mod

    text = np.tile(np.array([1, 2], np.int32), 40)
    calls = {"ref": 0, "port": 0}
    ref_fn, port_fn = ref_mod._device_fn, mod._device_fn

    def ref_counting(*a, **kw):
        calls["ref"] += 1
        return ref_fn(*a, **dict(kw, max_rounds=1))

    def port_counting(*a, **kw):
        calls["port"] += 1
        return port_fn(*a, **dict(kw, max_rounds=1))

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref_mod, "_device_fn", ref_counting)
        mp.setattr(mod, "_device_fn", port_counting)
        got = build_suffix_array_doubling(text, cfg=SAConfig(**K4), device="cpu")
        want = ref_doubling(text, cfg=RefConfig(**K4))
    finally:
        mp.undo()
    _same(got, want)
    assert got.stats["unresolved"] > 0 and calls == {"ref": 7, "port": 7}


def test_doubling_byte_counters_do_not_wrap():
    """``repro`` sums ``shuffles_bytes`` in int32: on the 2^26-token text,
    12 bytes a record, the third round wraps it.  The port's round returns
    its counters in int64 and the loop sums them in int64."""
    c = 1 << 26
    ref_sum = jnp.int32(0)
    for _ in range(3):
        ref_sum = ref_sum + jnp.int32(c) * 12
    assert int(ref_sum) < 0  # wrapped

    text = _text(12, 64)
    cfg = SAConfig(**K4)
    n = text.shape[0]
    spec = store.StoreSpec(num_shards=1, rows_per_shard=n, row_len=1,
                           request_capacity=2 * n)
    rank = torch.zeros(n, dtype=torch.int32)
    p = torch.arange(n, dtype=torch.int32)
    *_, sb, fb, _ = _round(rank, p, torch.zeros(n, dtype=torch.int32), 4,
                           spec=spec, cfg=cfg, text_len=n, shuffle_cap=2 * n)
    assert sb.dtype == fb.dtype == torch.int64
    assert (int(sb), int(fb)) == (n * 12, n * 8)
    total = torch.zeros((), dtype=torch.int64)
    for _ in range(3):
        total += sb * (c // n)
    assert int(total) == 3 * c * 12 > 2**31


def _ref_rank_store(spec_kw, vals, pos, newv=None):
    """``repro``'s ``mget_scalar`` (``newv`` None, fill -1) or
    ``scatter_update`` on a one-device mesh; active where ``pos >= 0``."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("sa",))
    spec = ref_store.StoreSpec(axis="sa", **spec_kw)

    def body(vals, pos, *newv):
        if newv:
            out, dropped = ref_store.scatter_update(vals, pos, newv[0], pos >= 0, spec)
        else:
            out, dropped = ref_store.mget_scalar(vals, pos, pos >= 0, spec, fill=-1)
        return out, dropped[None]

    arrays = [vals, pos] + ([] if newv is None else [newv])
    sm = ref_dist.shard_map(body, mesh=mesh, in_specs=(P("sa"),) * len(arrays),
                            out_specs=(P("sa"), P("sa")))
    out, dropped = jax.jit(sm)(*(jnp.asarray(a) for a in arrays))
    return np.asarray(out), int(np.asarray(dropped).sum())


@pytest.mark.parametrize("cap", [64, 16, 5])
def test_mget_scalar_and_scatter_update_match_repro(cap):
    """``tests/test_sa_distributed.py``'s rank-store checks at one shard:
    values and ``dropped``, overflow past a small ``request_capacity``
    included, with inactive (-1) and out-of-range requests."""
    rows = 40
    rng = np.random.default_rng(cap)
    vals = rng.integers(0, 1000, size=(rows,)).astype(np.int32)
    pos = rng.permutation(rows).astype(np.int32)
    pos[::7] = -1  # inactive
    pos[3] = rows + 5  # active but out of range: served with fill
    spec_kw = dict(num_shards=1, rows_per_shard=rows, row_len=1, request_capacity=cap)
    spec = store.StoreSpec(**spec_kw)
    active = torch.from_numpy(pos >= 0)

    got, dropped = store.mget_scalar(torch.from_numpy(vals), torch.from_numpy(pos),
                                     active, spec, fill=-1)
    want, wdropped = _ref_rank_store(spec_kw, vals, pos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(dropped) == wdropped
    # the out-of-range request lands in the dump bucket, whose slots lie past
    # the owners' and so count as a drop, in both packages
    live = int(((pos >= 0) & (pos < rows)).sum())
    assert wdropped == max(0, live - cap) + 1

    newv = rng.integers(0, 1000, size=(rows,)).astype(np.int32)
    got, dropped = store.scatter_update(torch.from_numpy(vals), torch.from_numpy(pos),
                                        torch.from_numpy(newv), active, spec)
    want, wdropped = _ref_rank_store(spec_kw, vals, pos, newv)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(dropped) == wdropped


def test_rank_store_refuses_more_than_one_shard():
    """Two shards over one rank (no process group): the exchange refuses a
    buffer whose bucket count is not the group's size.  Two ranks are
    tests/test_torch_distributed.py's."""
    spec = store.StoreSpec(num_shards=2, rows_per_shard=4, row_len=1, request_capacity=4)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="2 buckets over 1 rank"):
        store.mget_scalar(torch.zeros(4, dtype=torch.int32), pos, pos >= 0, spec)
    with pytest.raises(ValueError, match="2 buckets over 1 rank"):
        store.scatter_update(torch.zeros(4, dtype=torch.int32), pos, pos, pos >= 0, spec)


def test_builders_raise_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_suffix_array_terasort(_reads())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_suffix_array_doubling(_text())


def test_builders_refuse_the_other_corpus_kind():
    with pytest.raises(ValueError, match="read-set"):
        build_suffix_array_terasort(_text(), device="cpu")
    with pytest.raises(ValueError, match="long-text"):
        build_suffix_array_doubling(_reads(), device="cpu")
