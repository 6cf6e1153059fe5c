"""Port shuffle and store at one shard vs ``repro.core.distributed`` /
``repro.core.store`` (the latter under a one-device ``shard_map``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.config import SAConfig as RefConfig
from repro.core import distributed as ref_dist
from repro.core import store as ref_store
from repro_torch.config import SAConfig
from repro_torch.core import distributed, store


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,nb,cap", [(40, 3, 20), (40, 3, 9), (7, 2, 1)])
def test_bucket_scatter(n, nb, cap):
    rng = np.random.default_rng(n + cap)
    vals = rng.integers(-5, 100, size=(n, 3)).astype(np.int32)
    bucket = rng.integers(0, nb, size=(n,)).astype(np.int32)
    buf, slot, dropped = distributed.bucket_scatter(_t(vals), _t(bucket), nb, cap, -1)
    wbuf, wslot, wdropped = ref_dist.bucket_scatter(
        jnp.asarray(vals), jnp.asarray(bucket), nb, cap, -1)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(wbuf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(wslot))
    assert int(dropped) == int(wdropped)


def test_lex_bucket_and_run_starts():
    rng = np.random.default_rng(5)
    kh = rng.integers(0, 6, size=(50,)).astype(np.int32)
    kl = rng.integers(0, 6, size=(50,)).astype(np.int32)
    sh = np.sort(rng.integers(0, 6, size=(4,))).astype(np.int32)
    sl = rng.integers(0, 6, size=(4,)).astype(np.int32)
    np.testing.assert_array_equal(
        distributed.lex_bucket(*map(_t, (kh, kl, sh, sl))).numpy(),
        np.asarray(ref_dist.lex_bucket(*map(jnp.asarray, (kh, kl, sh, sl)))))
    eq = rng.random(50) < 0.6
    eq[0] = False
    np.testing.assert_array_equal(distributed.run_starts(_t(eq)).numpy(),
                                  np.asarray(ref_dist.run_starts(jnp.asarray(eq))))


def test_sample_splitters_single_shard_is_empty():
    kh = torch.arange(10, dtype=torch.int32)
    s_hi, s_lo = distributed.sample_splitters(kh, kh, 4)
    assert s_hi.shape == (0,) and s_lo.shape == (0,)
    assert distributed.lex_bucket(kh, kh, s_hi, s_lo).tolist() == [0] * 10


@pytest.mark.parametrize("num_keys,carry", [(2, 1), (4, 0), (5, 2)])
def test_lex_sort_matches_lax_sort(num_keys, carry):
    """Chained stable sorts over packed int64 keys == lax.sort, for every
    int32 value (negative words included) and with many ties."""
    rng = np.random.default_rng(num_keys)
    cols = [rng.choice(np.array([-(2**31), -7, 0, 3, 2**31 - 1], np.int32), 300)
            for _ in range(num_keys + carry)]
    cols[-1] = rng.permutation(300).astype(np.int32)  # shows the stable order
    got = distributed.lex_sort([_t(c) for c in cols[:num_keys]],
                               [_t(c) for c in cols[num_keys:]])
    want = lax.sort(tuple(jnp.asarray(c) for c in cols), num_keys=num_keys)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _inputs(text: bool, m=40):
    rng = np.random.default_rng(7)
    if text:
        n, k = 60, 4
        local = np.concatenate([rng.integers(1, 5, size=(n,)), np.zeros(k)])
        local = local.astype(np.int32)[:, None]  # tokens + halo, rows of 1
        rows_per_shard, row_len = n, 1
        row = rng.integers(-2, n + 3, size=(m,)).astype(np.int32)
        off = np.zeros((m,), np.int32)
    else:
        r, l = 12, 9
        local = rng.integers(1, 5, size=(r, l)).astype(np.int32)
        rows_per_shard, row_len = r, l
        row = rng.integers(-2, r + 3, size=(m,)).astype(np.int32)
        off = rng.integers(0, l + 2, size=(m,)).astype(np.int32)
    active = rng.random(m) < 0.8
    return local, rows_per_shard, row_len, row, off, active


def _ref_mget(local, row, off, active, spec, cfg):
    mesh = Mesh(np.array(jax.devices()[:1]), ("sa",))

    def body(local_l, row_l, off_l, act_l):
        out, exh, ok, fs = ref_store.mget_window(local_l, row_l, off_l, act_l,
                                                 spec, cfg)
        st = jnp.stack([fs.requests, fs.request_bytes, fs.response_bytes,
                        fs.dropped])
        return out, exh, ok, st[None, :]

    fn = ref_dist.shard_map(body, mesh=mesh, in_specs=(P("sa"),) * 4,
                            out_specs=(P("sa"),) * 4)
    out = jax.jit(fn)(*map(jnp.asarray, (local, row, off, active)))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("text", [False, True], ids=["reads", "text"])
@pytest.mark.parametrize("server_pack", [True, False], ids=["pack", "raw"])
@pytest.mark.parametrize("fetch_fraction", [1.0, 0.25])
def test_mget_window_matches_repro(text, server_pack, fetch_fraction):
    local, rps, row_len, row, off, active = _inputs(text)
    kw = dict(vocab_size=4, chars_per_word=2, key_words=2,
              server_pack=server_pack, fetch_fraction=fetch_fraction)
    cap = max(1, math.ceil(row.shape[0] * fetch_fraction))
    ref_spec = ref_store.StoreSpec(axis="sa", num_shards=1, rows_per_shard=rps,
                                   row_len=row_len, request_capacity=cap)
    spec = store.StoreSpec(num_shards=1, rows_per_shard=rps, row_len=row_len,
                           request_capacity=cap)
    want = _ref_mget(local, row, off, active, ref_spec, RefConfig(**kw))
    cfg = SAConfig(**kw)
    out, exh, ok, fs = store.mget_window(*map(_t, (local, row, off, active)),
                                         spec, cfg)
    for got, w in zip((out, exh, ok), want[:3], strict=True):
        np.testing.assert_array_equal(got.numpy(), w)
    stats = [int(fs.requests), int(fs.request_bytes), int(fs.response_bytes),
             int(fs.dropped)]
    assert stats == want[3][0].tolist()
    if fetch_fraction < 1:
        assert stats[3] > 0  # capacity drops occurred

    # the pipeline's chunked service: same ok/exhausted/stats, packed words
    words, exh2, ok2, fs2 = store.serve_windows(
        *map(_t, (local, row, off, active)), spec, cfg, chunk=7)
    np.testing.assert_array_equal(ok2.numpy(), want[2])
    np.testing.assert_array_equal(exh2.numpy(), want[1])
    packed = out if server_pack else store.encoding.pack_words(out, cfg)
    np.testing.assert_array_equal(words.numpy(), packed.numpy())
    assert [int(fs2.requests), int(fs2.request_bytes), int(fs2.response_bytes),
            int(fs2.dropped)] == stats
    assert (fs2.padded_request_bytes, fs2.padded_response_bytes) == (
        fs.padded_request_bytes, fs.padded_response_bytes)


def test_store_spec_and_byte_models_match():
    for rows, row_len in ((10, 1), (1000, 200), (2**29, 1), (2**26, 200)):
        a = store.StoreSpec(1, rows, row_len, 5)
        b = ref_store.StoreSpec("sa", 1, rows, row_len, 5)
        assert (a.is_text, a.index_bytes) == (b.is_text, b.index_bytes)
    for v in (1, 4, 255, 256, 70000):
        assert store.token_bytes(v) == ref_store.token_bytes(v)
