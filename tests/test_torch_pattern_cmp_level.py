"""One window level of the query engine's round loop (``pattern_cmp_level``)
against ``repro.serve.sa_engine`` on the CPU.

``kernels.ref.pattern_cmp_level_ref`` (what the CUDA kernel computes) is held
to ``repro``'s ``_compare_batch`` with ``repro.kernels.ref.pattern_cmp_ref``
as its compare, on the pattern windows and ranges that ``_compare_batch``
builds, and, one call at a time, to the rule written out with
``pattern_cmp_ref``.  The port's engine under ``use_pallas`` on a chunked
store and on a ``FlakyBackend`` (its round loop, one ``pattern_cmp_level``
call a window level, the plain version on CPU tensors) is held to ``repro``'s
engine under ``use_pallas`` (the Pallas kernel in interpret mode) in ranges,
every ``engine_stats()`` key and the store's and backends' counters.  The
CUDA kernel is held to the plain version on the card by
``tests/test_torch_kernels_gpu.py``."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.config import SAConfig as RefConfig
from repro.core import store as ref_store
from repro.core.lcp import lcp_from_sa as ref_lcp_from_sa
from repro.data.chunk_store import write_chunked_corpus
from repro.kernels import ref as jref
from repro.serve import sa_engine as ref_engine
from repro_torch import SAConfig, ShardedSAEngine
from repro_torch.core import store as port_store
from repro_torch.core.lcp import lcp_from_sa
from repro_torch.core.search import compare_levels
from repro_torch.kernels import launch_counts, ops, ref
from repro_torch.kernels import pattern_cmp as pc_mod
from repro_torch.kernels.cases import (
    LEVEL_CASES, LEVEL_K, SEARCH_CFG, level_args, level_case, level_windows,
    search_corpus, search_patterns)

LEVEL_PARAMS = [(name, k) for name in LEVEL_CASES for k in LEVEL_K]


def _pattern_cmp_ref(win, pw, start, stop):
    """``repro.kernels.ref.pattern_cmp_ref`` on the int32 casts of its
    arguments (as ``repro``'s kernel route casts them), the rows padded to a
    multiple of 512 with ``start == stop == 0`` rows so that jax compiles
    one shape a width."""
    m = win.shape[0]
    pad = -m % 512
    args = [np.pad(np.asarray(a).astype(np.int32),
                   ((0, pad),) + ((0, 0),) * (np.ndim(a) - 1))
            for a in (win, pw, start, stop)]
    return np.asarray(jref.pattern_cmp_ref(*map(jnp.asarray, args)))[:m]


def _repro_levels(case, k):
    """``repro``'s ``_compare_batch`` over the case's suffixes, its compare
    ``pattern_cmp_ref`` on the int32 pattern windows and ranges it builds
    (as its kernel route casts them): ``(cmp, t)`` and each level's rows
    and their window levels."""
    rows = []

    def fetch_windows(gidx, lv):
        rows.append((gidx.copy(), np.broadcast_to(lv, gidx.shape).copy()))
        return level_windows(case["suffix"], gidx, lv, k)

    def cmp_rows(win, pw, start, stop):
        out = _pattern_cmp_ref(win, pw, start, stop)
        return out[:, 0], out[:, 1].astype(np.int64)

    store = SimpleNamespace(k=k, max_window_depth=5, fetch_windows=fetch_windows)
    fake = SimpleNamespace(store=store, _cmp_rows=cmp_rows)
    q = case["t0"].shape[0]
    cmp, t = ref_engine.ShardedSAEngine._compare_batch(
        fake, np.arange(q, dtype=np.int64), case["pat_rows"], case["plen"],
        case["t0"], case["pi"])
    return cmp, t, rows


@pytest.mark.parametrize("name,k", LEVEL_PARAMS)
def test_level_ref_is_repros_compare_batch(name, k):
    """``compare_levels`` with ``pattern_cmp_level_ref`` as its level: the
    same rows fetched at the same window levels, and the same ``cmp`` and ``t`` as
    ``repro``'s ``_compare_batch``; ``levels`` counts each row's fetches;
    ``t0`` is left as it was."""
    case = level_case(name, k)
    want_cmp, want_t, want_rows = _repro_levels(case, k)
    q = case["t0"].shape[0]
    rows = []

    def fetch(gidx, lv):
        rows.append((gidx.copy(), lv.copy()))
        return torch.from_numpy(level_windows(case["suffix"], gidx, lv, k))

    levels = torch.zeros(q, dtype=torch.int32)
    t0 = torch.from_numpy(case["t0"].copy())
    before = launch_counts()
    cmp, t = compare_levels(
        fetch, ops.pattern_cmp_level, torch.arange(q),
        *(torch.from_numpy(case[c]) for c in ("pat_rows", "plen")), t0,
        torch.from_numpy(case["pi"]), k, 6, levels=levels)
    assert launch_counts() == before  # CPU tensors take the plain version
    assert len(rows) == len(want_rows) >= 2
    for got, want in zip(rows, want_rows, strict=True):
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(cmp.numpy(), want_cmp)
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(t0.numpy(), case["t0"])
    assert cmp.dtype == torch.int32 and t.dtype == torch.int64
    np.testing.assert_array_equal(
        levels.numpy(), np.bincount(np.concatenate([g for g, _ in want_rows]), minlength=q))


def _level_by_rule(args, first):
    """The level's writes ``(t, cmp, nxt, levels)`` as the kernel's rule
    states them, with ``repro.kernels.ref.pattern_cmp_ref`` for the compare:
    a first level (``t_in`` apart from ``t``) or a later one (``t_in`` is
    ``t``)."""
    win, pos, t_in, t, pi, pat_len, pat_rows, cmp, nxt, levels = args
    k = win.shape[1]
    t = (t if first else t_in).copy()
    cmp, nxt, levels = cmp.copy(), nxt.copy(), levels.copy()
    if first:
        out = pos < 0
        t[out], cmp[out], nxt[out] = t_in[out], 0, -1
    idx = np.flatnonzero(pos >= 0)
    ti, pli = t_in[idx], pat_len[pi[idx]]
    base = (ti // k) * k
    start, stop = ti - base, np.minimum(pli - base, k)
    cols = base[:, None] + np.arange(k)[None, :]
    last = pat_rows.shape[1] - 1
    pw = np.where(cols < pli[:, None],
                  pat_rows[pi[idx][:, None], np.minimum(cols, last)], 0)
    res = _pattern_cmp_ref(win[pos[idx]], pw, start, stop)
    t[idx] = ti + res[:, 1]
    cmp[idx] = res[:, 0]
    nxt[idx] = np.where((res[:, 0] == 0) & (t[idx] < pli), t[idx], -1)
    levels[idx] += 1
    return t, cmp, nxt, levels


def _tensors(args, first):
    """Fresh tensors of ``args``; ``t_in`` is ``t`` for a later level."""
    got = [torch.from_numpy(a.copy()) for a in args]
    if not first:
        got[3] = got[2]
    return got


@pytest.mark.parametrize("name,k", LEVEL_PARAMS)
def test_level_ref_one_call(name, k):
    """One call on every row of a case at its first level (``t0 == plen``
    rows included, windows in a shuffled order), as a first level and as a
    later one, with and without ``levels``: rows out of play set on a first
    level and untouched on a later one; then a level with no row in play."""
    args = level_args(level_case(name, k), k)
    for first in (True, False):
        want = _level_by_rule(args, first)
        for with_levels in (True, False):
            got = _tensors(args, first)
            if not with_levels:
                got[9] = None
            before = launch_counts()
            assert ops.pattern_cmp_level(*got) is None
            assert launch_counts() == before
            for i, w in zip((3, 7, 8, 9), want, strict=True):
                if got[i] is not None:
                    np.testing.assert_array_equal(got[i].numpy(), w)
            if first:
                np.testing.assert_array_equal(got[2].numpy(), args[2])
    idle = list(args)
    idle[0], idle[1] = args[0][:0], np.full_like(args[1], -1)
    for first in (True, False):
        got = _tensors(idle, first)
        ops.pattern_cmp_level(*got)
        for i, w in zip((3, 7, 8, 9), _level_by_rule(idle, first), strict=True):
            np.testing.assert_array_equal(got[i].numpy(), w)


def test_level_cuts_pattern_tokens_to_int32():
    """Pattern tokens of 2^31 and up compare cut to int32 on the kernel
    route, as on ``repro``'s (2^31 + 5 below every suffix token, 2^32 + 3
    equal to a 3); the engine's plain route (``use_pallas`` off) compares
    them whole, as ``repro``'s ``masked_cmp_np`` does."""
    args = [torch.from_numpy(a.copy()) for a in level_args(level_case("edge", 4), 4)]
    assert args[6][7, 1] == 2**31 + 5 and args[6][8, 1] == 2**32 + 3
    assert args[0][args[1][8], 1] == 3
    kernel = [a.clone() for a in args]
    ref.pattern_cmp_level_ref(*kernel)
    from repro_torch.core.search import compare_level

    plain = [a.clone() for a in args]
    compare_level(*plain)
    # (cmp, t) of rows 7 and 8; row 8's last token, 9, is above its suffix's
    assert [(int(kernel[7][r]), int(kernel[3][r])) for r in (7, 8)] == [(1, 1), (-1, 2)]
    assert [(int(plain[7][r]), int(plain[3][r])) for r in (7, 8)] == [(-1, 1), (-1, 1)]


def test_pattern_cmp_level_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in level_args(level_case("edge", 4), 4)]
    before = (pc_mod.pattern_cmp.launches, pc_mod.pattern_cmp_level.launches)
    with pytest.raises(ValueError, match="pattern_cmp_level: win"):
        pc_mod.pattern_cmp_level(*args)
    assert (pc_mod.pattern_cmp.launches, pc_mod.pattern_cmp_level.launches) == before


STORE_COUNTERS = ("rounds", "requests", "request_bytes", "response_bytes",
                  "peak_windows", "peak_resident_bytes")
# per backend kind: the corpus, and the backend counters both packages keep
ENGINE_BACKENDS = {"chunked": ("variable reads", ("cache_hits", "cache_misses")),
                   "flaky": ("random text", ("injected", "gather_calls",
                                             "retry_attempts", "retried_calls"))}


def _backends(kind, corpus, tmp_path):
    """The backend of each package: the chunked file behind a small cache,
    or a ``FlakyBackend`` failing every third gather twice, under a
    ``RetryingBackend`` (no backoff) over the in-memory corpus."""
    rcfg, pcfg = RefConfig(**SEARCH_CFG), SAConfig(**SEARCH_CFG)
    if kind == "chunked":
        path = str(tmp_path / "c.sachunk")
        write_chunked_corpus(corpus, path, chunk_items=3)
        return (ref_store.ChunkedFileBackend(path, rcfg, cache_budget_bytes=256),
                port_store.ChunkedFileBackend(path, pcfg, cache_budget_bytes=256,
                                              device="cpu"))
    out = []
    for m, inner in ((ref_store, ref_store.InMemoryBackend(corpus, rcfg)),
                     (port_store, port_store.InMemoryBackend(corpus, pcfg,
                                                             device="cpu"))):
        flaky = m.FlakyBackend(inner, fail_every=3, failures_per_call=2)
        out.append(m.RetryingBackend(flaky, retries=3, backoff_s=0.0))
    return tuple(out)


def _backend_counters(backend, names):
    return {n: getattr(backend, n) for n in names}  # proxies forward to inner


@pytest.mark.parametrize("with_lcp", [True, False], ids=["lcp", "no-lcp"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(ENGINE_BACKENDS))
def test_engine_round_loop_on_the_level_matches_repro(kind, shards, with_lcp, tmp_path):
    """Ranges, every ``engine_stats()`` key, the store's counters and the
    backend's of the port's kernel engine on a ``per_round`` backend equal
    ``repro``'s kernel engine (Pallas interpret mode) for a batch;
    ``compare_rounds`` counts a level a call."""
    name, names = ENGINE_BACKENDS[kind]
    corpus, sa = search_corpus(name)
    rb, pb = _backends(kind, corpus, tmp_path)
    assert pb.per_round
    rs = ref_store.CorpusStore(None, RefConfig(**SEARCH_CFG), backend=rb,
                               request_capacity=5)
    ps = port_store.CorpusStore(None, SAConfig(**SEARCH_CFG), backend=pb,
                                request_capacity=5)
    refe = ref_engine.ShardedSAEngine(
        rs, sa, lcp=ref_lcp_from_sa(rs, sa) if with_lcp else None,
        num_shards=shards, use_pallas=True)
    port = ShardedSAEngine(ps, sa, lcp=lcp_from_sa(ps, sa) if with_lcp else None,
                           num_shards=shards, use_pallas=True)
    levels = []
    real = port._compare_level

    def counted(*args):
        levels.append(int(args[0].shape[0]))  # m, the level's windows
        real(*args)

    port._compare_level = counted
    before = launch_counts()
    batch = search_patterns(corpus)[::2]
    np.testing.assert_array_equal(port.ranges(batch), refe.ranges(batch))
    assert port.engine_stats() == refe.engine_stats()
    assert ({c: getattr(ps, c) for c in STORE_COUNTERS}
            == {c: getattr(rs, c) for c in STORE_COUNTERS})
    assert _backend_counters(pb, names) == _backend_counters(rb, names)
    assert launch_counts() == before
    assert port.stats["compare_rounds"] == len(levels) > 0 and min(levels) > 0
    if kind == "flaky":
        assert pb.inner.injected > 0
    for b in (rb, pb):
        b.close()
