"""The query engine's whole search on the device (``pattern_search``) against
``repro.serve.sa_engine`` on the CPU.

``kernels.ref.pattern_search_ref`` (what the CUDA kernel computes) is held to
the JAX engine's round loop: the same bounds, and a record of window levels
that gives exactly the loop's sequence of fetches.  The port's engine with
``use_pallas=True`` over an in-memory backend (one ``pattern_search`` call a
bound, its plain version on CPU tensors) is held to the JAX engine in ranges,
``engine_stats()`` and every store counter, which the port rebuilds from the
record.  The CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_kernels_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.core.lcp import lcp_from_sa as ref_lcp_from_sa
from repro.core.store import CorpusStore as RefStore
from repro.serve import sa_engine as ref_engine
from repro_torch import SAConfig, ShardedSAEngine
from repro_torch.core.lcp import lcp_from_sa
from repro_torch.core.store import CorpusStore
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.cases import (
    SEARCH_CFG, SEARCH_CORPORA, SEARCH_K, padded_patterns, search_args,
    search_corpus, search_patterns)

STORE_COUNTERS = ("rounds", "requests", "request_bytes", "response_bytes",
                  "peak_windows")


def _engines(name, shards, with_lcp, capacity):
    corpus, sa = search_corpus(name)
    rs = RefStore(corpus, RefConfig(**SEARCH_CFG), request_capacity=capacity)
    ps = CorpusStore(corpus, SAConfig(**SEARCH_CFG), request_capacity=capacity,
                     device="cpu")
    assert ps.k == SEARCH_K
    refe = ref_engine.ShardedSAEngine(
        rs, sa, lcp=ref_lcp_from_sa(rs, sa) if with_lcp else None, num_shards=shards)
    port = ShardedSAEngine(ps, sa, lcp=lcp_from_sa(ps, sa) if with_lcp else None,
                           num_shards=shards, use_pallas=True)
    return corpus, refe, port


def _counters(eng):
    return ({c: getattr(eng.store, c) for c in STORE_COUNTERS},
            eng.store.backend.cache_hits)


@pytest.mark.parametrize("capacity", [3, 4096])
@pytest.mark.parametrize("with_lcp", [True, False], ids=["lcp", "no-lcp"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("name", SEARCH_CORPORA)
def test_engine_on_pattern_search_matches_repro(name, shards, with_lcp, capacity):
    """Ranges, ``engine_stats()``, the store's counters and the backend's
    cache hits of the port's kernel engine equal the JAX engine's, a batch,
    its hot repeat and a reversed batch after another."""
    corpus, refe, port = _engines(name, shards, with_lcp, capacity)
    pats = search_patterns(corpus)
    before = launch_counts()
    for batch in (pats, pats, pats[::-1], search_patterns(corpus, seed=8)):
        np.testing.assert_array_equal(port.ranges(batch), refe.ranges(batch))
        assert port.engine_stats() == refe.engine_stats()
        assert _counters(port) == _counters(refe)
    assert launch_counts() == before  # CPU tensors take the plain version
    assert port.stats["search_rounds"] > 0


@pytest.mark.parametrize("with_lcp", [True, False], ids=["lcp", "no-lcp"])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("name", SEARCH_CORPORA)
def test_pattern_search_ref_is_the_round_loop(name, upper, shards, with_lcp):
    """The plain ``pattern_search`` against the JAX engine's ``_bound_batch``:
    the same bounds and rounds, and its ``levels`` record spell out the
    loop's fetches, round by round and level by level."""
    corpus, refe, port = _engines(name, shards, with_lcp, 4096)
    pats = search_patterns(corpus)
    rows, plen = padded_patterns(pats)
    fetches, marks = [], []
    real_fetch, real_route = refe.store.fetch_windows, refe._route

    def spy_fetch(gidx, depth):
        fetches.append(int(gidx.shape[0]))
        return real_fetch(gidx, depth)

    def spy_route(*args):
        out = real_route(*args)
        marks.append(len(fetches))  # the routing's fetches come first
        return out

    refe.store.fetch_windows, refe._route = spy_fetch, spy_route
    want = refe._bound_batch(rows, plen, upper)
    want_rounds = refe.stats["search_rounds"]

    bound, levels, active = ops.pattern_search(*search_args(port, pats, upper))
    np.testing.assert_array_equal(bound.numpy(), want)
    assert int(active.max()) == want_rounds
    assert levels.dtype == active.dtype == torch.int32
    assert levels.shape == (rows.shape[0], port._max_rounds)
    lv = levels.numpy()
    assert (lv[np.arange(lv.shape[1])[None, :] >= active.numpy()[:, None]] == 0).all()
    cells = [int((lv[:, r] > j).sum())
             for r in range(lv.shape[1]) for j in range(int(lv[:, r].max()))]
    assert cells == fetches[marks[0]:]
    assert sum(cells) > 0


@pytest.mark.parametrize("name", SEARCH_CORPORA)
def test_pattern_search_ref_at_the_boundaries(name):
    """Rows whose range is already closed take no round; an empty pattern
    matches everything; a pattern longer than every suffix matches none."""
    corpus, _, port = _engines(name, 1, True, 4096)
    flat = corpus.reshape(-1).astype(np.int64)
    flat = flat[flat > 0]  # a read's padding is no token of a pattern
    pats = [np.zeros(0, np.int64), np.concatenate([flat, [1]]), flat[:1]]
    n = port.sa.shape[0]
    args = list(search_args(port, pats, False))
    args[8] = torch.tensor([-1, -1, 4], dtype=torch.int64)  # lo
    args[9] = torch.tensor([n, n, 5], dtype=torch.int64)  # hi
    low, lv_low, act_low = ops.pattern_search(*args)
    args[10] = True  # upper
    up, _, _ = ops.pattern_search(*args)
    assert low.tolist()[0] == 0 and up.tolist()[0] == n  # empty: every suffix
    assert low.tolist()[1] == up.tolist()[1]  # longer than any suffix: none
    assert low.tolist()[2] == up.tolist()[2] == 5 and act_low.tolist()[2] == 0
    assert lv_low[2].tolist() == [0] * port._max_rounds
    assert lv_low[0].tolist() == [0] * port._max_rounds  # plen 0: no compare
