"""Streaming, journaled, sanitized and indexed builds at world size > 1:
``repro_torch`` on D gloo ranks against ``repro`` on D fake CPU devices.

For D in {3, 4}, with ``use_pallas`` off and on, the cases of
``tests/_torch_dist_ooc_cases.py``'s ``index`` group (the 101 x 17 reads,
S = 3, the LCP):

* streaming from the chunked store at a quarter of the corpus bytes into an
  index directory: rank 0 writes it, and its files equal repro's byte for
  byte (the manifest less its walls and self-crc);
* the sanitizer on: its checks, oracle windows and pairs equal repro's on
  every rank;
* a journaled build killed on every rank at the last ``build:block`` and at
  the first ``merge:rank``, then resumed: equal to repro resuming a copy of
  the same killed state;
* a resume refused for a fingerprint mismatch, and for a corrupt journal:
  every rank raises what repro raises, and none hangs (the process group
  times out in 60 s);
* ``SuffixArrayIndex.build`` with and without ``index_dir``, then ``count``,
  ``align`` and ``locate`` batches on every rank with ``num_shards=2``:
  the answers, ``engine_stats()`` and ``stats()`` equal repro's.
"""
import numpy as np
import pytest

import _torch_dist_ooc_cases as cases
from repro_torch.core.oracle import naive_sa_reads

DS = (3, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{d: (repro's results, every rank's results)}:
    the port first (repro resumes its killed states), then both repro runs
    at once."""
    dirs = {d: str(tmp_path_factory.mktemp(f"index{d}")) for d in DS}
    ranks = {d: cases.spawn_ranks("index", d, dirs[d]) for d in DS}
    started = {d: cases.start_repro("index", d, dirs[d]) for d in DS}
    want = {d: cases.finish_repro(started[d]) for d in DS}
    return {d: (want[d], ranks[d]) for d in DS}


def _equal(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def _case(runs, d, name, use_pallas):
    want, ranks = runs[d]
    got = ranks[0][name, use_pallas]
    _equal(got, want[name, use_pallas], name)
    for rank, res in enumerate(ranks[1:], 1):
        _equal(res[name, use_pallas], got, f"rank {rank}")
    return got


ids = dict(ids=["d3", "d4"])
pallas = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])


@pytest.mark.parametrize("d", DS, **ids)
@pallas
def test_streaming_index_dir_matches_repro(runs, d, use_pallas):
    got = _case(runs, d, "stream-index", use_pallas)
    np.testing.assert_array_equal(got["sa"], naive_sa_reads(cases.READS))
    stats = got["stats"]
    assert stats["store_backend"] == "chunked" and stats["store_cache_misses"] > 0
    assert got["footprint"]["peak_resident_bytes"] <= cases.STREAM_BUDGET
    assert stats["spilled_runs"] > 0 and set(got["files"]) > set(cases.INDEX_FILES)


@pytest.mark.parametrize("d", DS, **ids)
@pallas
def test_sanitized_build_matches_repro(runs, d, use_pallas):
    got = _case(runs, d, "sanitize", use_pallas)
    assert got["stats"]["sanitized"]
    kinds = sorted(c[0] for c in got["sanitizer"])
    assert kinds == ["backend", "sink"]
    assert all(n > 0 for c in got["sanitizer"] for n in c[1:])


@pytest.mark.parametrize("d", DS, **ids)
@pallas
@pytest.mark.parametrize("kill", ["kill-last-block", "kill-first-rank"])
def test_killed_and_resumed_matches_repro(runs, d, use_pallas, kill):
    got = _case(runs, d, kill, use_pallas)
    np.testing.assert_array_equal(got["sa"], naive_sa_reads(cases.READS))
    stats = got["stats"]
    assert stats["journaled"]
    if kill == "kill-first-rank":  # every block run was durable by then
        assert stats["journal_hits"] == cases.S
    # the killed state's block records carry the D-rank block builds
    for res in runs[d][1]:
        records = res["journals"][f"{kill}-{int(use_pallas)}"]
        blocks = [r for r in records if r["t"] == "block"]
        assert blocks and all(len(r["stats"]["per_device_counts"]) == d
                              for r in blocks)


@pytest.mark.parametrize("d", DS, **ids)
@pallas
@pytest.mark.parametrize("why", ["fingerprint", "corrupt"])
def test_refused_resume_raises_on_every_rank(runs, d, use_pallas, why):
    got = _case(runs, d, f"refused-{why}", use_pallas)
    kind, text = got["refused"]
    if why == "fingerprint":
        assert kind == "ValueError" and "fingerprint mismatch" in text
    else:
        assert kind == "CorruptionError" and text == "build journal record 0"


@pytest.mark.parametrize("d", DS, **ids)
@pallas
@pytest.mark.parametrize("name", ["index", "index-dir"])
def test_index_queries_match_repro(runs, d, use_pallas, name):
    got = _case(runs, d, name, use_pallas)
    assert sum(got["count"]) > 0 and got["engine_stats"]["num_shards"] == 2
    assert got["stats"]["index_dir"] == (None if name == "index"
                                         else f"{name}-{int(use_pallas)}")
    if name == "index-dir":
        assert set(got["files"]) > set(cases.INDEX_FILES)
