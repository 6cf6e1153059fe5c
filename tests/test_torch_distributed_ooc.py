"""The out-of-core build at world size > 1: ``repro_torch`` on D gloo ranks
against ``repro`` on D fake CPU devices, bit for bit.

For D in {3, 4}, ``tests/_torch_dist_ooc_cases.py``'s merge matrix: the
101 x 17 reads and the 1000-token text, S = 3 with the LCP, merged by
``merge_path`` with the host and with the device merge, by ``kway`` and by
``rerank``, each with ``use_pallas`` off and on (on the CPU, "on" is the
dispatchers' plain versions).  Phase 2 builds every block on the D ranks,
and phase 3 runs on every rank.  The suffix array, the LCP array, every
``Footprint`` field and every stats entry but the walls (each block's
``per_device_counts`` among them) must equal repro's, and every rank's
result rank 0's.  Both sides of both D run at once.
"""
import numpy as np
import pytest

import _torch_dist_ooc_cases as cases
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text

DS = (3, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{d: (repro's results, every rank's results)}."""
    dirs = {d: str(tmp_path_factory.mktemp(f"ooc{d}")) for d in DS}
    started = {d: cases.start_repro("ooc", d, dirs[d]) for d in DS}
    try:
        ranks = {d: cases.spawn_ranks("ooc", d, dirs[d]) for d in DS}
    finally:
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


@pytest.mark.parametrize("d", DS, ids=["d3", "d4"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", cases.GROUPS["ooc"])
def test_out_of_core_ranks_match_repro(runs, d, name, use_pallas):
    want, ranks = runs[d]
    got = ranks[0][name, use_pallas]
    _equal(got, want[name, use_pallas], name)
    for rank, res in enumerate(ranks[1:], 1):
        _equal(res[name, use_pallas], got, f"rank {rank}")
    data = cases.corpus(cases.CASES[name][1])
    oracle = naive_sa_text(data) if data.ndim == 1 else naive_sa_reads(data)
    np.testing.assert_array_equal(got["sa"], oracle)
    stats = got["stats"]
    assert stats["superblocks"] == cases.S and stats["unresolved"] == 0
    assert stats["dropped"] == 0 and got["lcp"] is not None
    assert stats["merge_backend"] == cases.CASES[name][3].get("merge_backend", "host")
