"""World size > 1: ``repro_torch`` on D gloo ranks against ``repro`` on D
fake CPU devices, bit for bit.

For D in {3, 4}: one subprocess runs ``repro`` with
``--xla_force_host_platform_device_count=D`` and one ``torch.multiprocessing``
spawn runs D gloo ranks (a ``file://`` rendezvous in the test's temporary
directory); each runs every case of ``tests/_torch_dist_cases.py`` with
``use_pallas`` off and on (on the CPU, "on" is the dispatchers' plain
versions, ``bucket_hist``'s among them).  The suffix array, every
``Footprint`` field and every ``stats`` entry must be equal, and every rank's
result equal to rank 0's.  The cases are ``tests/test_sa_distributed.py``'s
8-device builds at 3 and 4 devices, the rank store with a tight capacity, a
fetch capacity that forces retries, a shuffle capacity that drops, and
``tests/test_refiner.py``'s skewed-tie refinement.  Then the out-of-core
paths at one rank, and the partition's routing through ``bucket_hist``.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_dist_cases as cases
from repro_torch.config import SAConfig
from repro_torch.core import distributed
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.kernels import ops
from repro_torch.launch.sa_build import backend_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
SPAWN_TIMEOUT = 300


def spawn_ranks(d, out_dir):
    """Run ``cases.port_rank`` on d gloo ranks; returns each rank's results."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(cases.port_rank, args=(d, str(out_dir)),
                             nprocs=d, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{d} ranks did not finish in {SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(d):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def repro_results(d, out_dir):
    path = os.path.join(out_dir, "repro.pkl")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d}",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), TESTS]))
    proc = subprocess.run(
        [sys.executable, "-c", f"import _torch_dist_cases as c; c.repro_main({path!r})"],
        capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=[3, 4], ids=["d3", "d4"])
def both(request, tmp_path_factory):
    """(d, repro's results, every rank's results) at d devices / ranks."""
    d = request.param
    out = tmp_path_factory.mktemp(f"dist{d}")
    return d, repro_results(d, out), spawn_ranks(d, out)


def _equal(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", list(cases.CASES))
def test_ranks_match_repro(both, name, use_pallas):
    d, want, ranks = both
    got = ranks[0][name, use_pallas]
    _equal(got, want[name, use_pallas], name)
    for rank, res in enumerate(ranks[1:], 1):
        _equal(res[name, use_pallas], got, f"rank {rank}")
    builder, kind, fields = cases.CASES[name]
    if builder == "rank_store":
        assert int(got["fetch_dropped"].sum()) > 0 and int(got["write_dropped"].sum()) > 0
        return
    data, lengths = cases.corpus(kind)
    if builder == "refine":
        full = naive_sa_text(data)
        np.testing.assert_array_equal(got["sa"], full[np.isin(full, np.arange(300, 500))])
        return
    stats = got["stats"]
    if name == "retries":
        assert stats["retries"] > 0
    elif name == "drops":
        assert stats["dropped"] > 0
    else:  # right, and spread over the ranks
        oracle = naive_sa_text(data) if data.ndim == 1 else naive_sa_reads(data, lengths)
        np.testing.assert_array_equal(got["sa"], oracle)
        assert stats.get("unresolved", 0) == 0
        # TeraSort ships the padding reads' sentinel rows and counts their
        # overflow as drops, as repro does (ROADMAP.md section 3)
        assert builder == "terasort" or stats["dropped"] == 0
        if builder == "scheme":
            assert len(stats["per_device_counts"]) == d
            assert sum(c > 0 for c in stats["per_device_counts"]) > 1


@pytest.mark.parametrize("name", [n for n, c in cases.CASES.items()
                                  if c[0] != "rank_store"])
def test_kernel_path_partitions_through_bucket_hist(both, name):
    """Under use_pallas every partition of the case went through the
    bucket_hist dispatcher (its plain version on the CPU); without it none."""
    _, _, ranks = both
    for res in ranks:
        assert res[name, True, "bucket_hist calls"] > 0
        assert res[name, False, "bucket_hist calls"] == 0


def test_out_of_core_paths_run_at_one_rank():
    """Without a process group the out-of-core, journaled and indexed paths
    build on the single-rank handle (their D-rank runs are
    ``tests/test_torch_distributed_ooc.py`` and ``_index.py``)."""
    reads = cases._reads()
    oracle = naive_sa_reads(reads)
    for res in (cases.run_superblock(), cases.run_auto_out_of_core()):
        np.testing.assert_array_equal(res.suffix_array, oracle)
        assert res.stats["superblocks"] == 2
    assert cases.run_journal().appended == 0
    np.testing.assert_array_equal(cases.run_index_build().sa, oracle)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_partition_is_lex_bucket_with_the_dump_bucket(monkeypatch, use_pallas):
    rng = np.random.default_rng(7)
    kh, kl = (torch.from_numpy(rng.integers(-3, 4, size=200).astype(np.int32))
              for _ in range(2))
    sh, sl = (torch.tensor([-2, 0, 0, 3], dtype=torch.int32),
              torch.tensor([1, -1, 2, 0], dtype=torch.int32))
    valid = torch.from_numpy(rng.random(200) < 0.8)
    calls = []
    real = ops.bucket_hist
    monkeypatch.setattr(ops, "bucket_hist",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    rec = torch.stack([kh, kl], dim=1)  # strided columns, as the Map's records
    cfg = SAConfig(vocab_size=4, use_pallas=use_pallas)
    got = distributed.partition(rec[:, 0], rec[:, 1], sh, sl, cfg, valid)
    want = torch.where(valid, distributed.lex_bucket(kh, kl, sh, sl), 5)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert len(calls) == int(use_pallas)
    assert all(t.is_contiguous() for t in (calls[0] if calls else ()))
    # one rank: no splitter, nothing launched, every valid key in bucket 0
    calls.clear()
    s_hi, s_lo = distributed.sample_splitters(kh, kl, 8)
    got = distributed.partition(kh, kl, s_hi, s_lo, cfg, valid)
    assert calls == [] and torch.equal(got, torch.where(valid, 0, 1).to(torch.int32))


def test_backend_choice_by_device_count(monkeypatch):
    assert backend_for("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert backend_for("cuda", 4) == "nccl"
    assert backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for("cuda", 4) == "gloo"  # four ranks share one card
    assert backend_for("cuda", 1) == "nccl"


def test_single_rank_handle_without_a_process_group():
    assert distributed.world() == distributed.SINGLE
    buf = torch.arange(6).reshape(1, 3, 2)
    assert distributed.exchange(buf) is buf
    assert torch.equal(distributed.all_gather(buf[0, :, 0]), buf[:, :, 0])
    x = torch.tensor(5)
    assert distributed.psum(x) is x and distributed.pmax(x) is x
    with pytest.raises(ValueError, match="not initialized"):
        distributed.world(object())
