"""Training on D ranks: ``repro_torch``'s train step on D gloo ranks against
``repro``'s on D fake CPU devices (GSPMD on a ``(D, 1)`` mesh).

For D in {2, 4}: one subprocess runs ``repro`` with
``--xla_force_host_platform_device_count=D`` while one
``torch.multiprocessing`` spawn runs D gloo ranks (a ``file://``
rendezvous in the test's temporary directory); each takes one step of every
case of ``tests/_torch_dist_train_cases.py`` from the same state and batch:
tiny-gemma3, tiny-mixtral with a capacity factor that makes pairs overflow,
tiny-xlstm, two microbatches with a loss mask, and a batch of 3 rows that
does not divide the ranks.  The loss, ``grad_norm`` and every leaf of the
new state (the port's gathered from its ranks) are held to ``repro``'s
within 2e-4 of each one's scale (``_torch_lm_cases.close``), ``lr``
exactly, and every rank's metrics equal rank 0's.  The D-rank checkpoint of
a state is byte for byte the one-process checkpoint of its gathered leaves,
and restores each rank's slices.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import _torch_dist_train_cases as cases
from _torch_lm_cases import close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
TIMEOUT = 300
TOL = 2e-4


def _spawn(d, out_dir):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(cases.port_rank, args=(d, str(out_dir)), nprocs=d,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{d} ranks did not finish in {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(d):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["d2", "d4"])
def both(request, tmp_path_factory):
    """(d, out_dir, repro's results, every rank's results) at d devices /
    ranks; repro's subprocess runs while the ranks do."""
    d = request.param
    out = tmp_path_factory.mktemp(f"train{d}")
    path = os.path.join(out, "repro.pkl")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d}",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), TESTS]))
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import _torch_dist_train_cases as c; c.repro_main({path!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = _spawn(d, out)
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(path, "rb") as f:
        return d, out, pickle.load(f), ranks


@pytest.mark.parametrize("name", list(cases.CASES))
def test_rank_step_matches_repro(both, name):
    d, _, want, ranks = both
    got, ref = ranks[0][name], want[name]
    for k in ("loss", "grad_norm"):
        close(got["metrics"][k], ref["metrics"][k], TOL)
    np.testing.assert_array_equal(got["metrics"]["lr"], ref["metrics"]["lr"])
    assert sorted(got["state"]) == sorted(ref["state"])
    for k, v in ref["state"].items():
        close(got["state"][k], v, TOL)
    assert int(got["state"]["opt.step"]) == 4
    for rank, res in enumerate(ranks[1:], 1):
        for k, v in got["metrics"].items():
            np.testing.assert_array_equal(res[name]["metrics"][k], v, err_msg=f"rank {rank}")


def test_rank_state_is_cut_by_the_spec_trees(both):
    """Each rank holds 1/D of every leaf whose spec names "data" and the
    whole of the others: the state bytes a rank are the spec trees'."""
    from repro_torch.config import ShardingPolicy, get_arch
    from repro_torch.core.distributed import Ranks
    from repro_torch.models.model import Model
    from repro_torch.models.params import tensor_leaves
    from repro_torch.sharding.placement import placement
    from repro_torch.sharding.rules import make_mesh
    from repro_torch.train.step import state_specs

    d, _, _, ranks = both
    mesh = make_mesh((d, 1), ("data", "model"))
    model = Model(cases.config(get_arch, "gemma3"))
    dims = placement(state_specs(model, mesh, ShardingPolicy()), mesh,
                     Ranks(rank=0, size=d)).dims
    whole = [tuple(t.shape) for t in tensor_leaves(model.abstract())]
    for res in ranks:
        local = res["gemma3"]["local_shapes"]
        assert any(dim is not None for dim in dims)
        for i, (shape, dim) in enumerate(zip(local[:len(whole)], dims, strict=False)):
            want = list(whole[i])
            if dim is not None:
                want[dim] //= d
            assert list(shape) == want


def test_rank_checkpoint_is_the_one_process_checkpoint(both):
    d, out, _, ranks = both
    one, many = os.path.join(out, "ckpt_one"), os.path.join(out, f"ckpt_d{d}")
    steps = sorted(os.listdir(one))
    assert steps == sorted(os.listdir(many)) == ["step_00000004"]
    names = sorted(os.listdir(os.path.join(one, steps[0])))
    assert names == sorted(os.listdir(os.path.join(many, steps[0])))
    assert "meta.msgpack" in names and len(names) > 2
    for n in names:
        with open(os.path.join(one, steps[0], n), "rb") as a, \
                open(os.path.join(many, steps[0], n), "rb") as b:
            assert a.read() == b.read(), n
    assert all(r["restore_equal"] for r in ranks)

