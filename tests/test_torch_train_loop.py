"""The port's training loop, launcher and example against ``repro``'s on the
CPU.  ``run_training`` on tiny-minicpm in float32 (``tests/test_fault_tolerance.py``'s
setup, batch 4 x 16, warmup 2, cosine over 50, but lr 1e-5, see below) from
one state, ``repro``'s ``Model.init(key(5))`` with the train-step tests'
moments at step 3 (``_torch_train_cases.moments``): the losses of 12 steps;
with faults injected at steps 3 and 7 (twice each) the same losses and 4
retries; preempted at step 6 and resumed, the uninterrupted run's losses
from step 6 on (rtol 1e-6, as ``repro``'s own test) and ``restored_from``
6; and the port resuming from ``repro``'s checkpoint.  The launcher and
the example print ``repro``'s lines, the losses and the monitor's times
aside.

The port's losses are held to ``repro``'s within 1e-5 relative (measured
2e-7).  One step of each package agrees within float32 round-off from any
state (``tests/test_torch_train_dense.py``), but the random-weight tiny
configs sit where the loss surface is rough: at ``repro``'s lr 1e-3 the
grad norm moves by a quarter between neighbouring states, so the two
trajectories part by 1e-3 of the loss within 8 steps whatever the
package, and at lr 1e-4 within 10.  At lr 1e-5 the parameters stay close
enough for 12 steps to compare.  From zero moments the first updates are
``lr · sign(g)``, and a grad within round-off of zero takes the other sign
in one package, so the state carries nonzero moments.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm_cases import f32, one_torch_thread  # noqa: F401
from _torch_train_cases import moments
from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_arch
from repro.data.loader import DeterministicLoader as RefLoader
from repro.models.model import Model as RefModel
from repro.runtime.fault import FaultInjector as RefFault
from repro.train.loop import run_training as ref_run
from repro.train.step import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch
from repro_torch.data.loader import DeterministicLoader
from repro_torch.models.model import Model, train_state_from_reference
from repro_torch.runtime.fault import FaultInjector
from repro_torch.sharding.rules import make_mesh
from repro_torch.train.loop import run_training
from repro_torch.train.step import make_train_step

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tiny-minicpm"
TRAIN = dict(learning_rate=1e-5, warmup_steps=2, decay_steps=50)
LOSS_RTOL = 1e-5


def _tokens(vocab):
    return (np.arange(1, 20_001) * 7 % (vocab - 1) + 1).astype(np.int32)


@pytest.fixture(scope="module")
def ref_setup():
    model = RefModel(f32(ref_arch(ARCH)))
    step = ref_train_step(model, jax.make_mesh((1, 1), ("data", "model")), RefPolicy(),
                          RefTrainConfig(**TRAIN), 4, 16, donate=False)[0]
    params = model.init(jax.random.key(5))
    m, v = moments(model)
    state = RefTrainState(params, {"step": jnp.int32(3), "master": params, "m": m, "v": v})
    loader = RefLoader(_tokens(model.cfg.vocab_size), batch=4, seq_len=16, seed=3)
    return model, step, state, loader


@pytest.fixture(scope="module")
def port_setup(ref_setup):
    _, _, ref_state, _ = ref_setup
    model = Model(f32(get_arch(ARCH)))
    step = make_train_step(model, make_mesh((1, 1), ("data", "model")), ShardingPolicy(),
                           TrainConfig(**TRAIN), 4, 16, donate=False)[0]
    np_state = jax.tree.map(np.asarray, ref_state)

    def fresh():
        return train_state_from_reference(model, np_state, device="cpu")

    loader = DeterministicLoader(_tokens(model.cfg.vocab_size), batch=4, seq_len=16, seed=3)
    return model, step, fresh, loader


@pytest.fixture(scope="module")
def ref_runs(ref_setup, tmp_path_factory):
    model, step, state, loader = ref_setup
    tcfg = RefTrainConfig(**TRAIN)
    d = tmp_path_factory.mktemp("repro_ckpt")
    full = ref_run(model, step, loader, tcfg, steps=12, state=state)
    fault = RefFault(fail_steps=[3, 7], max_failures_per_step=2)
    faulty = ref_run(model, step, loader, tcfg, steps=12, state=state, fault=fault)
    part = ref_run(model, step, loader, tcfg, steps=12, state=state, ckpt_dir=str(d),
                   ckpt_every=3, preempt_at=6)
    resumed = ref_run(model, step, loader, tcfg, steps=12, state=state, ckpt_dir=str(d),
                      resume=True, ckpt_every=100)
    return {"full": full, "faulty": faulty, "injected": fault.injected, "part": part,
            "resumed": resumed, "dir": str(d)}


def test_losses_match_repro(port_setup, ref_runs):
    """12 steps from the same state."""
    model, step, fresh, loader = port_setup
    res = run_training(model, step, loader, TrainConfig(**TRAIN), steps=12, state=fresh())
    want = ref_runs["full"]
    assert (res.final_step, res.retries, res.restored_from) == (12, 0, None)
    np.testing.assert_allclose(res.losses, want.losses, rtol=LOSS_RTOL)
    assert res.losses[-1] < res.losses[0]
    assert res.monitor["steps"] == want.monitor["steps"] == 12
    assert sorted(res.monitor) == sorted(want.monitor)


def test_fault_retries_match_repro(port_setup, ref_runs):
    model, step, fresh, loader = port_setup
    fault = FaultInjector(fail_steps=[3, 7], max_failures_per_step=2)
    res = run_training(model, step, loader, TrainConfig(**TRAIN), steps=12, state=fresh(),
                       fault=fault)
    clean = run_training(model, step, loader, TrainConfig(**TRAIN), steps=12, state=fresh())
    want = ref_runs["faulty"]
    assert (fault.injected, res.retries, res.final_step) == \
        (ref_runs["injected"], want.retries, want.final_step) == (4, 4, 12)
    assert res.losses == clean.losses  # a retried step is the same transaction
    np.testing.assert_allclose(res.losses, want.losses, rtol=LOSS_RTOL)


def test_preempt_and_resume_match_repro(port_setup, ref_runs, tmp_path):
    model, step, fresh, loader = port_setup
    tcfg = TrainConfig(**TRAIN)
    full = run_training(model, step, loader, tcfg, steps=12, state=fresh())
    part = run_training(model, step, loader, tcfg, steps=12, state=fresh(),
                        ckpt_dir=str(tmp_path), ckpt_every=3, preempt_at=6)
    assert part.final_step == ref_runs["part"].final_step == 6
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]
    resumed = run_training(model, step, loader, tcfg, steps=12, state=fresh(),
                           ckpt_dir=str(tmp_path), resume=True, ckpt_every=100)
    assert resumed.restored_from == ref_runs["resumed"].restored_from == 6
    np.testing.assert_allclose(full.losses[6:], resumed.losses, rtol=1e-6)
    np.testing.assert_allclose(resumed.losses, ref_runs["resumed"].losses, rtol=LOSS_RTOL)


def test_port_resumes_from_repros_checkpoint(port_setup, ref_runs, tmp_path):
    import shutil

    model, step, fresh, loader = port_setup
    d = tmp_path / "ckpt"
    shutil.copytree(ref_runs["dir"], d)
    for name in os.listdir(d):  # repro's resumed run wrote step 12; keep its step 6
        if name != "step_00000006":
            shutil.rmtree(d / name)
    res = run_training(model, step, loader, TrainConfig(**TRAIN), steps=12, state=fresh(),
                       ckpt_dir=str(d), resume=True, ckpt_every=100)
    assert res.restored_from == 6 and res.final_step == 12
    np.testing.assert_allclose(res.losses, ref_runs["resumed"].losses, rtol=LOSS_RTOL)


def _run(args, module=None, script=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    cmd = [sys.executable] + (["-m", module] if module else [script]) + args
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.splitlines()


LOSS_LINE = re.compile(r"loss [0-9.]+ -> [0-9.]+ \((\d+) steps, (\d+) retries\)")
MONITOR = re.compile(r"monitor: \{'steps': (\d+), 'p50': [0-9.e-]+, 'p99': [0-9.e-]+, "
                     r"'stragglers': \d+\}")


def test_launcher_prints_repros_lines(tmp_path):
    args = ["--arch", ARCH, "--steps", "4", "--batch", "4", "--seq", "16",
            "--corpus-tokens", "20000", "--dedup", "--microbatches", "2"]
    want = _run(args, module="repro.launch.train")
    got = _run(args + ["--device", "cpu", "--ckpt", str(tmp_path)],
               module="repro_torch.launch.train")
    assert got[:2] == want[:2] and got[0].startswith(f"arch={ARCH} params=0.1M devices=1")
    assert got[1].startswith("dedup: masked ")
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        pat = LOSS_LINE if g.startswith("loss") else MONITOR
        assert pat.fullmatch(g).groups() == pat.fullmatch(w).groups()
    assert os.listdir(tmp_path) == ["step_00000004"]
    more = _run(["--arch", ARCH, "--steps", "6", "--batch", "4", "--seq", "16",
                 "--corpus-tokens", "20000", "--device", "cpu", "--ckpt", str(tmp_path),
                 "--resume", "--dedup", "--microbatches", "2"],
                module="repro_torch.launch.train")
    assert LOSS_LINE.fullmatch(more[2]).groups() == ("6", "0")


def test_example_prints_repros_lines(tmp_path):
    args = ["--steps", "30", "--ckpt"]
    want = _run(args + [str(tmp_path / "repro")],
                script=os.path.join(REPO, "examples", "train_lm.py"))
    got = _run(args + [str(tmp_path / "port"), "--device", "cpu"],
               script=os.path.join(REPO, "examples", "torch_train_lm.py"))
    assert got[:3] == want[:3] == [
        "model: train-demo-3m  params=0.9M", want[1], "steps: 30  restored_from: None"]
    assert want[1].startswith("dedup: masked ")
    loss = re.compile(r"loss: ([0-9.]+) -> ([0-9.]+)")
    first, last = map(float, loss.fullmatch(got[3]).groups())
    assert last < first and loss.fullmatch(want[3])
    assert MONITOR.fullmatch(got[4]).groups() == ("30",)
    assert sorted(os.listdir(tmp_path / "port")) == ["step_00000025", "step_00000030"]
