"""The train launcher on D ranks: ``python -m repro_torch.launch.train``
under ``torchrun`` at D = 2 on the CPU (gloo), against the one-process
launcher, with a checkpoint and a resume.  (``repro``'s launcher builds its
mesh with ``jax.make_mesh``, whose explicit axes this jax refuses for the
model's data-sharded contractions at 2 devices, so the step itself is held
to ``repro``'s in ``tests/test_torch_train_ranks.py`` instead.)"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


LAUNCH = ["--arch", "tiny-minicpm", "--batch", "4", "--seq", "32", "--device", "cpu",
          "--lr", "1e-5", "--corpus-tokens", "20000"]


def _launch(args, d=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    pre = [sys.executable, "-m"]
    if d:
        pre += ["torch.distributed.run", "--standalone", f"--nproc-per-node={d}", "-m"]
    proc = subprocess.run(pre + ["repro_torch.launch.train", *LAUNCH, *args],
                          capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [line for line in proc.stdout.splitlines() if line]


def test_launcher_under_torchrun_checkpoints_and_resumes(tmp_path):
    """``torchrun`` at D = 2: the (2, 1) mesh, rank 0's lines, the first
    step's loss the one-process launcher's (one state, one batch), a
    checkpoint a one-process restore reads whole, and a resume."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import get_arch
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_abstract
    from repro_torch.train.step import TrainState

    ckpt = str(tmp_path / "ckpt")
    two = _launch(["--steps", "3", "--ckpt", ckpt], d=2)
    one = _launch(["--steps", "3"])
    assert two[0] == one[0].replace("devices=1", "devices=2") and two[0].endswith("devices=2")
    assert len(two) == 3 and two[1].startswith("loss ") and two[1].endswith("(3 steps, 0 retries)")
    assert two[1].split()[1] == one[1].split()[1]  # the first loss, to 3 decimals
    model = Model(get_arch("tiny-minicpm"))
    params = model.abstract()
    target = TrainState(params, adamw_abstract(params))
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [3]
    state, extra = mgr.restore(target, device="cpu")
    assert extra == {"step": 3} and int(state.opt["step"]) == 3
    resumed = _launch(["--steps", "5", "--ckpt", ckpt, "--resume"], d=2)
    assert resumed[1].endswith("(5 steps, 0 retries)")
    assert CheckpointManager(ckpt).all_steps() == [3, 5]
