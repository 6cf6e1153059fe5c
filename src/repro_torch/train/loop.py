r"""Production training loop: checkpoint/restart, fault retry, straggler
monitoring, deterministic data, preemption hook (``repro.train.loop``'s
counterpart).

The loop is a transaction machine:

    state(step) --train_step--> state(step+1)     [retry on transient fault]
                 \--every ckpt_every--> async checkpoint (atomic publish)

Restart: ``run_training(..., resume=True)`` finds the newest checkpoint,
restores it onto the state's devices, replays the loader to the saved step
(free: batches are pure functions of the step), and continues.  Without a
``state`` the model is drawn by ``model.init`` from ``generator`` (a
``torch.Generator`` seeded with ``seed`` on ``device`` when None) on
``device`` (the card by default).  ``repro``'s ``state_shardings`` place a
restored state on a mesh; one process holds it whole on the state's
devices.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.data.loader import DeterministicLoader
from repro_torch.device import resolve_device
from repro_torch.runtime.fault import FaultInjector, retry_step
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import TrainState

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: List[float]
    monitor: Dict[str, Any]
    restored_from: Optional[int]
    retries: int


def run_training(
    model,
    train_step: Callable,
    loader: DeterministicLoader,
    tcfg: TrainConfig,
    steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    resume: bool = False,
    state: Optional[TrainState] = None,
    fault: Optional[FaultInjector] = None,
    preempt_at: Optional[int] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> LoopResult:
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = StepMonitor()
    retries = 0
    restored_from = None

    if state is None:
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(seed)
        params = model.init(generator, device=dev)
        state = TrainState(params=params, opt=adamw_init(params))
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        state, extra = mgr.restore(state)
        start = int(extra.get("step", mgr.latest_step()))
        restored_from = start
        log.info("resumed from step %d", start)

    losses: List[float] = []
    step = start
    while step < steps:
        batch = loader.batch_at(step)

        def one_step():
            if fault is not None:
                fault.maybe_fail(step)
            return train_step(state, batch)  # noqa: B023 — called in this iteration

        def on_retry(attempt, err):
            nonlocal retries
            retries += 1

        monitor.start()
        new_state, metrics = retry_step(one_step, on_retry=on_retry)
        info = monitor.stop(step)
        if info.get("straggler"):
            log.warning("straggler step %d: %.3fs", step, info["sec"])
        state = new_state  # transactional replace only on success
        losses.append(float(metrics["loss"]))
        step += 1

        if mgr is not None and step % ckpt_every == 0:
            mgr.save(step, state, extra={"step": step})
        if preempt_at is not None and step >= preempt_at:
            # preemption hook: force a final checkpoint and stop
            if mgr is not None:
                mgr.save(step, state, extra={"step": step}, blocking=True)
            return LoopResult(step, losses, monitor.summary(), restored_from,
                              retries)

    if mgr is not None:
        mgr.save(steps, state, extra={"step": steps}, blocking=True)
    return LoopResult(steps, losses, monitor.summary(), restored_from, retries)
