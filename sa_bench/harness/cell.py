"""One run of one cell: set-up, the measured window, the check, the result.

A cell's traffic mix names its driver (``sa_bench/drivers/<driver>.py``);
the cell's ``chips`` are its ranks.  Each rank is one process on one device
(one CPU process each on the CPU): rank 0 is the calling
process, ranks 1.. are spawned and join it over NCCL (gloo on the CPU) at
``tcp://localhost``.  On every rank: the workload driver's set-up and warm
step, then a closed loop of steps until ``seconds`` have passed (every rank
takes the same number of steps), the device's peak read, the program's state
freed, and every step's output compared by the workload driver with the
plain reference.  Rank 0 gathers the ranks' records and the metric readers
(``sa_bench/metrics/<metric>.py``) turn them into the result line.
"""
from __future__ import annotations

import gc
import importlib
import socket
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Optional

from sa_bench.harness import guard as guard_mod
from sa_bench.harness import spec
from sa_bench.harness.trace import breakdown, busy_seconds, kernel_seconds, timeline

GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 120
CHECK_LIMIT = 0  # output entries that may differ from the reference: exact


def _log(rank: int, text: str) -> None:
    import sys

    print(f"sa_bench rank {rank}: {text}", file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def _all_max(flag: int, world: int, device: str) -> int:
    if world == 1:
        return flag
    import torch
    import torch.distributed as dist

    t = torch.tensor([flag], dtype=torch.int64,
                     device="cpu" if device == "cpu" else torch.cuda.current_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _measure(root: Path, cell_name: str, seed: int, seconds: float, traced: bool,
             device: str, rank: int, world: int, t0: float, guard) -> Optional[dict]:
    """This rank's run; rank 0 returns the gathered record, the others None."""
    import torch
    import torch.distributed as dist

    bench = spec.load(root)
    wl = spec.cell(bench, cell_name)
    traffic = spec.traffic(root, wl["traffic"])
    conf = spec.config(root, bench, wl["config"])
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
    t_made = time.perf_counter()
    driver = spec.driver(root, traffic["driver"])(conf, traffic, seed, device)
    t_warm = time.perf_counter()
    driver.warm()
    _sync(device)
    _log(rank, f"set-up: {t_made - t0:.3f} s to the driver, {t_warm - t_made:.3f} s its "
               f"inputs, {time.perf_counter() - t_warm:.3f} s the warm step")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if traced:  # started before the window: the profiler's own start-up is not traced work
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([] if device == "cpu" else [ProfilerActivity.CUDA])
        prof = profile(activities=acts)
        prof.__enter__()
        _sync(device)
    if world > 1:
        dist.barrier()
    start = time.perf_counter()
    start_ns = time.time_ns()
    setup_s = start - t0
    steps = []
    try:
        while True:
            steps.append(driver.step())
            end = time.perf_counter()
            end_ns = time.time_ns()
            if _all_max(int(end - start >= seconds), world, device):
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = end - start
    peak = 0 if device == "cpu" else int(torch.cuda.max_memory_allocated(dev))
    mine = {"steps": steps, "peak_bytes": peak, "window_s": window_s, "setup_s": setup_s}
    if prof is not None:
        tl = timeline(prof, start_ns, end_ns)
        del prof
        mine.update(busy_s=busy_seconds(tl), kernel_s=kernel_seconds(tl),
                    breakdown=breakdown(tl))
        del tl
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    mine["wrong"] = driver.wrong(dev)
    _log(rank, f"set-up {setup_s:.3f} s; {len(steps)} steps in {window_s:.3f} s ("
               + ", ".join(f"{x['seconds']:.3f}" for x in steps)
               + f" s); peak {peak} B; check {time.perf_counter() - t_check:.3f} s")
    mine["check"] = driver.check_name
    del driver
    mine["findings"] = guard_mod.findings(guard)
    if world == 1:
        return {"ranks": [mine]}
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    return {"ranks": gathered} if rank == 0 else None


def _rank(root, cell_name, seed, seconds, traced, device, rank, world, port, t0,
          guard, prelude):
    import torch

    if prelude:
        module, fn = prelude.split(":")
        getattr(importlib.import_module(module), fn)()
    if device != "cpu":
        torch.cuda.set_device(rank)
    if world == 1:
        return _measure(root, cell_name, seed, seconds, traced, device, rank, world,
                        t0, guard)
    import torch.distributed as dist

    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    out = _measure(root, cell_name, seed, seconds, traced, device, rank, world, t0, guard)
    # only after a run that ended: a failed rank leaves at once, rather than wait
    # in the group for ranks that are still inside a collective
    dist.destroy_process_group()
    return out


def _build_kernels() -> None:
    """Compile the port's kernels missing from the checkout before the ranks
    start, which would otherwise race to compile and load the same library in
    a checkout's first run (``repro_torch.kernels._build``)."""
    from repro_torch.kernels import _build

    _build.build()


def _watch(procs, stop: threading.Event) -> None:
    """Ends this process and every rank as soon as a spawned rank fails,
    rather than leave rank 0 waiting in a collective for a rank that is
    gone.  Only this thread reaps the ranks until ``stop`` is set."""
    import os
    import sys
    from multiprocessing.connection import wait

    live = list(procs)
    while live and not stop.is_set():
        for sentinel in wait([p.sentinel for p in live], timeout=0.5):
            p = next(q for q in live if q.sentinel == sentinel)
            live.remove(p)
            if p.exitcode != 0:
                print(f"sa_bench: rank process {p.name} exited with {p.exitcode}",
                      file=sys.stderr, flush=True)
                for q in procs:
                    q.kill()
                os._exit(4)


def _child(root, cell_name, seed, seconds, traced, device, rank, world, port,
           prelude) -> None:
    """A spawned rank (1..): its own guard, no result of its own."""
    import os
    import sys

    guard = guard_mod.ReadGuard(root)
    try:
        _rank(Path(root), cell_name, seed, seconds, traced, device, rank, world, port,
              time.perf_counter(), guard, prelude)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def gathered_run(root: Path, cell_name: str, seed: int, seconds: float, traced: bool,
                 device: str, t0: float, guard, prelude: Optional[str] = None) -> dict:
    """Every rank's record of one run (rank 0's process runs rank 0)."""
    import multiprocessing as mp

    world = int(spec.cell(spec.load(root), cell_name)["chips"])
    if world == 1:
        return _rank(root, cell_name, seed, seconds, traced, device, 0, 1, 0, t0,
                     guard, prelude)
    if device != "cpu":
        _build_kernels()
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(str(root), cell_name, seed, seconds,
                                              traced, device, r, world, port, prelude),
                         daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    stop = threading.Event()
    watcher = threading.Thread(target=_watch, args=(procs, stop), daemon=True)
    watcher.start()
    try:
        out = _rank(root, cell_name, seed, seconds, traced, device, 0, world, port, t0,
                    guard, prelude)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        stop.set()
        watcher.join()
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes exited with {bad}")
    return out


def result(root: Path, cell_name: str, traced: bool, run: dict, device_kind: str) -> dict:
    """The result line of a run whose ranks' records are ``run``."""
    bench = spec.load(root)
    wl = spec.cell(bench, cell_name)
    ranks = run["ranks"]
    attempted = len(ranks[0]["steps"])
    wrong_by_step = [sum(r["wrong"][i] for r in ranks) for i in range(attempted)]
    wrong = sum(wrong_by_step)
    failed = sum(1 for w in wrong_by_step if w > CHECK_LIMIT)
    record = dict(run, cell=cell_name, config=spec.config(root, bench, wl["config"]),
                  traffic=spec.traffic(root, wl["traffic"]), world=len(ranks))
    metrics = {}
    for m in spec.metrics(bench, cell_name, traced):
        value = spec.reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    out = {"correct": attempted > 0 and wrong <= CHECK_LIMIT, "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = sum(r.get("busy_s", 0.0) for r in ranks) / len(ranks)
        device["window_s"] = ranks[0]["window_s"]
        if "breakdown" in ranks[0]:
            out["breakdown"] = ranks[0]["breakdown"]
    out["checks"] = {ranks[0]["check"]: {"value": wrong, "limit": CHECK_LIMIT}}
    return out
