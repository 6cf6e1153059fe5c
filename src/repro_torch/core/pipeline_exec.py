"""Bounded background executor for the pipelined out-of-core build.

A copy of ``repro.core.pipeline_exec`` (numpy-free, threading only), so the
port runs without the JAX package.  The merge's ``pipeline_point`` labels
are the same, so schedule-exploration tests can drive both packages alike.

All background work in this repo goes through :class:`PipelineExecutor`
(enforced by salint rule SAL008): a single worker thread draining a
bounded queue. The bound is the double-buffer depth — ``submit`` blocks
once ``depth`` tasks are in flight, so a producer can never run ahead of
the consumer by more than the configured number of buffers. That is what
keeps the staging prefetch inside ``cache_budget_bytes``: at most
``depth`` prefetched blocks are ever resident.

Guarantees:

- **FIFO ordering** — tasks run in submission order on one thread, so
  ordered side effects (spill files, output-sink writes) land in the
  same order as the synchronous path.
- **Exception propagation** — a task's exception is stored and re-raised
  (the original object, original type) from ``PipelineTask.result()``,
  ``drain()``, and ``close()``. A failed task does not kill the worker;
  later tasks still run so cleanup work can be queued behind a failure.
  The handed-off ``_value``/``_exc``/``_observed`` triple is guarded by a
  per-task lock, so claiming an exception for delivery is atomic no
  matter which thread observes it first (salint SAL009).
- **Deterministic join** — ``close()`` waits for the queue to empty and
  joins the worker thread before returning; it is idempotent and safe
  from ``finally`` blocks. The context manager form closes on exit.

Schedule exploration
--------------------

The module carries one test-only injection point: a **scheduler probe**
installed via :func:`install_schedule_probe`. With no probe installed
(the default), every hook is a single ``is None`` check — no locks, no
allocation, no behavior change. With a probe installed, the executor
reports every schedule-relevant event so a test harness can *hold* the
worker at task boundaries and release it deterministically, exploring
adversarial interleavings of staging/spill/refill against the main
thread (see ``tests/test_pipeline_exec.py`` for the JAX package's). The probe protocol (duck
typed; every method optional semantics described here is what the
executor guarantees about call placement):

- ``task_submitted(seq)`` — main thread, before the task is enqueued;
- ``before_task(seq)`` — worker thread, before the task body runs (the
  hold point: the probe may block here to delay the task);
- ``after_task(seq)`` — worker thread, after the task finished (its
  result is already visible to ``result()``);
- ``point(label)`` — main thread, at labeled pipeline points
  (:func:`pipeline_point` calls sprinkled through the build);
- ``main_blocked(where)`` / ``main_unblocked()`` — main thread, around
  any potentially-blocking wait (``result``/``drain``/``close``/full
  queue ``submit``). A probe holding the worker MUST release on
  ``main_blocked`` or the run deadlocks — the harness uses this pair to
  stay deadlock-free by construction.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Iterator, Optional

__all__ = [
    "PipelineExecutor",
    "PipelineTask",
    "install_schedule_probe",
    "pipeline_point",
]

_SENTINEL = object()

# Test-only scheduler probe (see module docstring). Installed before any
# executor is constructed and removed after it closes; the default-path
# cost is one global load + ``is None`` per hook.
_PROBE: Optional[Any] = None


@contextlib.contextmanager
def install_schedule_probe(probe: Any) -> Iterator[Any]:
    """Install a scheduler probe for the duration of a ``with`` block.

    Test-only: install before constructing the executor under test and
    keep installed until it is closed. Nesting is refused — one probe
    owns the schedule at a time.
    """
    global _PROBE
    if _PROBE is not None:
        raise RuntimeError("a schedule probe is already installed")
    _PROBE = probe
    try:
        yield probe
    finally:
        _PROBE = None


def pipeline_point(label: str) -> None:
    """Mark a labeled point in the main thread's pipeline progression.

    Free when no probe is installed; under the schedule-exploration
    harness each passed point is a preemption barrier the probe can make
    held worker tasks wait for.
    """
    if _PROBE is not None:
        _PROBE.point(label)


class PipelineTask:
    """Handle for one submitted callable; ``result()`` blocks and re-raises."""

    __slots__ = ("_done", "_lock", "_value", "_exc", "_observed", "_seq")

    def __init__(self) -> None:
        self._done = threading.Event()
        # guards _value/_exc/_observed: _finish writes them on the worker
        # thread, result()/drain()/close() read (and claim) them on
        # whatever thread observes the task — the hand-off must be atomic.
        self._lock = threading.Lock()
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._observed = False  # exception already delivered via result()
        self._seq = -1  # submission index (schedule-probe identity)

    def _finish(self, value: Any, exc: Optional[BaseException]) -> None:
        with self._lock:
            self._value = value
            self._exc = exc
        self._done.set()

    def _take_unobserved(self) -> Optional[BaseException]:
        """Atomically claim the stored exception for a first delivery;
        None when there is none or it was already delivered."""
        with self._lock:
            if self._exc is not None and not self._observed:
                self._observed = True
                return self._exc
            return None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if _PROBE is not None and not self._done.is_set():
            _PROBE.main_blocked("result")
            ok = self._done.wait(timeout)
            _PROBE.main_unblocked()
        else:
            ok = self._done.wait(timeout)
        if not ok:
            raise TimeoutError("pipeline task did not complete in time")
        with self._lock:
            exc = self._exc
            if exc is not None:
                self._observed = True
            value = self._value
        if exc is not None:
            raise exc
        return value


class PipelineExecutor:
    """Single worker thread + bounded FIFO queue (double buffer of ``depth``)."""

    def __init__(self, depth: int = 1, name: str = "pipeline") -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._pending: list[PipelineTask] = []
        self._submitted = 0
        self._closed = False
        self._worker = threading.Thread(  # salint: disable=SAL008
            target=self._run, name=name, daemon=True
        )
        self._worker.start()

    # -- worker ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _SENTINEL:
                    return
                task, fn, args, kwargs = item
                if _PROBE is not None:
                    _PROBE.before_task(task._seq)
                try:
                    value = fn(*args, **kwargs)
                except BaseException as exc:  # noqa: BLE001 - stored, re-raised
                    task._finish(None, exc)
                else:
                    task._finish(value, None)
                if _PROBE is not None:
                    _PROBE.after_task(task._seq)
            finally:
                self._queue.task_done()

    # -- producer API ----------------------------------------------------

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> PipelineTask:
        """Queue ``fn(*args, **kwargs)``; blocks while ``depth`` tasks are in flight."""
        if self._closed:
            raise RuntimeError("submit on closed PipelineExecutor")
        task = PipelineTask()
        task._seq = self._submitted
        self._submitted += 1
        self._pending.append(task)
        item = (task, fn, args, kwargs)
        if _PROBE is None:
            self._queue.put(item)
        else:
            _PROBE.task_submitted(task._seq)
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                _PROBE.main_blocked("submit")
                self._queue.put(item)
                _PROBE.main_unblocked()
        return task

    def drain(self) -> None:
        """Wait for all submitted tasks; raise the first unobserved exception
        (one already delivered through ``result()`` is not raised twice)."""
        pending, self._pending = self._pending, []
        first: Optional[BaseException] = None
        for task in pending:
            if _PROBE is not None and not task._done.is_set():
                _PROBE.main_blocked("drain")
                task._done.wait()
                _PROBE.main_unblocked()
            else:
                task._done.wait()
            if first is None:
                first = task._take_unobserved()
        if first is not None:
            raise first

    def close(self) -> None:
        """Drain the queue, join the worker. Idempotent; raises pending errors."""
        if self._closed:
            return
        self._closed = True
        if _PROBE is not None:
            _PROBE.main_blocked("close")
            self._queue.put(_SENTINEL)
            self._worker.join()
            _PROBE.main_unblocked()
        else:
            self._queue.put(_SENTINEL)
            self._worker.join()
        pending, self._pending = self._pending, []
        first: Optional[BaseException] = None
        for task in pending:
            if first is None:
                first = task._take_unobserved()
        if first is not None:
            raise first

    @property
    def alive(self) -> bool:
        return self._worker.is_alive()

    def __enter__(self) -> "PipelineExecutor":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        if exc_type is None:
            self.close()
        else:
            # Already unwinding: still join deterministically, but don't
            # let a worker error mask the caller's exception.
            try:
                self.close()
            except BaseException:  # noqa: BLE001
                pass
