"""Transient-failure handling for the training loop (``repro.runtime.fault``'s
counterpart).

Real clusters see preemptions, DMA timeouts, and flaky hosts.  The loop
treats a step as a *transaction*: state is only replaced on success, so a
failed step retries from the same (state, batch) — combined with the
deterministic loader this gives exactly-once step semantics.

``FaultInjector`` simulates those failures for tests (scripted step lists).

The error taxonomy is shared with the store layer
(:mod:`repro_torch.core.integrity`): :class:`TransientFault` subclasses
``TransientError`` ("may succeed on retry"), while ``CorruptionError``
("bytes on disk are wrong") is **never** retried — ``retry_step`` re-raises
it immediately regardless of the ``retryable`` allowlist, because retrying a
corrupt read can only reproduce the corruption or mask it with a different
wrong answer.  See ``docs/fault_tolerance.md``.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional, Set, Tuple, Type

from repro_torch.core.integrity import CorruptionError, TransientError

log = logging.getLogger("repro_torch.fault")


class TransientFault(TransientError):
    pass


class FaultInjector:
    """Deterministic fault simulation: raise on the given step numbers."""

    def __init__(self, fail_steps: Iterable[int] = (), max_failures_per_step: int = 1):
        self.fail_steps: Set[int] = set(fail_steps)
        self.max_per_step = max_failures_per_step
        self.counts: dict = {}
        self.injected = 0

    def maybe_fail(self, step: int):
        c = self.counts.get(step, 0)
        if step in self.fail_steps and c < self.max_per_step:
            self.counts[step] = c + 1
            self.injected += 1
            raise TransientFault(f"injected fault at step {step} (#{c + 1})")


def retry_step(
    fn: Callable,
    *args,
    retries: int = 3,
    backoff: float = 0.05,
    on_retry: Optional[Callable[[int, Exception], None]] = None,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
):
    """Run ``fn`` with transactional retry; re-raises after ``retries``.

    ``retryable`` narrows which exceptions are retried (default keeps the
    historical catch-all boundary).  :class:`CorruptionError` is always
    fatal: it propagates immediately even when the allowlist would match.
    """
    err: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except CorruptionError:
            raise  # corrupt bytes stay corrupt — retrying masks the fault
        except retryable as e:  # noqa: BLE001 — deliberate retry boundary
            err = e
            if attempt == retries:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            log.warning("step failed (attempt %d): %s — retrying", attempt + 1, e)
            time.sleep(backoff * (2**attempt))
    raise err  # type: ignore[misc]
