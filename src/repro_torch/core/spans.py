"""Host spans: named, nested intervals around the program's own phases.

``with span("sa.map", device) as sp:`` times a phase.  Every span measures
its own host seconds (``sp.host_s``: two reads of the host clock, no
synchronisation), whether tracing is on or off, so a caller may sum them.
A span *records* itself only while a ``torch.profiler`` session records
(:func:`tracing`).  Off, a span costs about a microsecond and makes no
further profiler call and no CUDA call.  A recorded span

- enters a function-scope profiler record of its name
  (``torch._C._profiler._RecordFunctionFast``), so it lands in the
  profiler's host timeline, on the clock of the device trace.  Not
  ``torch.profiler.record_function``: its user-scope range also adds an
  interval to the device's timeline, from the first kernel queued inside it
  to the last one, gaps included, which a trace would count as device work;
- where ``device`` (the device the span's work runs on) is a CUDA device,
  records a timing event on that device's current stream at its start and
  at its end: its ``device_s`` is the stream time from the end of the work
  queued before the span to the end of the work queued inside it, gaps
  included.  Elsewhere ``device_s`` is None.

A finished record is a dict: ``name``, ``id``, ``parent`` (the enclosing
span's id on the same thread, or None), ``host_s`` and ``device_s``.  Spans
nest per thread (a ``contextvars`` variable holds the innermost).  The
newest ``CAPACITY`` records stay in memory (:func:`dropped` counts the
older ones let go); :func:`records` returns them, reading the events with
one synchronisation of each stream, and :func:`clear` empties the store.  No span
synchronises or reads the device.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import time
from typing import List, Optional

import torch

CAPACITY = 1 << 16

_store: collections.deque = collections.deque(maxlen=CAPACITY)
_appended = 0
_ids = itertools.count(1)
# the innermost recorded span open in this context (each thread has its own)
_inner: contextvars.ContextVar = contextvars.ContextVar("repro_torch_span", default=None)


def tracing() -> bool:
    """Whether a span opened now records itself: a profiler records."""
    return torch.autograd._profiler_enabled()


class Span:
    """One span (:func:`span`); ``host_s`` is set when it closes."""

    __slots__ = ("_device", "_fn", "_rec", "_t0", "_token", "host_s", "name")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.host_s = 0.0
        self._device = device
        self._rec: Optional[dict] = None

    def __enter__(self) -> "Span":
        if tracing():
            self._open_record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.host_s = time.perf_counter() - self._t0
        if self._rec is not None:
            self._close_record()
        return False

    def _open_record(self) -> None:
        outer = _inner.get()
        events = None
        if self._device is not None and torch.device(self._device).type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True),
                      torch.cuda.current_stream(self._device))
            events[0].record(events[2])
        self._fn = torch._C._profiler._RecordFunctionFast(self.name)
        self._fn.__enter__()
        self._rec = {"name": self.name, "id": next(_ids),
                     "parent": outer["id"] if outer else None,
                     "host_s": 0.0, "device_s": None, "_events": events}
        self._token = _inner.set(self._rec)

    def _close_record(self) -> None:
        global _appended
        rec, self._rec = self._rec, None
        if rec["_events"] is not None:
            rec["_events"][1].record(rec["_events"][2])
        rec["host_s"] = self.host_s
        self._fn.__exit__(None, None, None)
        _inner.reset(self._token)
        _store.append(rec)
        _appended += 1


def span(name: str, device: Optional[torch.device] = None) -> Span:
    """A context manager timing the block it wraps as the span ``name``;
    ``device`` is where the block's work runs (CUDA: the record also reads
    the stream time)."""
    return Span(name, device)


def records() -> List[dict]:
    """The finished recorded spans, oldest first, with ``device_s`` read
    from their events (one synchronisation of each stream they were on)."""
    recs = sorted(_store, key=lambda r: r["id"])
    unread = [r for r in recs if r["_events"] is not None]
    for stream in {r["_events"][2] for r in unread}:
        stream.synchronize()
    for r in unread:
        start, end, _ = r["_events"]
        r["device_s"] = start.elapsed_time(end) / 1e3
        r["_events"] = None
    return [{k: v for k, v in r.items() if k != "_events"} for r in recs]


def dropped() -> int:
    """Records let go since the last :func:`clear`, the store being full."""
    return _appended - len(_store)


def clear() -> None:
    """Empty the store of finished records."""
    global _appended
    _store.clear()
    _appended = 0
