"""Step-time monitoring + straggler detection (``repro.runtime.monitor``'s
counterpart).

On a large mesh a straggling host shows up as a step-time outlier (all
collectives serialize on the slowest participant).  The monitor keeps a
rolling window of step times, flags p99/p50 outliers, and the loop can react
(log, checkpoint early, or request an elastic replan).  ``clock`` is the
time source (``time.perf_counter``; a test passes its own)."""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, List, Optional


class StepMonitor:
    def __init__(self, window: int = 100, straggler_factor: float = 3.0,
                 clock: Callable[[], float] = time.perf_counter):
        self.times: Deque[float] = deque(maxlen=window)
        self.factor = straggler_factor
        self.straggler_events: List[dict] = []
        self._t0: Optional[float] = None
        self._clock = clock
        self.step = 0

    def start(self):
        self._t0 = self._clock()

    def stop(self, step: int) -> dict:
        now = self._clock()
        dt = now - (now if self._t0 is None else self._t0)
        self.step = step
        info = {"step": step, "sec": dt}
        if len(self.times) >= 10:
            p50 = self.percentile(50)
            if dt > self.factor * p50:
                info["straggler"] = True
                self.straggler_events.append(info)
        self.times.append(dt)
        return info

    def percentile(self, q: float) -> float:
        if not self.times:
            return 0.0
        xs = sorted(self.times)
        i = min(len(xs) - 1, int(len(xs) * q / 100))
        return xs[i]

    def summary(self) -> dict:
        return {
            "steps": self.step + 1,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "stragglers": len(self.straggler_events),
        }
