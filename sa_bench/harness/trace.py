"""Reading ``torch.profiler``'s timeline: device busy time, kernel time by
name, and the breakdown a traced run prints.

Busy time is the union of the device's activity intervals (kernels,
copies, sets) over the traced window, so overlapping work counts once and
the idle share is ``1 - busy / window``.  A kernel's time is the sum of its
launches' intervals.  The kind table names what a kernel belongs to by a
substring of its name, first match wins, "elementwise" otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

KINDS = (
    ("prefix_pack", "prefix_pack"), ("window_gather", "window_gather"),
    ("pattern_search", "pattern_search"), ("pattern_cmp", "pattern_cmp"),
    ("merge_path", "merge_path"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("xmma", "matmul"), ("softmax", "softmax"),
    ("gather", "gather"),
    ("RadixSort", "sort"), ("radix", "sort"), ("sort", "sort"),
    ("scan", "scan"), ("scatter", "scatter"), ("index", "index"),
    ("reduce", "reduce"), ("Memcpy", "memcpy"), ("Memset", "memset"),
)
TOP = 10
NAME_CHARS = 96


def kind(name: str) -> str:
    return next((k for sub, k in KINDS if sub in name), "elementwise")


@dataclass
class Timeline:
    """Intervals in nanoseconds: ``device`` (name, start, end) of every
    device activity, ``host`` (name, start, end) of every host-side op, and
    the measured window (``start``, ``end``; 0 where not known)."""

    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    start: int = 0
    end: int = 0


def timeline(prof, start_ns: int = 0, end_ns: int = 0) -> Timeline:
    """The timeline of a finished ``torch.profiler.profile`` whose window
    ran from ``start_ns`` to ``end_ns`` (``time.time_ns()``, the clock of
    the profiler's timestamps)."""
    from torch.autograd import DeviceType

    out = Timeline(start=start_ns, end=end_ns)
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if dur <= 0:
            continue
        item = (ev.name(), start, start + dur)
        if ev.device_type() == DeviceType.CUDA:
            out.device.append(item)
        else:
            out.host.append(item)
    return out


def merged(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def busy_seconds(tl: Timeline) -> float:
    return sum(e - s for s, e in merged((s, e) for _, s, e in tl.device)) / 1e9


def kernel_seconds(tl: Timeline) -> dict:
    """Device seconds by activity name."""
    out: dict = {}
    for name, s, e in tl.device:
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def _host_at(tl: Timeline, t: int) -> str:
    """The innermost host op running at ``t``."""
    best = None
    for name, s, e in tl.host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "no torch op (Python, numpy)"


def breakdown(tl: Timeline) -> dict:
    """``device_ops``: the device activities that took most time, by name
    with their kind; ``idle_gaps``: the longest gaps between device
    activities, each named by what the host was running at its middle."""
    by_name = sorted(kernel_seconds(tl).items(), key=lambda x: -x[1])[:TOP]
    busy = merged((s, e) for _, s, e in tl.device)
    if busy and tl.start <= busy[0][0] and busy[-1][1] <= tl.end:
        # the window's edges, where the two clocks agree
        busy = [(tl.start, tl.start), *busy, (tl.end, tl.end)]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    return {
        "device_ops": [[f"{kind(n)}: {n[:NAME_CHARS]}", t] for n, t in by_name],
        "idle_gaps": [[_host_at(tl, (s + e) // 2)[:NAME_CHARS], g / 1e9]
                      for g, s, e in gaps],
    }
