"""What a run may not load or read.

The program under test is the PyTorch port (``repro_torch``).  A run fails
if its process has loaded the JAX package or JAX itself (top-level module
names compared whole, so ``repro_torch`` passes and ``repro`` does not), or
if it has opened or listed anything under the repository's ``benchmarks/``
folder, the JAX package's old benchmark.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "repro"})
_EVENTS = frozenset({"open", "os.listdir", "os.scandir"})


def foreign_modules(modules=None) -> list:
    """Names in ``sys.modules`` (or ``modules``) whose top-level name is
    forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


class ReadGuard:
    """Records every path under ``root/benchmarks`` that this process opens
    or lists, through an audit hook (a hook cannot be removed, so one
    process installs one guard)."""

    def __init__(self, root: Path):
        self.forbidden = os.path.join(os.path.realpath(root), "benchmarks")
        self.seen: list = []
        sys.addaudithook(self._hook)

    def _hook(self, event: str, args: tuple) -> None:
        if event not in _EVENTS or not args:
            return
        path = args[0]
        if isinstance(path, bytes):
            path = os.fsdecode(path)
        if not isinstance(path, str):
            return
        full = os.path.realpath(path)
        if full == self.forbidden or full.startswith(self.forbidden + os.sep):
            self.seen.append(full)


def findings(guard: ReadGuard) -> list:
    """Every breach in this process: forbidden modules, then reads."""
    return ([f"module {n}" for n in foreign_modules()]
            + [f"read {p}" for p in sorted(set(guard.seen))])
