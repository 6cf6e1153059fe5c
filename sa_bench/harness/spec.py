"""What ``BENCHMARK.json`` names, found by name.

A cell names a configuration and a traffic mix; a configuration's file is
the one ``BENCHMARK.json`` gives, a traffic mix is
``sa_bench/traffic/<traffic>.json``, which names its driver,
``sa_bench/drivers/<driver>.py``, and a metric is read by
``sa_bench/metrics/<metric>.py``.  A configuration, a cell, a traffic mix or
a per-layer metric is added by adding files and entries: nothing here names
one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


def load(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(root: Path, bench: dict, name: str) -> dict:
    """The configuration file of ``name``, as run."""
    entry = _named(bench["configs"], name, "config")
    with open(Path(root) / entry["file"]) as f:
        return json.load(f)


def traffic(root: Path, name: str) -> dict:
    with open(Path(root) / BENCH_DIR.name / "traffic" / f"{name}.json") as f:
        return json.load(f)


def reports(metric: dict, cell_name: str) -> bool:
    """Whether ``cell_name`` reports ``metric``: every cell unless the metric
    lists its cells under ``workloads``."""
    return cell_name in metric.get("workloads", [cell_name])


def metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's end-to-end metrics (``traced`` False) or its per-layer
    metrics (``traced`` True), in ``BENCHMARK.json``'s order."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind] if reports(m, cell_name)]


def _module(root: Path, folder: str, name: str):
    path = Path(root) / BENCH_DIR.name / folder / f"{name}.py"
    mod_name = f"sa_bench_{folder}_" + re.sub(r"\W", "_", name)
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(root: Path, name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``sa_bench/metrics/<name>.py``: it takes a finished run's
    record and returns the metric, or None where it finds nothing to read."""
    return _module(root, "metrics", name).read


def driver(root: Path, name: str):
    """``Driver`` of ``sa_bench/drivers/<name>.py``: built from (config,
    traffic, seed, device), it runs ``warm()`` in set-up, ``step()`` a unit
    of the window's work, and ``wrong(device)`` after the window: each
    step's output entries that differ from the plain reference."""
    return _module(root, "drivers", name).Driver
