"""A copy of the benchmark at a size the CPU runs in seconds, for the tests.

The copy holds ``BENCHMARK.json`` and ``sa_bench/`` as they are, with every
configuration's corpus cut (reads to 300 x 40, text to 5 000 tokens); the
program under test is the one on ``sys.path``.  :func:`run` drives a whole
run of a cell on the CPU, skipping only the look for a card.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"dna_reads": {"num_reads": 300, "read_len": 40}, "text": {"length": 5000}}


def copy(dst: Path) -> Path:
    shutil.copytree(ROOT / "sa_bench", dst / "sa_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = dst / entry["file"]
        conf = json.loads(path.read_text())
        conf.update(TINY[conf["corpus_kind"]])
        path.write_text(json.dumps(conf))
    return dst


def add_four_ranks(root: Path) -> str:
    """Add to the copy at ``root`` a cell of the reads on four ranks (four
    CPU processes joined over gloo) with ``exchange_bytes_per_rank``; its name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "reads-build-4rank", "config": "grouper-reads",
                               "traffic": "closed-builds", "chips": 4,
                               "why": "the reads on four ranks"})
    bench["per_layer"].append({"name": "exchange_bytes_per_rank", "unit": "B",
                               "better": "lower", "source": "program_counter",
                               "layer": "core/distributed.py (exchange)",
                               "moves": "build_suffixes_per_s",
                               "workloads": ["reads-build-4rank"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "reads-build-4rank"


def run(root: Path, cell: str, seed: int = 2**33 + 1, seconds: float = 0.2,
        traced: bool = False, prelude=None) -> dict:
    """The result line of one CPU run of ``cell`` in the copy at ``root``."""
    from sa_bench.harness import cell as cell_mod
    from sa_bench.harness import guard

    record = cell_mod.gathered_run(root, cell, seed, seconds, traced, "cpu",
                                   time.perf_counter(), guard.ReadGuard(root),
                                   prelude=prelude)
    return cell_mod.result(root, cell, traced, record, "cpu")
