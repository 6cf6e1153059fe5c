"""A run's result line, and the run's refusals: without a card, and when the
run has loaded the JAX package or read the old benchmark."""
import json
import subprocess
import sys
import types

import pytest

from sa_bench.harness import guard, trace
from sa_bench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("sa_bench"))


def test_result_line_keys(root):
    out = tiny.run(root, "reads-build")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"build_suffixes_per_s", "setup_s"}  # no card: no peak
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] == {"sa_entries_wrong": {"value": 0, "limit": 0}}
    json.dumps(out)


def test_traced_result_line_keys(root):
    out = tiny.run(root, "reads-build", traced=True)
    assert set(out) == KEYS | {"breakdown"} and list(out)[-1] == "checks"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["metrics"]) == {"refine_rounds", "fetch_bytes_per_suffix"}


def test_four_ranks(root):
    out = tiny.run(root, tiny.add_four_ranks(root), traced=True)
    assert out["correct"] and out["device"]["count"] == 4
    assert out["metrics"]["exchange_bytes_per_rank"]["value"] > 0


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "sa_bench/run.py", "--workload", "reads-build",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tiny.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_program_no_result(tmp_path):
    root = tiny.copy(tmp_path)
    proc = subprocess.run([sys.executable, "sa_bench/run.py", "--workload", "reads-build",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


FINISH = """
import sys, time
from pathlib import Path
sys.path[:0] = {paths!r}
from sa_bench import run
from sa_bench.harness import cell, guard
root = Path({root!r})
g = guard.ReadGuard(root)
rec = cell.gathered_run(root, "reads-build", 5, 0.2, False, "cpu", time.perf_counter(), g)
sys.exit(run.finish(root, "reads-build", False, rec, "cpu", g))
"""


@pytest.mark.parametrize("planted", [False, True])
def test_a_metric_that_loads_repro_gives_no_result(tmp_path, planted):
    """The module check runs after the metric readers: a reader that loads
    a module named ``repro`` (a stub here) leaves the run without a result."""
    root = tiny.copy(tmp_path / "copy")
    stub = tmp_path / "stub"
    (stub / "repro").mkdir(parents=True)
    (stub / "repro" / "__init__.py").write_text("")
    if planted:
        reader = root / "sa_bench" / "metrics" / "build_suffixes_per_s.py"
        reader.write_text(f"import sys\nsys.path.insert(0, {str(stub)!r})\nimport repro  # noqa\n"
                          + reader.read_text())
    code = FINISH.format(paths=[str(tiny.ROOT / "src"), str(tiny.ROOT)], root=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    if planted:
        assert proc.returncode == 3 and proc.stdout == ""
        assert "rank 0: module repro" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]


def test_import_check_fires_on_a_planted_repro(monkeypatch):
    assert guard.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert guard.foreign_modules() == ["jax.numpy", "repro"]
    assert guard.foreign_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []


def test_read_guard_sees_the_old_benchmark(tmp_path):
    (tmp_path / "benchmarks").mkdir()
    (tmp_path / "benchmarks" / "x.json").write_text("{}")
    (tmp_path / "benchmarks_not").mkdir()
    g = guard.ReadGuard(tmp_path)
    with open(tmp_path / "benchmarks_not" / ".." / "BENCH.json", "w"):
        pass
    assert guard.findings(g) == []
    with open(tmp_path / "benchmarks" / "x.json"):
        pass
    assert guard.findings(g) == [f"read {tmp_path / 'benchmarks' / 'x.json'}"]


def test_busy_time_is_the_union():
    tl = trace.Timeline(device=[("a", 0, 10), ("b", 5, 20), ("c", 30, 40)],
                        host=[("aten::nonzero", 18, 35), ("aten::cat", 21, 25)])
    assert trace.busy_seconds(tl) == 30e-9
    out = trace.breakdown(tl)
    assert out["device_ops"][0] == ["elementwise: b", 15e-9]
    assert out["idle_gaps"] == [["aten::cat", 10e-9]]
    assert trace.kind("void at::native::cummax_scan_kernel") == "scan"
