"""BENCHMARK.json and the files it names: every one loads, every name and
unit is of the allowed characters, and a configuration, a cell, a traffic
mix and a metric added as new files are found with no edit."""
import json
import re

import pytest

from sa_bench.harness import spec
from sa_bench.tests import tiny

ROOT = tiny.ROOT
BENCH = spec.load(ROOT)
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}
ONE_LINE = re.compile(r"[^\n\t]{1,200}")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "sa_bench/run.py"]
    assert BENCH["paths"] == ["sa_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_loads(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"])
    assert entry["file"].startswith("sa_bench/configs/")
    conf = spec.config(ROOT, BENCH, entry["name"])
    assert conf["name"] == entry["name"]
    for key in entry["reduced"]:
        assert NAME.fullmatch(key) and key in conf and key in conf["reduced_why"]
    assert ONE_LINE.fullmatch(entry["source"]) and ONE_LINE.fullmatch(entry["why"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_loads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(entry[key])
    assert entry["chips"] in (1, 4)
    traffic = spec.traffic(ROOT, entry["traffic"])
    assert (ROOT / "sa_bench" / "drivers" / f"{traffic['driver']}.py").is_file()
    spec.config(ROOT, BENCH, entry["config"])
    assert ONE_LINE.fullmatch(entry["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_loads(metric):
    assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.reader(ROOT, metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert ONE_LINE.fullmatch(metric["layer"])


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics(BENCH, cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(BENCH, cell["name"], True)


def test_added_files_are_found_with_no_edit(tmp_path):
    root = tiny.copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "sa_bench/configs/grouper-reads.json").read_text())
    conf.update(name="grouper-reads-lowcov", coverage=1)
    (root / "sa_bench/configs/grouper-reads-lowcov.json").write_text(json.dumps(conf))
    (root / "sa_bench/traffic/closed-builds-again.json").write_text(json.dumps(
        {"driver": "builds"}))
    (root / "sa_bench/metrics/build_seconds_max.py").write_text(
        "def read(run):\n    return max(s['seconds'] for s in run['ranks'][0]['steps'])\n")
    bench["configs"].append({"name": "grouper-reads-lowcov", "source": "a test",
                             "file": "sa_bench/configs/grouper-reads-lowcov.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "reads-lowcov-build", "config": "grouper-reads-lowcov",
                               "traffic": "closed-builds-again", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "build_seconds_max", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "a test",
                               "moves": "build_suffixes_per_s",
                               "workloads": ["reads-lowcov-build"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny.run(root, "reads-lowcov-build", traced=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"build_seconds_max"}
    assert out["metrics"]["build_seconds_max"]["value"] > 0
    out = tiny.run(root, "reads-lowcov-build")
    assert set(out["metrics"]) == {"build_suffixes_per_s", "setup_s"}
