"""The readers of the program's spans (``input_s``, ``output_s``, ``refine_s``,
``run_groups_s``, ``store_fetch_s``) on span records planted in the
program's store: the window's builds alone count, and a run without a card
or without spans reads nothing."""
import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import spans
from sa_bench.harness import spec
from sa_bench.tests import tiny

READERS = ("input_s", "output_s", "refine_s", "run_groups_s", "store_fetch_s")


def _build(seconds: float, rounds: int, root: str = "sa.build") -> None:
    """One build's spans as the program nests them under a root span named
    ``root``, each planted with ``seconds`` host and device seconds."""
    start = len(spans._store)
    with spans.span(root):
        for name in ("sa.input", "sa.map", "sa.shuffle"):
            with spans.span(name):
                pass
        with spans.span("sa.sort"), spans.span("sa.run_groups"):
            pass
        with spans.span("sa.refine"):
            for _ in range(rounds):
                with spans.span("sa.refine.round"):
                    with spans.span("sa.store.fetch"):
                        pass
                    with spans.span("sa.run_groups"):
                        pass
        with spans.span("sa.output"):
            pass
    for rec in list(spans._store)[start:]:
        rec.update(host_s=seconds, device_s=seconds)


@pytest.fixture
def planted():
    """An earlier run's build (100 s a span), the window's two builds (1 s
    and 3 s a span, 2 rounds each), then the same spans under a root that is
    no build."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):  # spans record
        _build(100.0, 5)
        _build(1.0, 2)
        _build(3.0, 2)
        _build(1e6, 2, root="other")
    yield {"ranks": [{"steps": [{}, {}], "peak_bytes": 1 << 30}]}
    spans.clear()


def _read(name, run):
    return spec.reader(tiny.ROOT, name)(run)


@pytest.mark.parametrize("name", READERS)
def test_reader_means_the_window_builds(planted, name):
    # per build: one input / output / refine span, three run_groups (the sort's
    # and one a round), two fetches; 1 s and 3 s a span in the two builds
    per_span = {"input_s": 1, "output_s": 1, "refine_s": 1, "run_groups_s": 3,
                "store_fetch_s": 2}[name]
    assert _read(name, planted) == pytest.approx(per_span * (1.0 + 3.0) / 2)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_card(planted, name):
    planted["ranks"][0]["peak_bytes"] = 0
    assert _read(name, planted) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_spans(planted, name, monkeypatch):
    spans.clear()
    assert _read(name, planted) is None
    monkeypatch.delitem(sys.modules, "repro_torch.core.spans")
    assert _read(name, planted) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_with_fewer_builds_than_steps(planted, name):
    planted["ranks"][0]["steps"] = [{}] * 4
    assert _read(name, planted) is None


@pytest.mark.parametrize("name", ["refine_s", "run_groups_s", "store_fetch_s"])
def test_device_reader_reads_nothing_on_the_cpu(planted, name):
    """Spans recorded on the CPU have no device seconds."""
    for rec in spans._store:
        rec["device_s"] = None
    assert _read(name, planted) is None


def test_readers_are_listed_for_the_reads_cell():
    bench = spec.load(tiny.ROOT)
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = listed[name]
        assert m["source"] == "program_span" and m["moves"] == "build_suffixes_per_s"
        assert m["workloads"] == ["reads-build"] and m["unit"] == "s"
