"""Host spans (``repro_torch.core.spans``) and the spans of the in-core build.

The file imports neither jax nor ``repro``; the ``gpu`` cases run on a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spans.py
"""
import dataclasses
import time
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch.config import SAConfig, SuperblockConfig
from repro_torch.core import spans
from repro_torch.core.superblock import build_suffix_array_auto
from repro_torch.data.corpus import synth_dna_reads

CFG = SAConfig(vocab_size=4, packing="base", samples_per_shard=512, use_pallas=True)
PHASES = ["sa.input", "sa.map", "sa.shuffle", "sa.sort", "sa.refine", "sa.output"]
WALLS = ("t_stage_s", "t_build_s", "t_merge_s")


@pytest.fixture(autouse=True)
def fresh_store():
    spans.clear()
    yield
    spans.clear()


def _reads():
    return synth_dna_reads(300, 40, seed=3)  # 16x coverage: ties for rounds


def _profiled(fn):
    """``fn()`` under a host-only profiler session (spans record), and the
    session's host events by name as ``[(start_ns, end_ns), ...]``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        events.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out, events


def _traced_build(sb=None):
    res, events = _profiled(
        lambda: build_suffix_array_auto(_reads(), cfg=CFG, sb=sb, device="cpu"))
    return res, events


@pytest.fixture(scope="module")
def traced():
    """One traced in-core build: its result, its span records and the
    profiler's host events."""
    spans.clear()
    res, events = _traced_build()
    recs = spans.records()
    spans.clear()
    return res, recs, events


def test_tracing_off_records_nothing():
    with spans.span("a") as sp:
        with spans.span("b", torch.device("cpu")):
            time.sleep(0.001)
    assert not spans.tracing() and spans.records() == []
    assert sp.host_s >= 0.001


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")],
                         ids=["none", "cpu_str", "cpu"])
def test_tracing_on_records(device):
    def work():
        assert spans.tracing()
        with spans.span("a", device) as sp:
            torch.ones(8).sum()
        return sp

    sp, _ = _profiled(work)
    (rec,) = spans.records()
    assert rec == {"name": "a", "id": rec["id"], "parent": None,
                   "host_s": sp.host_s, "device_s": None}
    assert rec["host_s"] > 0


def test_parent_ids_nest():
    def work():
        with spans.span("outer"):
            with spans.span("build"):
                with spans.span("phase"):
                    with spans.span("inner"):
                        pass
                with spans.span("phase2"):
                    pass

    _profiled(work)
    recs = spans.records()
    by = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["outer", "build", "phase", "inner", "phase2"]
    assert by["outer"]["parent"] is None
    assert by["build"]["parent"] == by["outer"]["id"]
    assert by["phase"]["parent"] == by["phase2"]["parent"] == by["build"]["id"]
    assert by["inner"]["parent"] == by["phase"]["id"]


def test_a_failing_block_closes_its_span():
    def work():
        with pytest.raises(ValueError), spans.span("a"):
            raise ValueError
        with spans.span("b"):
            pass

    _profiled(work)
    assert [(r["name"], r["parent"]) for r in spans.records()] == [("a", None), ("b", None)]


def test_the_store_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(spans, "_store", deque(maxlen=3))

    def work():
        for i in range(5):
            with spans.span(f"s{i}"):
                pass

    _profiled(work)
    assert [r["name"] for r in spans.records()] == ["s2", "s3", "s4"]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_spans_land_in_the_profilers_timeline():
    """Each recorded span is one host event of the profiler's timeline, on
    the clock of its device trace, as long as the span's own host time."""
    def work():
        with spans.span("clock.outer"):
            torch.ones(64).sum()
            with spans.span("clock.inner"):
                time.sleep(0.002)

    _, events = _profiled(work)
    recs = spans.records()
    assert [r["name"] for r in recs] == ["clock.outer", "clock.inner"]
    (outer,), (inner,) = events["clock.outer"], events["clock.inner"]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    for r, (start, end) in zip(recs, (outer, inner)):
        assert abs((end - start) / 1e9 - r["host_s"]) < 1e-3


def test_build_phases_in_order(traced):
    """The phase spans are the build's children, in order, back to back
    inside it on the profiler's timeline."""
    _, recs, events = traced
    (build,) = [r for r in recs if r["name"] == "sa.build"]
    assert build["parent"] is None
    kids = [r for r in recs if r["parent"] == build["id"]]
    assert [r["name"] for r in kids] == PHASES
    (outer,) = events["sa.build"]
    spans_at = [events[name] for name in PHASES]
    assert all(len(s) == 1 for s in spans_at)
    spans_at = [s[0] for s in spans_at]
    assert outer[0] <= spans_at[0][0] and spans_at[-1][1] <= outer[1]
    for a, b in zip(spans_at, spans_at[1:]):
        assert a[1] <= b[0]
    assert sum(r["host_s"] for r in kids) <= build["host_s"]


def test_build_rounds_and_fetches_match_stats(traced):
    res, recs, _ = traced
    (refine,) = [r for r in recs if r["name"] == "sa.refine"]
    rounds = [r for r in recs if r["name"] == "sa.refine.round"]
    assert res.stats["iters"] > 0 and len(rounds) == res.stats["iters"]
    assert all(r["parent"] == refine["id"] for r in rounds)
    fetches = [r for r in recs if r["name"] == "sa.store.fetch"]
    round_ids = {r["id"] for r in rounds}
    assert len(fetches) == len(rounds) and {r["parent"] for r in fetches} == round_ids
    groups = [r for r in recs if r["name"] == "sa.run_groups"]
    (sort,) = [r for r in recs if r["name"] == "sa.sort"]
    assert [r["parent"] for r in groups] == [sort["id"], *sorted(round_ids)]


@pytest.mark.parametrize("sb", [None, SuperblockConfig(num_superblocks=3)],
                         ids=["in_core", "out_of_core"])
def test_tracing_changes_no_result(sb):
    off = build_suffix_array_auto(_reads(), cfg=CFG, sb=sb, device="cpu")
    assert spans.records() == []
    on, _ = _traced_build(sb)
    assert spans.records()
    np.testing.assert_array_equal(on.suffix_array, off.suffix_array)
    assert dataclasses.asdict(on.footprint) == dataclasses.asdict(off.footprint)
    assert ({k: v for k, v in on.stats.items() if k not in WALLS}
            == {k: v for k, v in off.stats.items() if k not in WALLS})


def test_out_of_core_walls_come_from_spans():
    off = build_suffix_array_auto(_reads(), cfg=CFG, sb=SuperblockConfig(num_superblocks=3),
                                  device="cpu")
    assert all(isinstance(off.stats[k], float) and off.stats[k] > 0 for k in WALLS)
    res, _ = _traced_build(SuperblockConfig(num_superblocks=3))
    recs = spans.records()
    for key, name in zip(WALLS, ("sb.stage", "sb.block", "sb.merge")):
        mine = [r["host_s"] for r in recs if r["name"] == name]
        assert len(mine) == (1 if name == "sb.merge" else 3)
        assert res.stats[key] == round(sum(mine), 6)
    blocks = [r for r in recs if r["name"] == "sb.block"]
    inner = [r for r in recs if r["name"] == "sa.build"]
    assert [r["parent"] for r in inner] == [r["id"] for r in blocks]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device_s is read from CUDA events")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_run_groups_device_time_on_card():
    """``sa.run_groups``' device seconds agree with CUDA events around
    ``run_starts`` alone: the scan is the span's work.  Both run once first,
    so that no kernel loads inside a timed call; the least of three calls
    each is compared."""
    dev = _card()
    from repro_torch.core.distributed import run_starts
    from repro_torch.core.pipeline import _run_groups

    gen = torch.Generator(device=dev).manual_seed(5)
    n = 1 << 25
    key = torch.randint(0, 1 << 12, (n,), device=dev, dtype=torch.int32, generator=gen)
    key = torch.sort(key).values
    validr = torch.ones(n, dtype=torch.bool, device=dev)
    eq = torch.zeros(n, dtype=torch.bool, device=dev)
    eq[1:] = key[1:] == key[:-1]
    want = run_starts(eq)
    assert torch.equal(_run_groups([key], validr), want)
    alone = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run_starts(eq)
        end.record()
        torch.cuda.synchronize()
        alone.append(start.elapsed_time(end) / 1e3)

    def work():
        for _ in range(3):
            torch.cuda.synchronize()
            _run_groups([key], validr)

    _profiled(work)
    got = [r["device_s"] for r in spans.records() if r["name"] == "sa.run_groups"]
    assert len(got) == 3
    assert min(alone) * 0.9 <= min(got) <= min(alone) * 1.1 + 1e-3, (got, alone)


@pytest.mark.gpu
def test_cpu_build_has_no_device_time_beside_a_card():
    """A build on the CPU reads no stream time, even in a process that has
    already used the card: a span's device is where its work runs."""
    dev = _card()
    torch.ones(4, device=dev).sum().item()
    assert torch.cuda.is_initialized()
    _traced_build()
    recs = spans.records()
    assert {r["name"] for r in recs} >= {"sa.build", *PHASES}
    assert all(r["device_s"] is None for r in recs)
