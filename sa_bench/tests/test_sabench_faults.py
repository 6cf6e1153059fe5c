"""A whole run on the CPU with the timed path broken underneath: ``correct``
has to come out false for each fault a build can have.

Each fault is planted in the program by a prelude that every rank process
runs before its set-up (``gathered_run(prelude=...)``), so the four-rank
fault reaches the spawned ranks too.
"""
import numpy as np
import pytest

from sa_bench.tests import tiny

HERE = "sa_bench.tests.test_sabench_faults"


def _wrap_finalize(change):
    from repro_torch.core import pipeline

    original = pipeline._finalize

    def finalize(*args, **kwargs):
        res = original(*args, **kwargs)
        res.suffix_array = change(np.array(res.suffix_array))
        return res

    pipeline._finalize = finalize


def unchanged_refinement():
    """A refinement step that returns its state unchanged."""
    from repro_torch.core import pipeline

    def refine(g, ih, il, exhausted, **kwargs):
        depth = ih.new_ones(ih.shape)
        zero = ih.new_zeros((), dtype=ih.dtype).long()
        stats = dict(iters=0, fetch_requests=zero, fetch_request_bytes=zero,
                     fetch_response_bytes=zero, retries=zero, max_depth=zero + 1)
        return g, ih, il, exhausted, depth, stats

    pipeline._refine_tie_groups = refine


def half_left_out():
    """Half of the suffixes left out of the result."""
    _wrap_finalize(lambda sa: sa[: len(sa) // 2])


def answer_altered():
    """Two entries of the suffix array swapped where it is produced."""
    def swap(sa):
        sa[[3, 4]] = sa[[4, 3]]
        return sa

    _wrap_finalize(swap)


def exchange_left_out():
    """The exchange between ranks left out: every rank keeps what it would
    have sent."""
    from repro_torch.core import pipeline, store

    def exchange(buf, ranks=None):
        return buf

    pipeline.exchange = exchange
    store.exchange = exchange


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("sa_bench"))


@pytest.fixture(autouse=True)
def restored():
    """Rank 0 is this process: put back what a prelude planted in it."""
    from repro_torch.core import pipeline, store

    saved = [(pipeline, "_finalize"), (pipeline, "_refine_tie_groups"),
             (pipeline, "exchange"), (store, "exchange")]
    values = [getattr(m, a) for m, a in saved]
    yield
    for (m, a), v in zip(saved, values):
        setattr(m, a, v)


@pytest.mark.parametrize("fault", ["unchanged_refinement", "half_left_out",
                                   "answer_altered"])
def test_fault_is_not_correct(root, fault):
    out = tiny.run(root, "reads-build", prelude=f"{HERE}:{fault}")
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1
    assert out["checks"]["sa_entries_wrong"]["value"] > 0


def test_exchange_left_out_is_not_correct(root):
    out = tiny.run(root, tiny.add_four_ranks(root), prelude=f"{HERE}:exchange_left_out")
    assert not out["correct"] and out["checks"]["sa_entries_wrong"]["value"] > 0
