"""Host seconds of a build's output phase: the program's ``sa.output`` span
(``core/pipeline.py``: the ranks' sorted indexes copied to the host by
``gathered`` and the suffix array assembled by ``_finalize``), the mean over
the window's builds (rank 0's)."""
from sa_bench.metrics.input_s import per_build


def read(run):
    return per_build(run, "sa.output", "host_s")
