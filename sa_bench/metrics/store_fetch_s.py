"""Device seconds of a build's window fetches: the program's
``sa.store.fetch`` spans (``core/store.py``: ``serve_windows`` at one rank,
``mget_window`` at several; one a refinement round), read from their CUDA
events and summed over a build, the mean over the window's builds (rank
0's)."""
from sa_bench.metrics.input_s import per_build


def read(run):
    return per_build(run, "sa.store.fetch", "device_s")
