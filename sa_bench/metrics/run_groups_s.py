"""Device seconds of a build's group-id scans: the program's
``sa.run_groups`` spans (``core/pipeline.py::_run_groups``, the
``torch.cummax`` of ``core/distributed.py::run_starts``; one after the first
sort, one a refinement round), read from their CUDA events and summed over
a build, the mean over the window's builds (rank 0's)."""
from sa_bench.metrics.input_s import per_build


def read(run):
    return per_build(run, "sa.run_groups", "device_s")
