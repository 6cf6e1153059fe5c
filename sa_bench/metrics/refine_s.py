"""Device seconds of a build's refinement: the program's ``sa.refine`` span
(``core/pipeline.py::_refine_tie_groups``, every round), read from the CUDA
events at its ends (stream time, gaps included), the mean over the window's
builds (rank 0's)."""
from sa_bench.metrics.input_s import per_build


def read(run):
    return per_build(run, "sa.refine", "device_s")
