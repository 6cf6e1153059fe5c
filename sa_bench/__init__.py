"""The benchmark of the PyTorch/CUDA suffix-array system (``repro_torch``).

``python3 sa_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that belongs
to one configuration, traffic mix, driver or metric is a file of its own,
found by its name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``.  The yardstick lives here
and nowhere in the program: the frozen corpus generators (``traffic``), the
plain reference and the control (``reference``), the peaks, the profiler's
timeline arithmetic and the kind table (``harness``).
"""
