"""Rank 0's process start to the window's start: imports, the kernels
loaded (or compiled, in a checkout's first run), the corpus drawn from the
seed, the ranks joined, and one warm build."""


def read(run):
    return run["ranks"][0]["setup_s"]
