"""Suffixes of every build completed in the window, over the window: the
host clock from the first build's start to the last build's end (rank 0's,
where every rank ends each build together)."""


def read(run):
    rank0 = run["ranks"][0]
    return sum(s["work"] for s in rank0["steps"]) / rank0["window_s"]
