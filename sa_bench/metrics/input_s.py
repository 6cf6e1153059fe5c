"""Host seconds of a build's input phase: the program's ``sa.input`` span
(``core/pipeline.py::local_shard``: the corpus's numpy shard layout and its
copy to the device), the mean over the window's builds (rank 0's).

``per_build`` is the arithmetic of every reader of the program's spans
(``output_s``, ``refine_s``, ``run_groups_s`` and ``store_fetch_s`` import it).
"""
import sys


def per_build(run, name, field):
    """The mean over the window's builds of ``field`` (``host_s`` or
    ``device_s``) summed over the spans named ``name`` inside each build.

    The records come from the program's own span store
    (``repro_torch.core.spans``, which the run has loaded in rank 0's
    process).  A build is a root ``sa.build`` span (no parent), and a span
    is inside the build its chain of ``parent`` ids ends at; of the builds
    the last ones, one a step of the window, are the window's, so spans an
    earlier run left in the process do not count.  None without a card
    (``peak_bytes`` 0), where the program has no span store, or where the
    window's builds hold no span of that name."""
    rank0 = run["ranks"][0]
    spans = sys.modules.get("repro_torch.core.spans")
    if spans is None or rank0["peak_bytes"] == 0:
        return None
    recs = spans.records()  # oldest first: a parent before its children
    steps = len(rank0["steps"])
    builds = [r["id"] for r in recs if r["name"] == "sa.build" and r["parent"] is None]
    if len(builds) < steps:
        return None
    total = {b: 0.0 for b in builds[-steps:]}
    root = {}
    found = False
    for r in recs:
        root[r["id"]] = r["id"] if r["parent"] is None else root.get(r["parent"])
        if r["name"] == name and root[r["id"]] in total:
            if r[field] is None:
                return None
            total[root[r["id"]]] += r[field]
            found = True
    return sum(total.values()) / steps if found else None


def read(run):
    return per_build(run, "sa.input", "host_s")
