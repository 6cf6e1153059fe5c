"""The fullest device's ``torch.cuda.max_memory_allocated()`` over the
window (its peak reset after set-up), over the suffixes that device's share
holds: a build's suffixes over the ranks."""


def read(run):
    peak = max(r["peak_bytes"] for r in run["ranks"])
    if peak == 0:  # no device
        return None
    return peak / (run["ranks"][0]["steps"][0]["work"] / run["world"])
