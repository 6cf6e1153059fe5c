"""The share of the traced window in which no activity ran on the device:
100 - the union of the device's kernel, copy and set intervals from
``torch.profiler``'s timeline over the window; on D ranks the largest
rank's."""


def read(run):
    idle = [100.0 * (1.0 - r["busy_s"] / r["window_s"])
            for r in run["ranks"] if r.get("busy_s")]
    return max(idle) if idle else None
