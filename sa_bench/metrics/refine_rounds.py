"""Refinement rounds of a build (``SAResult.stats["iters"]``, the largest
over the ranks): the reduce's ``_refine_tie_groups`` loop, one window fetch
and one re-sort a round; the most of any build in the window."""


def read(run):
    return max(s["iters"] for s in run["ranks"][0]["steps"])
