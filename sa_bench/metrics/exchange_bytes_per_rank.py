"""Bytes a rank sends the other ranks through ``core/distributed.py``'s
``exchange`` in one build (``TRAFFIC["exchange_bytes"]``: the record
shuffle and the refinement's window requests and responses), the fullest
rank's."""


def read(run):
    most = max(r["steps"][0]["exchange_bytes"] for r in run["ranks"])
    return most if most else None
