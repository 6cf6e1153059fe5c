"""The store's window fetches a build makes, in the program's own byte
accounting (``Footprint.fetch_request + fetch_response``, summed over the
ranks), over the build's suffixes."""


def read(run):
    step = run["ranks"][0]["steps"][0]
    total = step["fetch_request_bytes"] + step["fetch_response_bytes"]
    return total / step["work"] if total else None
