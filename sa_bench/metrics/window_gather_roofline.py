"""``window_gather``'s share of its memory roofline over the window.

Work, from the builds' served fetch requests (``stats["fetch_requests"]``)
alone: a request reads its row and offset (2 x 4 B) and the K tokens of its
window (K x 4 B, as the Footprint models every response, a window cut by the
read's end included) and writes the window (K x 4 B); K is the
configuration's key length.  Its least time is those bytes at the H100's
3.35 TB/s; the share is that over the device time of the kernels named
``window_gather`` in the trace (rank 0's)."""
from sa_bench.harness.peaks import HBM_BYTES_PER_S


def key_tokens(sa_config: dict) -> int:
    """Tokens of the Map's key: the most base-(V+1) digits an int31 word
    holds, times the key's words (``packing="base"``)."""
    v = int(sa_config.get("vocab_size", 5))
    per_word, cap = 0, 1
    while cap * (v + 1) < (1 << 31):
        cap *= v + 1
        per_word += 1
    return per_word * int(sa_config.get("key_words", 2))


def read(run):
    rank0 = run["ranks"][0]
    seconds = sum(t for n, t in rank0.get("kernel_s", {}).items() if "window_gather" in n)
    if not seconds:
        return None
    k = key_tokens(run["config"]["sa_config"])
    requests = sum(s["fetch_requests"] for s in rank0["steps"])
    return 100.0 * requests * (8 + 8 * k) / HBM_BYTES_PER_S / seconds
