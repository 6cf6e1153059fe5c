"""Driver ``builds``: whole in-core suffix-array builds of one corpus, back
to back.

Set-up draws the configuration's corpus from the seed and runs one warm
build of it (the kernels load or compile, the caching allocator grows to
the build's size).  A step is one call of the program's entry,
``repro_torch.core.superblock.build_suffix_array_auto(corpus, cfg=cfg,
device=...)``, as the launcher's ``--mode scheme`` calls it, ending when the
suffix array is in host memory; on D ranks every rank passes the whole
corpus and gets the whole suffix array back.  After the window every
step's suffix array, every entry of it, is compared with the plain
reference (``sa_bench/reference``), computed on this rank's device.
"""
from __future__ import annotations

import time

from sa_bench.reference.suffix_array import suffix_array
from sa_bench.traffic.generate import make_corpus, suffix_count


def count_wrong(got, want) -> int:
    """Entries of ``got`` (int64 numpy) that differ from ``want`` (int64
    tensor), a length difference counted whole."""
    import torch

    n = min(len(got), want.shape[0])
    same = torch.from_numpy(got[:n]).to(want.device) == want[:n]
    return int(n - same.sum()) + abs(len(got) - want.shape[0])


class Driver:
    check_name = "sa_entries_wrong"

    def __init__(self, conf: dict, traffic: dict, seed: int, device: str):
        from repro_torch.config import SAConfig

        self.cfg = SAConfig(**conf["sa_config"])
        self.device = device
        self.corpus = make_corpus(conf, seed)
        self.work = suffix_count(self.corpus)
        self.outputs: list = []

    def _build(self):
        import torch

        from repro_torch.core import distributed
        from repro_torch.core.superblock import build_suffix_array_auto

        distributed.reset_traffic()
        t = time.perf_counter()
        res = build_suffix_array_auto(self.corpus, cfg=self.cfg, device=self.device)
        if self.device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        record = {
            "seconds": dt,
            "work": self.work,
            "iters": int(res.stats["iters"]),
            "fetch_requests": int(res.stats["fetch_requests"]),
            "fetch_request_bytes": int(res.footprint.fetch_request),
            "fetch_response_bytes": int(res.footprint.fetch_response),
            "exchange_bytes": int(distributed.TRAFFIC["exchange_bytes"]),
            "exchanges": int(distributed.TRAFFIC["exchanges"]),
        }
        return res.suffix_array, record

    def warm(self) -> None:
        self._build()

    def step(self) -> dict:
        sa, record = self._build()
        self.outputs.append(sa)
        return record

    def wrong(self, device) -> list:
        """Entries wrong in each step's suffix array."""
        want = suffix_array(self.corpus, device=device)
        out = [count_wrong(sa, want) for sa in self.outputs]
        del want
        return out
