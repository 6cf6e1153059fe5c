"""Quickstart of the PyTorch port: paper Table I (the SA of SINICA$), the SA
of a small paired-end DNA read set checked against the exact oracle, then
the index lifecycle through the unified API: build -> query -> save ->
open -> query (paper §I's alignment use case).

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The counterpart of ``examples/quickstart.py``, with the same lines.  On the
card the hand-written kernels run (``use_pallas=True``); ``--device cpu``
runs the plain PyTorch path.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import SAConfig, SuffixArrayIndex
from repro_torch.core.oracle import naive_sa_reads
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.data.corpus import synth_dna_reads


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev, kernels = args.device, args.device == "cuda"

    # --- Table I: SINICA$ ---------------------------------------------------
    alph = {"A": 1, "C": 2, "I": 3, "N": 4, "S": 5}
    text = np.array([alph[c] for c in "SINICA"], np.int32)
    res = build_suffix_array(
        text, cfg=SAConfig(vocab_size=5, chars_per_word=3, use_pallas=kernels),
        device=dev)
    inv = {v: k for k, v in alph.items()}
    print("Table I — Suffix Array of SINICA$:")
    print(f"{'i':>2} {'SA[i]':>5}  sorted suffix")
    print(f"{0:>2} {len(text):>5}  $")
    for i, p in enumerate(res.suffix_array):
        s = "".join(inv[t] for t in text[p:]) + "$"
        print(f"{i + 1:>2} {p:>5}  {s}")
    assert list(res.suffix_array) == [5, 4, 3, 1, 2, 0]

    # --- paired-end read set (paper Case 6, miniature) ----------------------
    reads = synth_dna_reads(64, 48, seed=1, paired_end=True)
    cfg = SAConfig(vocab_size=4, packing="base", use_pallas=kernels)
    res = build_suffix_array(reads, cfg=cfg, device=dev)
    assert np.array_equal(res.suffix_array, naive_sa_reads(reads))
    print(f"\npaired-end read set: {reads.shape[0]} reads x {reads.shape[1]} bp")
    print(f"suffixes sorted : {res.stats['num_suffixes']}")
    print(f"tie-break rounds: {res.stats['rounds']}")
    print("footprint units (input = 1):")
    for k, v in res.footprint.units().items():
        print(f"  {k:>15}: {v if isinstance(v, int) else round(v, 3)}")
    print("matches exact oracle: True")

    # --- the unified API: build -> query -> save -> open -> query -----------
    idx = SuffixArrayIndex.build(reads, cfg=cfg, device=dev)
    seed = reads[5, 10:16].astype(np.int64)  # a 6-mer seed from read 5
    hits = idx.align(seed)  # sorted (read_id, offset) pairs
    print(f"\nalign seed {list(map(int, seed))}: {idx.count(seed)} hits, "
          f"first {hits[:4]}")
    assert (5, 10) in hits

    with tempfile.TemporaryDirectory() as tmp:
        index_dir = os.path.join(tmp, "index")
        idx.save(index_dir)  # SA + LCP + corpus + manifest
        with SuffixArrayIndex.open(index_dir, device=dev) as reopened:  # no rebuild
            assert reopened.align(seed) == hits
            counts = reopened.count([seed, seed[:3], np.array([1, 2], np.int64)])
            print(f"reopened from {os.path.basename(index_dir)}/: "
                  f"batched counts {list(map(int, counts))}")
    idx.close()
    print("save -> open round trip: True")


if __name__ == "__main__":
    main()
