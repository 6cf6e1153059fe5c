"""LM data pipeline on the PyTorch port: exact-substring dedup of a token
corpus via the suffix array (the paper's pipeline as an LLM-data
substrate).

Plants duplicate spans in a synthetic corpus, finds them with SA+LCP, masks
them from the training loss, and shows the loader consuming the mask.

    PYTHONPATH=src python examples/torch_dedup_corpus.py              # the card
    PYTHONPATH=src python examples/torch_dedup_corpus.py --device cpu

The counterpart of ``examples/dedup_corpus.py``, with the same lines.
"""
import argparse

import numpy as np

from repro_torch.config import SAConfig
from repro_torch.data.corpus import synth_token_corpus
from repro_torch.data.dedup import dedup_corpus
from repro_torch.data.loader import DeterministicLoader

VOCAB = 255


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    tokens, planted = synth_token_corpus(
        6_000, VOCAB, seed=3, dup_fraction=0.08, dup_span=48
    )
    print(f"corpus: {len(tokens)} tokens, planted {len(planted)} duplicate spans")

    cfg = SAConfig(vocab_size=VOCAB, packing="bits")
    tokens, keep, stats = dedup_corpus(tokens, min_len=32, cfg=cfg,
                                       device=args.device, mode="doubling")
    print(f"found spans   : {stats['num_spans']}")
    print(f"masked tokens : {stats['masked_tokens']} "
          f"({100 * stats['masked_fraction']:.2f}%)")

    # dedup property: no planted pair may survive in full twice (plants can
    # overwrite each other, so only still-identical pairs are checkable)
    missed = 0
    for src, dst, span in planted:
        if np.array_equal(tokens[src : src + span], tokens[dst : dst + span]):
            if keep[src : src + span].all() and keep[dst : dst + span].all():
                missed += 1
    assert missed == 0, f"{missed} duplicate pairs fully survived dedup"
    print("no duplicate pair survives twice: True")

    loader = DeterministicLoader(tokens, batch=4, seq_len=128, seed=0,
                                 mask=keep.astype(np.float32))
    batch = loader.batch_at(0)
    print(f"loader batch: tokens {batch['tokens'].shape}, "
          f"mask coverage {batch['mask'].mean():.3f}")


if __name__ == "__main__":
    main()
