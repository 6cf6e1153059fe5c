"""The control of ``correct``: it has to come out as not correct.

The configurations state no precision; their guarantee is an exact suffix
array.  The control breaks it the way a build that skipped refinement would:
the reference's order over each suffix's first 13 tokens only (one 31-bit
key word of a 4-letter alphabet with ``$``), ties by name, put in the
program's place.  ``count_wrong`` is the number the harness compares with
its limit, 0.

    PYTHONPATH=src python -m pytest sa_bench/tests -m gpu -s   # on the card

runs the control at each configuration's own size on three seeds and prints
its readings.
"""
from pathlib import Path

import pytest
import torch

from sa_bench.drivers.builds import count_wrong
from sa_bench.harness import spec
from sa_bench.reference.suffix_array import first_key_order, suffix_array
from sa_bench.traffic.generate import make_corpus

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "reads": {"corpus_kind": "dna_reads", "num_reads": 400, "read_len": 200,
              "coverage": 59},
    "text": {"corpus_kind": "text", "length": 20_000, "vocab": 4},
}
CHIP_SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def control_wrong(conf: dict, seed: int, device) -> tuple:
    """(entries the control gets wrong, entries)."""
    corpus = make_corpus(conf, seed)
    want = suffix_array(corpus, device=device)
    got = first_key_order(corpus, device=device).cpu().numpy()
    return count_wrong(got, want), int(want.shape[0])


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2, 2**33 + 3])
def test_control_is_not_correct_small(kind, seed):
    wrong, _ = control_wrong(SMALL[kind], seed, "cpu")
    assert wrong > 0


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["grouper-reads"])
def test_control_is_not_correct_at_cell_size(config_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = spec.load(ROOT)
    conf = spec.config(ROOT, bench, config_name)
    for seed in CHIP_SEEDS:
        wrong, n = control_wrong(conf, seed, torch.device("cuda"))
        print(f"control {config_name} seed {seed}: {wrong} of {n} entries wrong "
              f"(limit 0)")
        assert wrong > 0
        torch.cuda.empty_cache()
