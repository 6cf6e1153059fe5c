"""The frozen generators give the program's corpora, and the plain reference
gives the program's suffix arrays (its plain CPU path), at small sizes."""
import numpy as np
import pytest

from repro_torch.config import SAConfig
from repro_torch.core.oracle import naive_sa_reads, naive_sa_text
from repro_torch.core.superblock import build_suffix_array_auto
from repro_torch.data import corpus as program_corpus
from sa_bench.reference.suffix_array import suffix_array
from sa_bench.traffic import generate

SEEDS = [0, 7, 2**31 + 5, 2**40 + 1]
CFG = SAConfig(vocab_size=4, packing="base", samples_per_shard=512, use_pallas=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(50, 20), (300, 200), (7, 3)])
def test_reads_equal_the_programs(seed, shape):
    got = generate.synth_dna_reads(*shape, seed=seed)
    want = program_corpus.synth_dna_reads(*shape, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dup", [0.0, 0.1])
def test_text_equals_the_programs(seed, dup):
    got = generate.synth_token_corpus(5000, 4, seed=seed, dup_fraction=dup, dup_span=32)
    want = program_corpus.synth_token_corpus(5000, 4, seed=seed, dup_fraction=dup,
                                             dup_span=32)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_make_corpus_follows_the_config():
    reads = generate.make_corpus({"corpus_kind": "dna_reads", "num_reads": 64,
                                  "read_len": 30, "coverage": 16}, 5)
    assert np.array_equal(reads, program_corpus.synth_dna_reads(64, 30, seed=5))
    text = generate.make_corpus({"corpus_kind": "text", "length": 999, "vocab": 4}, -3)
    assert np.array_equal(text, program_corpus.synth_token_corpus(999, 4, seed=2**64 - 3)[0])
    assert generate.suffix_count(reads) == 64 * 31 and generate.suffix_count(text) == 999


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 3])
def test_reference_is_the_programs_sa_on_reads(seed):
    reads = generate.synth_dna_reads(120, 60, seed=seed, genome_len=400)
    want = build_suffix_array_auto(reads, cfg=CFG, device="cpu").suffix_array
    assert np.array_equal(suffix_array(reads).numpy(), want)
    assert np.array_equal(want, naive_sa_reads(reads))


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 3])
def test_reference_is_the_programs_sa_on_text(seed):
    text, _ = generate.synth_token_corpus(4000, 4, seed=seed, dup_fraction=0.2, dup_span=50)
    want = build_suffix_array_auto(text, cfg=CFG, device="cpu").suffix_array
    assert np.array_equal(suffix_array(text).numpy(), want)
    assert np.array_equal(want, naive_sa_text(text))
