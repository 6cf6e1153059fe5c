"""The port's in-core build vs ``repro.core.pipeline.build_suffix_array`` and
the oracle: the same suffix array, every Footprint field and every stats
key, bit for bit, over reads/text corpora and the config switches; and the
routing of ``build_suffix_array_auto`` (single-pass, out-of-core, refused)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.config import SuperblockConfig
from repro.core.pipeline import build_suffix_array as ref_build
from repro_torch.config import SAConfig
from repro_torch.core.oracle import doubling_sa_text, naive_sa_reads, naive_sa_text
from repro_torch.core.pipeline import build_suffix_array
from repro_torch.core.superblock import build_suffix_array_auto

K4 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4: many rounds


def _reads(seed=0, r=60, l=15):
    return np.random.default_rng(seed).integers(1, 5, size=(r, l)).astype(np.int32)


def _variable(seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 11, size=(25,)).astype(np.int32)
    reads = np.zeros((25, 11), np.int32)
    for i, n in enumerate(lens):
        reads[i, :n] = rng.integers(1, 5, size=(n,))
    return reads, lens


def _duplicates():
    return np.tile(_reads(2, 4, 9), (4, 1))


def _paired_end():
    fwd = _reads(3, 20, 12)
    return np.concatenate([fwd, fwd[:, ::-1]], axis=0)


def _text(seed=4, n=300):
    return np.random.default_rng(seed).integers(1, 5, size=(n,)).astype(np.int32)


def _atat():
    return np.tile(np.array([1, 2, 1], np.int32), 40)


VAR, VAR_LENS = _variable()
CASES = {
    # name: (corpus, lengths, config overrides, oracle)
    "reads": (_reads(), None, {}, "reads"),
    "reads-pallas": (_reads(), None, dict(use_pallas=True), "reads"),
    "reads-raw-pallas": (_reads(), None, dict(server_pack=False, use_pallas=True), "reads"),
    "reads-drops": (_reads(), None, dict(fetch_fraction=0.05), "reads"),
    "reads-bits": (_reads(), None, dict(packing="bits", chars_per_word=0), "reads"),
    "variable": (VAR, VAR_LENS, {}, "reads"),
    "variable-raw": (VAR, VAR_LENS, dict(server_pack=False), "reads"),
    "variable-pallas-static": (VAR, VAR_LENS, dict(use_pallas=True, adaptive=False), "reads"),
    "duplicates": (_duplicates(), None, {}, "reads"),
    "duplicates-bits-pallas": (_duplicates(), None,
                               dict(packing="bits", use_pallas=True), "reads"),
    "paired-end": (_paired_end(), None, {}, "reads"),
    "paired-end-raw-pallas": (_paired_end(), None,
                              dict(server_pack=False, use_pallas=True), "reads"),
    "text": (_text(), None, {}, "text"),
    "text-pallas": (_text(), None, dict(use_pallas=True), "text"),
    "text-drops-static": (_text(), None, dict(adaptive=False, fetch_fraction=0.02), "text"),
    "text-bits-pallas": (_text(), None, dict(packing="bits", use_pallas=True), "text"),
    "atat": (_atat(), None, {}, "text"),
    "atat-raw-static": (_atat(), None, dict(server_pack=False, adaptive=False), "text"),
    "atat-pallas": (_atat(), None, dict(use_pallas=True), "text"),
    "launcher-config": (_reads(5, 50, 20), None,
                        dict(chars_per_word=0, key_words=2, samples_per_shard=512,
                             use_pallas=True), "reads"),
}


def _oracle(kind, corpus, lengths):
    if kind == "reads":
        return naive_sa_reads(corpus, lengths)
    if corpus.shape[0] <= 200:
        return naive_sa_text(corpus)
    return doubling_sa_text(corpus)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_matches_repro_and_oracle(name):
    corpus, lengths, over, kind = CASES[name]
    kw = {**K4, **over}
    want = ref_build(corpus, lengths=lengths, cfg=RefConfig(**kw))
    got = build_suffix_array(corpus, lengths=lengths, cfg=SAConfig(**kw),
                             device="cpu")
    np.testing.assert_array_equal(got.suffix_array, want.suffix_array)
    np.testing.assert_array_equal(got.suffix_array, _oracle(kind, corpus, lengths))
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(want.footprint)
    assert got.stats == want.stats
    if "drops" in name:
        assert got.stats["retries"] > 0  # capacity drops were retried
    assert got.stats["unresolved"] == 0


def test_table1_sinica():
    """Paper Table I: SA of SINICA$ (alphabet-mapped)."""
    text = np.array([5, 3, 4, 3, 2, 1], np.int32)
    res = build_suffix_array(text, cfg=SAConfig(vocab_size=5, chars_per_word=3),
                             device="cpu")
    np.testing.assert_array_equal(res.suffix_array, [5, 4, 3, 1, 2, 0])


def test_auto_single_pass_equals_direct_build():
    reads = _reads()
    a = build_suffix_array_auto(reads, cfg=SAConfig(**K4), device="cpu")
    b = build_suffix_array_auto(reads, cfg=SAConfig(**K4), device="cpu",
                                sb=SuperblockConfig())
    c = build_suffix_array(reads, cfg=SAConfig(**K4), device="cpu")
    for res in (a, b):
        np.testing.assert_array_equal(res.suffix_array, c.suffix_array)
        assert res.stats == c.stats


@pytest.mark.parametrize("sb", [
    dict(num_superblocks=3),
    dict(max_records_per_run=100),
    dict(emit_lcp=True, num_superblocks=2),
], ids=["superblocks", "budget", "lcp"])
def test_auto_out_of_core_plans_match_repro(sb):
    """Plans of more than one superblock build out of core, as in repro: the
    same SA, LCP, Footprint and stats (wall times aside)."""
    from repro.core.superblock import build_suffix_array_auto as ref_auto
    from repro_torch.config import SuperblockConfig as PortSuperblockConfig

    want = ref_auto(_reads(), cfg=RefConfig(**K4), sb=SuperblockConfig(**sb))
    got = build_suffix_array_auto(_reads(), cfg=SAConfig(**K4),
                                  sb=PortSuperblockConfig(**sb), device="cpu")
    np.testing.assert_array_equal(got.suffix_array, want.suffix_array)
    np.testing.assert_array_equal(got.suffix_array, naive_sa_reads(_reads()))
    assert dataclasses.asdict(got.footprint) == dataclasses.asdict(want.footprint)
    walls = ("t_stage_s", "t_build_s", "t_merge_s")
    assert ({k: v for k, v in got.stats.items() if k not in walls}
            == {k: v for k, v in want.stats.items() if k not in walls})
    assert got.stats["superblocks"] > 1
    if sb.get("emit_lcp"):
        np.testing.assert_array_equal(got.lcp, want.lcp)


@pytest.mark.parametrize("sb,item", [
    (SuperblockConfig(write_manifest=True), "8"),
    (SuperblockConfig(num_superblocks=2, merge_algorithm="kway"), "9b"),
    (SuperblockConfig(num_superblocks=2, merge_algorithm="rerank"), "9b"),
    (SuperblockConfig(num_superblocks=2, resume=True), "9b"),
    (SuperblockConfig(num_superblocks=2, sanitize=True), "9b"),
    (SuperblockConfig(num_superblocks=2, store_retries=2), "9b"),
], ids=["manifest", "kway", "rerank", "resume", "sanitize", "store_retries"])
def test_auto_refuses_out_of_core_plans(sb, item):
    with pytest.raises(NotImplementedError, match=f"item {item}$"):
        build_suffix_array_auto(_reads(), cfg=SAConfig(**K4), sb=sb, device="cpu")


def test_auto_refuses_the_sanitizer_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(NotImplementedError, match="item 9b$"):
        build_suffix_array_auto(_reads(), cfg=SAConfig(**K4), device="cpu",
                                sb=SuperblockConfig(num_superblocks=2))


@pytest.mark.parametrize("shape", [(10,), (1,), (7,), (100,), (9, 5), (40, 12)],
                         ids=str)
@pytest.mark.parametrize("knobs", [
    dict(), dict(num_superblocks=1), dict(num_superblocks=3),
    dict(num_superblocks=6), dict(num_superblocks=64),
    dict(max_records_per_run=4), dict(max_records_per_run=30),
    dict(max_records_per_run=1000), dict(max_records_per_run=1),
], ids=str)
def test_num_superblocks_matches_plan(shape, knobs):
    """The block count after rounding the block size up to whole items: for
    shape (10,) and num_superblocks=6 the plan has 5 blocks, not 6."""
    import warnings

    from repro.core.superblock import plan_superblocks as ref_plan
    from repro_torch.config import SuperblockConfig as PortSuperblockConfig
    from repro_torch.core.superblock import plan_superblocks

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_plan(shape, RefConfig(**K4), SuperblockConfig(**knobs))
        got = plan_superblocks(shape, SAConfig(**K4), PortSuperblockConfig(**knobs))
    assert got.num_superblocks == want.num_superblocks
    if shape == (10,) and knobs == dict(num_superblocks=6):
        assert want.num_superblocks == 5
