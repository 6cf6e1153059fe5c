"""The port's data helpers, dedup, loader, deprecated search wrappers and the
launcher's terasort and doubling modes against ``repro``: ``lcp_kasai``,
``flatten_reads_with_separators``, ``pack_sequences``, ``find_duplicate_spans``
/ ``dedup_corpus`` in both modes, ``DeterministicLoader``, the four raw-array
wrappers (answers and ``DeprecationWarning``) and
``repro_torch.launch.sa_build --mode terasort|doubling``'s printout."""
import math
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SAConfig as RefConfig
from repro.core import oracle as ref_oracle
from repro.core import search as ref_search
from repro.data import corpus as ref_corpus
from repro.data import dedup as ref_dedup
from repro.data.loader import DeterministicLoader as RefLoader
from repro_torch.config import SAConfig
from repro_torch.core import oracle, search
from repro_torch.data import corpus, dedup
from repro_torch.data.loader import DeterministicLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lcp_kasai_matches_repro():
    rng = np.random.default_rng(9)
    for text in (rng.integers(1, 5, size=(120,)).astype(np.int32),
                 np.tile(np.array([1, 2, 1], np.int32), 30),
                 np.array([4], np.int32)):
        sa = oracle.naive_sa_text(text)
        got = oracle.lcp_kasai(text, sa)
        want = ref_oracle.lcp_kasai(text, sa)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        for i in range(1, len(sa)):
            a, b = text[sa[i - 1]:], text[sa[i]:]
            m = min(len(a), len(b))
            neq = np.flatnonzero(a[:m] != b[:m])
            assert got[i] == (neq[0] if neq.size else m)


@pytest.mark.parametrize("lengths", [None, [3, 1, 0, 4]], ids=["uniform", "lengths"])
def test_flatten_reads_with_separators_matches_repro(lengths):
    reads = np.array([[1, 2, 3, 4], [4, 0, 0, 0], [0, 0, 0, 0], [2, 2, 1, 3]], np.int32)
    lens = None if lengths is None else np.array(lengths, np.int32)
    got = corpus.flatten_reads_with_separators(reads, lens)
    want = ref_corpus.flatten_reads_with_separators(reads, lens)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    if lens is not None:
        np.testing.assert_array_equal(got, [1, 2, 3, 0, 4, 0, 0, 2, 2, 1, 3, 0])


@pytest.mark.parametrize("n,seq_len,batch", [(100, 4, 3), (24, 4, 3), (5, 4, 2)])
def test_pack_sequences_matches_repro(n, seq_len, batch):
    toks = np.arange(n, dtype=np.int32)
    got = corpus.pack_sequences(toks, seq_len, batch)
    want = ref_corpus.pack_sequences(toks, seq_len, batch)
    assert got.shape == want.shape == (n // (seq_len * batch), batch, seq_len)
    np.testing.assert_array_equal(got, want)


DEDUP_CASES = {
    # name: (corpus args, min_len, config)
    "modes-agree": ((600, 16, 2, 0.2, 48), 40, dict(vocab_size=16, packing="bits")),
    "planted": ((2000, 64, 1, 0.06, 40), 32, dict(vocab_size=64, packing="bits")),
    "default-config": ((500, 4, 3, 0.1, 20), 12, None),
}


@pytest.mark.parametrize("mode", ["scheme", "doubling"])
@pytest.mark.parametrize("name", sorted(DEDUP_CASES))
def test_dedup_matches_repro(name, mode):
    (length, vocab, seed, frac, span), min_len, kw = DEDUP_CASES[name]
    toks, planted = corpus.synth_token_corpus(length, vocab, seed=seed,
                                              dup_fraction=frac, dup_span=span)
    rtoks, rplanted = ref_corpus.synth_token_corpus(length, vocab, seed=seed,
                                                    dup_fraction=frac, dup_span=span)
    np.testing.assert_array_equal(toks, rtoks)
    assert planted == rplanted
    cfg, rcfg = (None, None) if kw is None else (SAConfig(**kw), RefConfig(**kw))
    spans = dedup.find_duplicate_spans(toks, min_len, cfg, device="cpu", mode=mode)
    assert spans == ref_dedup.find_duplicate_spans(toks, min_len, rcfg, mode=mode)
    got_toks, keep, stats = dedup.dedup_corpus(toks, min_len, cfg, device="cpu", mode=mode)
    _, want_keep, want_stats = ref_dedup.dedup_corpus(toks, min_len, rcfg, mode=mode)
    assert got_toks is toks
    np.testing.assert_array_equal(keep, want_keep)
    assert stats == want_stats and stats["num_spans"] == len(spans) > 0
    for src, dst, n in planted:
        if np.array_equal(toks[src:src + n], toks[dst:dst + n]):
            assert not (keep[src:src + n].all() and keep[dst:dst + n].all())


def test_dedup_modes_agree():
    """``tests/test_extensions.py``'s case with spans planted (at 0.05 it
    plants none)."""
    toks, _ = corpus.synth_token_corpus(600, 16, seed=2, dup_fraction=0.2, dup_span=48)
    cfg = SAConfig(vocab_size=16, packing="bits")
    a = set(dedup.find_duplicate_spans(toks, 40, cfg, device="cpu", mode="scheme"))
    b = set(dedup.find_duplicate_spans(toks, 40, cfg, device="cpu", mode="doubling"))
    assert a == b and a


def _batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("masked", [False, True], ids=["tokens", "mask"])
def test_loader_matches_repro(masked):
    toks = (np.arange(1, 2001) * 7 % 63 + 1).astype(np.int32)
    mask = (np.arange(2000) % 3 != 0) if masked else None
    kw = dict(batch=4, seq_len=16, seed=3, mask=mask, num_hosts=2)
    for host in (0, 1):
        got = DeterministicLoader(toks, host_id=host, **kw)
        want = RefLoader(toks, host_id=host, **kw)
        assert got.n_windows == want.n_windows
        for step in (0, 1, 7, 123):
            _batches_equal(got.batch_at(step), want.batch_at(step))
            _batches_equal(got.host_slice(step), want.host_slice(step))
            assert got.host_slice(step)["tokens"].shape == (2, 16)
    # resume: a fresh loader at step s replays what the iterator gave
    it = iter(DeterministicLoader(toks, **kw))
    seen = [next(it) for _ in range(5)]
    fresh = DeterministicLoader(toks, **kw)
    for step, batch in enumerate(seen):
        _batches_equal(fresh.batch_at(step), batch)
    with pytest.raises(ValueError, match="shorter than one sequence"):
        DeterministicLoader(toks[:16], batch=1, seq_len=16)


def _brute_text(text, pat):
    p = len(pat)
    return sorted(i for i in range(len(text)) if list(text[i:i + p]) == list(pat))


def _brute_reads(reads, pat):
    r, l = reads.shape
    p = len(pat)
    return sorted((i, o) for i in range(r) for o in range(l)
                  if list(reads[i, o:o + p]) == list(pat))


def _call(fn, *args, **kw):
    """``fn``'s answer and the one DeprecationWarning it raised."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1, fn.__name__
    return out, dep[0]


def _same_call(name, *args):
    got, gw = _call(getattr(search, name), *args, device="cpu")
    want, ww = _call(getattr(ref_search, name), *args)
    assert got == want
    assert str(gw.message) == str(ww.message)
    assert gw.filename == ww.filename == __file__  # stacklevel=3: the caller
    return got


def test_text_wrappers_match_repro():
    rng = np.random.default_rng(5)
    text = rng.integers(1, 4, size=(80,)).astype(np.int32)
    sa = ref_oracle.naive_sa_text(text)
    for plen in (1, 2, 3, 5):
        for start in (0, 17, 76):
            pat = text[start:start + plen]
            want = _brute_text(text, pat)
            lo, hi = _same_call("search_text", text, sa, pat)
            assert hi - lo == len(want)
            assert _same_call("count_occurrences", text, sa, pat) == len(want)
            assert _same_call("find_occurrences", text, sa, pat) == want
    # a pattern with a token absent from the text matches nothing
    small = np.array([1, 2, 1, 2, 1], np.int32)
    sa_small = ref_oracle.naive_sa_text(small)
    assert _same_call("count_occurrences", small, sa_small, [1, 3]) == 0
    assert _same_call("find_occurrences", small, sa_small, [3]) == []
    assert _same_call("search_text", small, sa_small, [5])[0] == len(small)


def test_align_reads_matches_repro():
    rng = np.random.default_rng(7)
    reads = rng.integers(1, 5, size=(12, 6)).astype(np.int32)
    sb = int(math.ceil(math.log2(reads.shape[1] + 1)))
    sa = ref_oracle.naive_sa_reads(reads, stride_bits=sb)
    # present, longer than any read, ending at a read's tail
    for pat in (reads[5, 1:4], np.concatenate([reads[3], [1]]).astype(np.int32),
                reads[4, 6 - 3:], reads[4, 6 - 1:], reads[4]):
        got = _same_call("align_reads", reads, sa, sb, pat)
        assert got == _brute_reads(reads, pat)
    assert _same_call("align_reads", reads, sa, sb, reads[4, 3:]).count((4, 3)) == 1
    # an SA packed with a wider stride than the store's is translated
    wide = ref_oracle.naive_sa_reads(reads, stride_bits=sb + 2)
    pat = reads[2, 2:5]
    assert _same_call("align_reads", reads, wide, sb + 2, pat) == _brute_reads(reads, pat)


def _stdout(module, *args, cwd=None, wait=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return _result(proc) if wait else proc


def _result(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    return out.splitlines()


def _parsed(lines):
    """The printout but the wall: the mode and suffix count, the unit lines
    and the stats line."""
    head = next(ln for ln in lines if ln.startswith("mode="))
    return (head.split(" time=")[0], [ln for ln in lines if ln.startswith("  ")],
            next(ln for ln in lines if ln.startswith("stats: ")))


@pytest.mark.parametrize("flags", [
    ["--mode", "terasort", "--reads", "50", "--read-len", "20"],
    ["--mode", "doubling", "--text", "400", "--seed", "3"],
    ["--mode", "terasort", "--reads", "40", "--read-len", "30", "--corpus-file",
     "corpus.sachunk"],
    ["--mode", "doubling", "--reads", "50", "--read-len", "40", "--corpus-file",
     "corpus.sachunk"],
], ids=["terasort-reads", "doubling-text", "terasort-corpus-file",
        "doubling-reads-corpus-file"])
def test_launcher_modes_match_repro(flags, tmp_path):
    """The same printout apart from the wall.  ``--corpus-file`` names a
    fresh file that the port's run writes and repro's run loads."""
    if "--corpus-file" in flags:
        got = _stdout("repro_torch.launch.sa_build", "--device", "cpu", *flags,
                      cwd=tmp_path)
        want = _stdout("repro.launch.sa_build", *flags, cwd=tmp_path)
        assert got[0].startswith("wrote corpus.sachunk") and not want[0].startswith("wrote")
    else:  # the two runs side by side
        procs = [_stdout("repro_torch.launch.sa_build", "--device", "cpu", *flags,
                         cwd=tmp_path, wait=False),
                 _stdout("repro.launch.sa_build", *flags, cwd=tmp_path, wait=False)]
        got, want = (_result(p) for p in procs)
    assert _parsed(got) == _parsed(want)
    assert not any(ln.startswith("out-of-core") for ln in got)
    if "doubling" in flags and "--reads" in flags:
        assert "'rounds': 0" not in _parsed(got)[2]
