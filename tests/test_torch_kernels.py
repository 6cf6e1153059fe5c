"""Port kernels: the plain versions against ``repro.kernels.ref`` and the
Pallas kernels (interpret mode off the TPU), CPU dispatch and the registry.
The CUDA kernels themselves are held to their plain versions on the card by
``tests/test_torch_kernels_gpu.py``."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.config import SAConfig as RefConfig
from repro.kernels import KERNEL_REGISTRY as REF_REGISTRY
from repro.kernels import ops as ref_ops
from repro.core import distributed as jdist
from repro.core.search import masked_cmp_np
from repro.kernels import ref as jref
from repro_torch.config import SAConfig
from repro_torch.core.search import masked_cmp
from repro_torch.kernels import KERNEL_REGISTRY, launch_counts, ops, ref
from repro_torch.kernels import bitonic_sort as bs_mod
from repro_torch.kernels import pattern_cmp as pc_mod
from repro_torch.kernels import prefix_pack as pp_mod
from repro_torch.kernels import run_groups as rg_mod
from repro_torch.kernels import window_gather as wg_mod
from repro_torch.kernels import cases
from repro_torch.kernels.cases import (
    CMP_EDGE_K, CMP_SHAPES, GATHER_CASES, GATHER_IDS, HIST_BLOCK, HIST_EDGE,
    HIST_FAULT, HIST_SHAPES, MERGE_RUN_EDGE, MERGE_RUNS, PACK_BLOCK, PACK_CFGS,
    PACK_IDS, PACK_LENGTHS, SORT_FAULT, SORT_SHAPES, cmp_edge_inputs, cmp_inputs,
    fault_arrays, gather_case, hist_edge_inputs, hist_inputs, merge_run_edge_inputs,
    merge_runs, merge_runs_inputs, pack_tokens, sort_edge_inputs, sort_inputs,
    sorted_rows)


@pytest.mark.parametrize("kw", PACK_CFGS, ids=PACK_IDS)
@pytest.mark.parametrize("n", PACK_LENGTHS)
def test_prefix_pack_ref_matches_repro(kw, n):
    toks = pack_tokens(kw, n)
    before = launch_counts()
    got = ops.prefix_pack(torch.from_numpy(toks), SAConfig(**kw), block=PACK_BLOCK)
    assert launch_counts() == before  # CPU tensors take the plain version
    want_ref = jref.prefix_pack_ref(jnp.asarray(toks), RefConfig(**kw))
    want_kernel = ref_ops.prefix_pack(jnp.asarray(toks), RefConfig(**kw), block=PACK_BLOCK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    np.testing.assert_array_equal(
        ref.prefix_pack_ref(torch.from_numpy(toks), SAConfig(**kw)).numpy(),
        got.numpy())


@pytest.mark.parametrize("kw", PACK_CFGS, ids=PACK_IDS)
@pytest.mark.parametrize("name", cases.PACK_EDGE)
def test_prefix_pack_ref_edges_match_repro(kw, name):
    """``prefix_pack``'s edge cases (ragged lengths, views into their
    storage, tokens outside [0, 2^bits)): the plain version, as the CUDA
    kernel is held to on the card, equals the JAX package's reference."""
    toks, off = cases.pack_edge_tokens(kw, name)
    got = ops.prefix_pack(torch.from_numpy(toks)[off:], SAConfig(**kw),
                          block=PACK_BLOCK)
    want = jref.prefix_pack_ref(jnp.asarray(toks[off:]), RefConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", GATHER_CASES, ids=GATHER_IDS)
def test_window_gather_ref_matches_repro(case):
    corpus, rows, offs, k = gather_case(case)
    before = launch_counts()
    got = ops.window_gather(corpus, rows, offs, k)
    assert launch_counts() == before
    args = tuple(jnp.asarray(t.numpy()) for t in (corpus, rows, offs))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.window_gather_ref(*args, k)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_ops.window_gather(*args, k)))


def _pattern_cmp_matches_repro(arrays, block):
    before = launch_counts()
    got = ops.pattern_cmp(*map(torch.from_numpy, arrays), block=block)
    assert launch_counts() == before  # CPU tensors take the plain version
    jargs = tuple(map(jnp.asarray, arrays))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.pattern_cmp_ref(*jargs)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.pattern_cmp(*jargs, block=block)))
    cmp, matched = masked_cmp(*map(torch.from_numpy, arrays))
    want_cmp, want_matched = masked_cmp_np(*arrays)
    np.testing.assert_array_equal(cmp.numpy(), want_cmp)
    np.testing.assert_array_equal(matched.numpy(), want_matched)
    np.testing.assert_array_equal(cmp.numpy(), got.numpy()[:, 0])
    np.testing.assert_array_equal(matched.numpy(), got.numpy()[:, 1])


@pytest.mark.parametrize("n,k,block", CMP_SHAPES)
def test_pattern_cmp_ref_matches_repro(n, k, block):
    _pattern_cmp_matches_repro(cmp_inputs(n, k), block)


@pytest.mark.parametrize("k", CMP_EDGE_K)
def test_pattern_cmp_edge_rows_match_repro(k):
    """Rows beyond ``0 <= start <= stop <= k``: start > stop, stop > k,
    negative start, padding rows, negative and large tokens, k > 32."""
    _pattern_cmp_matches_repro(cmp_edge_inputs(k), 256)


def test_registry_keys_match_repro():
    assert sorted(KERNEL_REGISTRY) == sorted(REF_REGISTRY)
    for key, entry in KERNEL_REGISTRY.items():
        assert entry.op == REF_REGISTRY[key].op
        assert callable(getattr(ops, entry.op))
        assert entry.ref == REF_REGISTRY[key].ref
        assert callable(getattr(ref, entry.ref))


@pytest.mark.parametrize("key", ["bitonic_sort", "bucket_hist"])
def test_unported_ops_raise(key):
    """The two kernels that were the last to be ported no longer raise: the
    op takes its plain version on a CPU tensor without a launch, and the
    CUDA wrapper refuses that tensor rather than compute on the CPU."""
    from repro_torch.kernels import bitonic_sort as bs_mod
    from repro_torch.kernels import bucket_hist as bh_mod

    x = torch.zeros(4, dtype=torch.int32)
    args = {"bucket_hist": (x, x, x[:1], x[:1]), "bitonic_sort": (x, x, x)}[key]
    op = getattr(ops, KERNEL_REGISTRY[key].op)
    before = launch_counts()
    want = getattr(ref, KERNEL_REGISTRY[key].ref)(*args, *(() if key == "bucket_hist" else (1024,)))
    for g, w in zip(op(*args), want, strict=True):
        assert torch.equal(g, w)
    assert launch_counts() == before
    wrapper = {"bucket_hist": bh_mod.bucket_hist,
               "bitonic_sort": bs_mod.bitonic_sort_tiles}[key]
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert launch_counts() == before


@pytest.mark.parametrize("n,d", HIST_SHAPES)
def test_bucket_hist_ref_matches_repro(n, d):
    """The plain version against ``repro.kernels.ref`` and the Pallas kernel
    (interpret mode) at the ``tests/test_kernels.py`` sweep."""
    arrays = hist_inputs(n, d)
    before = launch_counts()
    got = ops.bucket_hist(*map(torch.from_numpy, arrays), block=HIST_BLOCK)
    assert launch_counts() == before
    want_ref = jref.bucket_hist_ref(*map(jnp.asarray, arrays))
    want_kernel = ref_ops.bucket_hist(*map(jnp.asarray, arrays), block=HIST_BLOCK)
    for g, wr, wk in zip(got, want_ref, want_kernel, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wk))


@pytest.mark.parametrize("n,tile", SORT_SHAPES)
def test_bitonic_sort_tiles_ref_matches_repro(n, tile):
    """Keys equal ``repro.kernels.ref`` and the Pallas network (interpret
    mode) row for row; values are the same multiset within each key group
    (``tests/test_kernels.py``'s contract)."""
    arrays = sort_inputs(n, tile)
    before = launch_counts()
    got = ops.bitonic_sort_tiles(*map(torch.from_numpy, arrays), tile=tile)
    assert launch_counts() == before
    for want in (jref.bitonic_sort_tiles_ref(*map(jnp.asarray, arrays), tile=tile),
                 ref_ops.bitonic_sort_tiles(*map(jnp.asarray, arrays), tile=tile)):
        for g, w in zip(got[:2], want[:2], strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            sorted_rows(*got), sorted_rows(*(torch.from_numpy(np.array(x)) for x in want)))


@pytest.mark.parametrize("name", HIST_EDGE)
def test_bucket_hist_edge_inputs_match_repro(name):
    """Unsorted and repeated splitters, none (D = 1), ``MAX_SPLITTERS``, one
    hot bucket: the plain version equals ``repro.kernels.ref`` and the
    Pallas kernel (interpret mode), which fails on D = 1 (ROADMAP.md
    section 3)."""
    arrays = hist_edge_inputs(name)
    before = launch_counts()
    got = ops.bucket_hist(*map(torch.from_numpy, arrays), block=HIST_BLOCK)
    assert launch_counts() == before
    jargs = tuple(map(jnp.asarray, arrays))
    for g, w in zip(got, jref.bucket_hist_ref(*jargs), strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) == arrays[0].shape[0]
    if name == "d1":
        assert got[1].tolist() == [arrays[0].shape[0]]
        with pytest.raises(ZeroDivisionError):
            ref_ops.bucket_hist(*jargs, block=HIST_BLOCK)
        return
    for g, w in zip(got, ref_ops.bucket_hist(*jargs, block=HIST_BLOCK), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bucket_hist_ref_at_the_int32_max_fault_input():
    """Keys and a splitter at (int32 max, int32 max): the plain version
    equals ``repro.kernels.ref``; the Pallas kernel's padding lands in the
    wrong bucket there (ROADMAP.md section 3)."""
    arrays, block = fault_arrays(HIST_FAULT)
    cols = [arrays[k] for k in ("key_hi", "key_lo", "split_hi", "split_lo")]
    got = ops.bucket_hist(*map(torch.from_numpy, cols), block=block)
    want = jref.bucket_hist_ref(*map(jnp.asarray, cols))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].tolist() == [1, 4, 0]
    pallas = ref_ops.bucket_hist(*map(jnp.asarray, cols), block=block)
    assert np.asarray(pallas[1]).tolist() == [1, 7, -3]


def test_bitonic_sort_tiles_ref_at_the_int32_max_fault_input():
    """A real (int32 max, int32 max) row in a short tile: the plain version
    keeps it, as ``repro.kernels.ref`` does; the Pallas network can sort a
    padding row ahead of it and cut it off (ROADMAP.md section 3)."""
    arrays, tile = fault_arrays(SORT_FAULT)
    cols = [arrays[k] for k in ("key_hi", "key_lo", "val")]
    got = ops.bitonic_sort_tiles(*map(torch.from_numpy, cols), tile=tile)
    want = jref.bitonic_sort_tiles_ref(*map(jnp.asarray, cols), tile=tile)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].tolist() == [8, 7, 9]
    pallas = ref_ops.bitonic_sort_tiles(*map(jnp.asarray, cols), tile=tile)
    assert np.asarray(pallas[2]).tolist() == [8, 7, cases.INT32_MAX]


def _sorted_tiles_match(got, want):
    """Keys row for row; values the same multiset within each key group."""
    for g, w in zip(got[:2], want[:2], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        sorted_rows(*got), sorted_rows(*(torch.from_numpy(np.array(x)) for x in want)))


@pytest.mark.parametrize("n,tile", cases.SORT_LARGE)
def test_bitonic_sort_tiles_above_2048_match_repro(n, tile):
    """Tiles above 2048, which the CUDA wrapper once refused: the CPU op
    equals ``repro.kernels.ref`` at each, and the Pallas network (interpret
    mode) at (5000, 4096)."""
    arrays = sort_inputs(n, tile)
    before = launch_counts()
    got = ops.bitonic_sort_tiles(*map(torch.from_numpy, arrays), tile=tile)
    assert launch_counts() == before
    jargs = tuple(map(jnp.asarray, arrays))
    _sorted_tiles_match(got, jref.bitonic_sort_tiles_ref(*jargs, tile=tile))
    if tile == 4096:
        _sorted_tiles_match(got, ref_ops.bitonic_sort_tiles(*jargs, tile=tile))


@pytest.mark.parametrize("name", cases.SORT_EDGE)
def test_bitonic_sort_tiles_edges_match_repro(name):
    """The CUDA kernel's edge cases (tiles 1-4, ragged tiles of 4096 to
    2^20, a tile above n, equal keys, int32 extremes with real int32-max
    rows in a short tile, views): the CPU op equals ``repro.kernels.ref``."""
    kh, kl, v, tile, offset = sort_edge_inputs(name)
    cols = [torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), a]))[offset:]
            for a in (kh, kl, v)]
    before = launch_counts()
    got = ops.bitonic_sort_tiles(*cols, tile=tile)
    assert launch_counts() == before
    _sorted_tiles_match(got, jref.bitonic_sort_tiles_ref(
        *map(jnp.asarray, (kh, kl, v)), tile=tile))


def _network_stages(steps):
    """The (k, j, flip) stages a launch plan runs, in order: a sort of 2^lt
    runs every merge up to 2^lt; a pass its bits of the current merge."""
    stages, s = [], 0
    for step in steps:
        if step[0] == "sort":
            for s in range(1, step[1] + 1):
                stages.append((1 << s, 1 << (s - 1), True))
                stages += [(1 << s, 1 << b, False) for b in range(s - 2, -1, -1)]
            continue
        _, lo, g, flip = step
        if flip:
            s = lo + g
        bits = range(lo + g - 1, lo - 1, -1)
        stages += [(1 << s, 1 << b, flip and b == s - 1) for b in bits]
    return stages


def _replay(keys, vals, n, steps):
    """The plan's stages as plain compare-exchanges on numpy: the smaller key
    to the lower row, rows past n +inf (never swapped in: a swap needs a
    strictly greater key)."""
    lt = max(step[1] if step[0] == "sort" else step[1] + step[2] for step in steps)
    size = -(-n // (1 << lt)) << lt
    k = np.full(size, np.iinfo(np.int64).max, np.int64)
    v = np.zeros(size, np.int64)
    k[:n], v[:n] = keys, vals
    idx = np.arange(size)
    for kk, j, flip in _network_stages(steps):
        lower = idx[(idx & j) == 0]
        upper = lower ^ (kk - 1) if flip else lower + j
        swap = k[lower] > k[upper]
        a, b = lower[swap], upper[swap]
        k[a], k[b] = k[b], k[a].copy()
        v[a], v[b] = v[b], v[a].copy()
    return k[:n], v[:n]


@pytest.mark.parametrize("lts", [range(0, 13), range(13, 17), range(17, 21)],
                         ids=["in-cta", "2^13-2^16", "2^17-2^20"])
def test_bitonic_sort_plan_is_the_network(lts):
    """For tiles 1 ... 2^20, the launch plan runs exactly the bitonic
    network's (k, j) stages, each launch within what its kernel takes: a
    sort up to T_c, a flip pass of at most log2(T_c) - 1 - MIN_SEG bits, a
    half-cleaner pass of at most log2(T_c) - MIN_SEG (or the in-CTA merge of
    the bits below T_c).  A tile above n sorts n rows as one tile of the
    power of two at or above n."""
    log_tc = bs_mod.LOG_TC
    for lt in lts:
        tile = 1 << lt
        steps = bs_mod.plan(tile, tile)
        want = [(1 << s, 1 << b, b == s - 1)
                for s in range(1, lt + 1) for b in range(s - 1, -1, -1)]
        assert _network_stages(steps) == want
        for step in steps:
            if step[0] == "sort":
                assert step[1] <= log_tc
                continue
            _, lo, g, flip = step
            if flip:
                assert 1 <= g <= log_tc - 1 - bs_mod.MIN_SEG and lo >= log_tc
            elif lo:
                assert 1 <= g <= log_tc - bs_mod.MIN_SEG and lo >= log_tc
            else:
                assert g == log_tc
        for n in {tile // 2 + 1, tile}:
            assert bs_mod.plan(n, 1 << 40) == steps
    assert bs_mod.plan(1, 1 << 20) == [("sort", 0)]


def test_bitonic_sort_plan_constants_are_the_sources():
    """``plan``'s T_c and run length are the CUDA source's kBigLogC and
    kMinSeg (the wrapper also checks the built library's on the card)."""
    src = (Path(bs_mod.__file__).parent / "csrc" / "bitonic_sort.cu").read_text()
    consts = {}
    for name, value in re.findall(r"constexpr int (\w+) = (\w+);", src):
        consts[name] = int(value) if value.isdigit() else consts[value]
    assert (consts["kBigLogC"], consts["kMinSeg"]) == (bs_mod.LOG_TC, bs_mod.MIN_SEG)


@pytest.mark.parametrize("n,tile", [
    (1, 1), (1000, 1), (37, 8), (300, 64), (1000, 1 << 10), (5000, 1 << 12),
    (20_000, 1 << 14), (3, 1 << 16), (70_000, 1 << 16), (600_000, 1 << 20)])
def test_bitonic_sort_plan_replay_sorts(n, tile):
    """Replayed with plain compare-exchanges, the launch plan sorts random
    tiles (short last tile included) to ``repro.kernels.ref``'s keys, and
    keeps every value of each key group.  Tile 2^20 splits a merge's passes
    at j >= T_c in two."""
    kh, kl, v = sort_inputs(n, tile)
    keys = ref._fold(torch.from_numpy(kh), torch.from_numpy(kl)).numpy()
    got_k, got_v = _replay(keys, v, n, bs_mod.plan(n, tile))
    got = [(got_k >> 32), (got_k & 0xFFFFFFFF) - (1 << 31), got_v]
    want = jref.bitonic_sort_tiles_ref(*map(jnp.asarray, (kh, kl, v)), tile=tile)
    _sorted_tiles_match([torch.from_numpy(c.astype(np.int32)) for c in got], want)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never runs on the CPU."""
    toks = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pp_mod.prefix_pack(toks, SAConfig(vocab_size=4))
    with pytest.raises(ValueError, match="CUDA"):
        wg_mod.window_gather(toks.reshape(2, 4), toks[:2], toks[:2], 3)


@pytest.mark.parametrize("case,vector", [
    ((8, 16, 5, 4), True), ((3, 7, 17, 7), False), ("view-odd-l", False),
    ("view-misaligned", False), ("l0", True), ("m257", True)])
def test_window_gather_vector_path_is_read_from_the_pointer(case, vector):
    """16-byte loads only where the corpus starts on a 16-byte boundary and
    L % 4 == 0: a row-slice view of an aligned corpus with odd L, or an L = 8
    corpus one token into its storage, takes the 4-byte loads."""
    corpus = gather_case(case)[0]
    assert wg_mod._vector_path(corpus) is vector


def test_launcher_configures_a_function_once(monkeypatch):
    """``_build.launcher`` keeps the configured ctypes function: a second
    call neither loads nor looks the symbol up again."""
    import ctypes

    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_FUNCS", {})
    monkeypatch.setitem(_build._LOADED, "libc-probe", ctypes.CDLL(None))
    fn = _build.launcher("libc-probe", "abs", [ctypes.c_int])
    assert fn(-7) == 7 and fn.restype is ctypes.c_int
    monkeypatch.delitem(_build._LOADED, "libc-probe")  # a reload would fail
    assert _build.launcher("libc-probe", "abs", [ctypes.c_int]) is fn


def test_pattern_cmp_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 4), dtype=torch.int32)
    before = pc_mod.pattern_cmp.launches
    with pytest.raises(ValueError, match="CUDA"):
        pc_mod.pattern_cmp(x, x, x[0, :2], x[0, :2])
    assert pc_mod.pattern_cmp.launches == before


def _merge_ranks_match_repro(keys, block=256):
    """The plain ranks of ``keys`` (no launch) against ``repro.kernels.ref``
    and the Pallas kernel (interpret mode)."""
    before = launch_counts()
    got = ops.merge_path_ranks(torch.from_numpy(keys), block=block)
    assert launch_counts() == before
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.merge_path_ranks_ref(jnp.asarray(keys))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.merge_path_ranks(jnp.asarray(keys), block=block)))
    return got.numpy()


@pytest.mark.parametrize("r", MERGE_RUNS)
def test_merge_path_sorted_runs_match_repro(r):
    """Tiles of R sorted runs with unique rows, as the merge builds them
    (``merge_runs_inputs`` checks it made R runs): ranks a permutation."""
    keys = merge_runs_inputs(r)
    got = _merge_ranks_match_repro(keys)
    assert sorted(got.tolist()) == list(range(keys.shape[0]))


@pytest.mark.parametrize("name", MERGE_RUN_EDGE)
def test_merge_path_run_edges_match_repro(name):
    """C-1 runs, runs tied on their first 9 words, equal rows across runs,
    ragged run lengths: strictly-less counts, also by brute force."""
    keys = merge_run_edge_inputs(name)
    got = _merge_ranks_match_repro(keys, block=128)
    rows = [tuple(r) for r in keys.tolist()]
    np.testing.assert_array_equal(got, [sum(o < row for o in rows) for row in rows])


def test_merge_runs_counts_descents():
    """``merge_runs``: one run a sorted tile, a new one at every row below
    its predecessor, equal neighbours in one run."""
    keys = np.array([[1, 2], [1, 2], [1, 3], [0, 9], [0, 9], [5, 0], [4, 9]], np.int32)
    assert merge_runs(keys) == 3
    assert merge_runs(keys[:3]) == 1
    assert merge_runs(keys[:0]) == 0
    assert merge_runs(np.array([[-1], [-2], [-3]], np.int32)) == 3


def test_merge_path_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the dispatch op takes the plain version and launches
    nothing; the kernel's own wrapper refuses it."""
    from repro_torch.kernels import merge_path as mp_mod

    keys = torch.tensor([[3, 1], [1, 2], [3, 1], [0, 9]], dtype=torch.int32)
    before = mp_mod.merge_path_ranks.launches
    assert ops.merge_path_ranks(keys).tolist() == [2, 1, 2, 0]
    with pytest.raises(ValueError, match="CUDA"):
        mp_mod.merge_path_ranks(keys)
    assert mp_mod.merge_path_ranks.launches == before



@pytest.mark.parametrize("mode", cases.RUN_GROUPS_MODES)
@pytest.mark.parametrize("name", cases.RUN_GROUPS_CASES)
def test_run_groups_ops_match_repro(name, mode):
    """``ops.run_groups`` (key columns and a valid mask) and
    ``ops.run_starts`` (given flags) on CPU tensors launch nothing and equal
    the JAX package's ``run_starts`` over the same flags, at the CUDA
    kernel's edges: empty and one-row inputs, lengths around a tile, one run
    over every tile, every row distinct, padding rows at the end and in the
    middle, views one and three elements into their storage."""
    keys, flags = cases.run_groups_tensors(name, mode)
    before = launch_counts()
    got = ops.run_starts(flags) if mode.startswith("eq") else ops.run_groups(keys, flags)
    assert launch_counts() == before  # CPU tensors take the plain version
    assert got.dtype == torch.int32
    eq = cases.run_groups_eq([k.numpy() for k in keys], flags.numpy(), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdist.run_starts(jnp.asarray(eq))))


@pytest.mark.parametrize("what", ["cpu", "int64", "strided", "int-flags", "four-columns"])
def test_run_groups_wrapper_refuses(what):
    """The kernel's wrapper takes contiguous 1-D int32 CUDA columns and a
    bool CUDA mask, at most three columns; on anything else it raises and
    launches nothing (on the CPU every tensor is refused, with what else is
    wrong named)."""
    col = torch.arange(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    keys, valid, match = {
        "cpu": ([col], valid, "key column 0 must be .* CUDA tensor, got torch.int32"),
        "int64": ([col.long()], valid, "got torch.int64"),
        "strided": ([torch.arange(16, dtype=torch.int32)[::2]], valid, "not contiguous"),
        "int-flags": ([], col, "valid must be .*torch.bool.*got torch.int32"),
        "four-columns": ([col] * 4, valid, "at most 3 key columns"),
    }[what]
    before = launch_counts()
    with pytest.raises(ValueError, match=match):
        rg_mod.run_groups(keys, valid)
    with pytest.raises(ValueError, match="eq_prev must be .* CUDA"):
        rg_mod.run_starts(valid.bool())
    assert launch_counts() == before


def test_in_core_build_computes_run_groups_once_a_round(monkeypatch):
    """An in-core build asks ``ops.run_groups`` once after the first sort
    and once a refinement round: ``stats["iters"] + 1`` calls, as many
    kernel launches as a card build makes."""
    from repro_torch.core.pipeline import build_suffix_array
    from repro_torch.data.corpus import synth_dna_reads

    calls = []
    real = ops.run_groups
    monkeypatch.setattr(ops, "run_groups", lambda *a: calls.append(1) or real(*a))
    reads = synth_dna_reads(40, 30, seed=3)
    res = build_suffix_array(reads, cfg=SAConfig(vocab_size=4), device="cpu")
    assert res.stats["iters"] >= 1
    assert len(calls) == res.stats["iters"] + 1
