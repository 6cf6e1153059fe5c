"""Out-of-core, streaming, journaled and indexed builds of ``repro`` on D fake
devices against ``repro_torch`` on D ranks.

Shared by ``tests/test_torch_distributed_ooc.py`` (the merge matrix) and
``tests/test_torch_distributed_index.py`` (streaming, the journal, the
sanitizer, ``SuffixArrayIndex``).  :func:`repro_main` runs a group's cases
in a process whose jax sees D CPU devices; :func:`port_rank` runs them in
one of D spawned processes, a gloo rank each.  Each writes its results,
keyed by ``(case, use_pallas)``, as a pickle.  A result holds the suffix
array, the LCP array, the ``Footprint``, the stats but the walls, the
sanitizer's counts, the index directory's files (the manifest less its
walls and self-crc) and query answers with ``engine_stats()``, or the
exception a refused resume raised.

A journaled case kills the port's build on every rank at a pipeline point,
copies rank 0's ``spill_dir`` for ``repro``, and resumes; ``repro`` resumes
the copy, so ``journal_hits`` is held to ``repro``'s on the same killed
state (it depends on when the worker finished a spill).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

K2 = dict(vocab_size=4, chars_per_word=2, key_words=2)  # K = 4: forces rounds
K3 = dict(vocab_size=4, chars_per_word=3, key_words=2)
S = 3
READS = np.random.default_rng(1).integers(1, 5, size=(101, 17)).astype(np.int32)
TEXT = np.random.default_rng(3).integers(1, 5, size=(1000,)).astype(np.int32)
# a quarter of the reads' bytes: the chunked cache misses
STREAM_BUDGET = READS.size * 4 // 4

# name -> (kind, corpus, config fields, SuperblockConfig fields and options)
CASES = {}
for _corpus, _fields in (("reads", K2), ("text", K3)):
    for _name, _sbk in (("host", dict(merge_backend="host")),
                        ("device", dict(merge_backend="device")),
                        ("kway", dict(merge_algorithm="kway")),
                        ("rerank", dict(merge_algorithm="rerank"))):
        CASES[f"{_corpus}-{_name}"] = ("build", _corpus, _fields, _sbk)
CASES.update({
    "stream-index": ("build", "reads", K2, dict(
        store_backend="chunked", cache_budget_bytes=STREAM_BUDGET,
        chunk_records=8, index=True)),
    "sanitize": ("build", "reads", K2, dict(store_backend="chunked",
                                            chunk_records=16, sanitize=True)),
    "kill-last-block": ("resume", "reads", K2, dict(kill=("build:block", S))),
    "kill-first-rank": ("resume", "reads", K2, dict(kill=("merge:rank", 1))),
    "refused-fingerprint": ("refused", "reads", K2, dict(kill=("merge:rank", 1))),
    "refused-corrupt": ("refused", "reads", K2, dict(kill=("merge:rank", 1),
                                                     corrupt=True)),
    "index": ("index", "reads", K2, {}),
    "index-dir": ("index", "reads", K2, dict(index=True)),
})
GROUPS = {
    "ooc": [f"{c}-{m}" for c in ("reads", "text")
            for m in ("host", "device", "kway", "rerank")],
    "index": ["stream-index", "sanitize", "kill-last-block", "kill-first-rank",
              "refused-fingerprint", "refused-corrupt", "index", "index-dir"],
}
# The cases whose repro result with use_pallas on equals, field for field, its
# result with it off (both were run and compared at D = 3 and 4): repro runs
# them once, with use_pallas off, and the port's runs with it off and on are
# both held to that result.  The others' results carry use_pallas (the index
# directory's name and the manifest's sa_config), so repro runs them both ways.
PALLAS_INVARIANT = {*GROUPS["ooc"], "sanitize", "refused-fingerprint",
                    "refused-corrupt", "index"}
INDEX_FILES = ("suffix_array.npy", "lcp.npy", "corpus.sachunk")
WALLS = ("t_stage_s", "t_build_s", "t_merge_s")


class Kill(Exception):
    """The simulated crash at a pipeline point."""


def corpus(kind):
    return READS if kind == "reads" else TEXT


def patterns(data, count=24, seed=5):
    """Query patterns drawn from the corpus, and two absent ones."""
    rng = np.random.default_rng(seed)
    flat = data.reshape(-1)
    pats = [flat[s : s + m].astype(np.int64)
            for s, m in zip(rng.integers(0, flat.size - 10, count),
                            rng.integers(1, 10, count), strict=True)]
    return pats + [np.array([1, 2, 3, 4, 1, 2, 3], np.int64), np.array([9], np.int64)]


def index_files(index_dir):
    """sha256 of each index file, and the manifest less its walls and crc."""
    out = {}
    for name in INDEX_FILES:
        with open(os.path.join(index_dir, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(index_dir, "manifest.json")) as f:
        m = json.load(f)
    m.pop("manifest_crc")
    m["stats"] = {k: v for k, v in m["stats"].items() if k not in WALLS}
    out["manifest"] = m
    return out


def summary(res, spill_dir=None):
    stats = {k: v for k, v in res.stats.items() if k not in WALLS}
    if "index_dir" in stats:
        stats["index_dir"] = os.path.basename(stats["index_dir"])
    out = {"sa": np.array(res.suffix_array),
           "lcp": None if res.lcp is None else np.array(res.lcp),
           "footprint": dataclasses.asdict(res.footprint), "stats": stats}
    if spill_dir is not None and os.path.exists(os.path.join(spill_dir, "manifest.json")):
        out["files"] = index_files(spill_dir)
    return out


def answers(idx, data):
    pats = patterns(data)
    out = {"count": np.asarray(idx.count(pats)).tolist(),
           "align": [list(map(tuple, np.asarray(h).tolist())) for h in idx.align(pats)],
           "locate": [np.asarray(h).tolist() for h in idx.locate(pats)],
           "engine_stats": idx.engine.engine_stats()}
    stats = dict(idx.stats())
    stats["index_dir"] = stats["index_dir"] and os.path.basename(stats["index_dir"])
    out["stats"] = stats
    out["build_stats"] = {k: v for k, v in idx.build_stats.items()
                          if k not in WALLS + ("index_dir",)}
    return out


class Package:
    """The calls a case makes, in ``repro`` or in ``repro_torch`` (on the
    CPU); ``recorded`` collects the sanitizer's proxies the build made."""

    def __init__(self, name):
        self.name = name
        if name == "repro":
            import repro.core.superblock as sbmod
            from repro import SuffixArrayIndex
            from repro.config import SAConfig, SuperblockConfig

            self.extra = {}
        else:
            import repro_torch.core.superblock as sbmod
            from repro_torch import SuffixArrayIndex
            from repro_torch.config import SAConfig, SuperblockConfig

            self.extra = {"device": "cpu"}
        self.sbmod, self.index = sbmod, SuffixArrayIndex
        self.SAConfig, self.SuperblockConfig = SAConfig, SuperblockConfig
        self.recorded = []
        self.journals = {}  # the port's killed states' journal records
        for cls_name in ("SanitizingBackend", "SanitizingSink"):
            real = getattr(sbmod, cls_name)
            recorded = self.recorded

            class Recorded(real):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    recorded.append(self)

            Recorded.__name__ = cls_name
            setattr(sbmod, cls_name, Recorded)

    def sanitizer_counts(self):
        out = []
        for obj in self.recorded:
            if hasattr(obj, "pairs_checked"):
                out.append(("sink", obj.pairs_checked))
            else:
                out.append(("backend", obj.checks, obj.oracle_windows_checked,
                            obj.observed_peak_bytes))
        del self.recorded[:]
        return out

    def build(self, data, fields, use_pallas, sb):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return self.sbmod.build_suffix_array_superblock(
                data, cfg=self.SAConfig(**fields, use_pallas=use_pallas), sb=sb,
                **self.extra)

    def killed(self, data, fields, use_pallas, sb, label, at):
        """Build, raising :class:`Kill` at the ``at``-th ``label``."""
        real = self.sbmod.pipeline_point
        seen = [0]

        def probe(lbl):
            real(lbl)
            if lbl == label:
                seen[0] += 1
                if seen[0] == at:
                    raise Kill(label)

        self.sbmod.pipeline_point = probe
        try:
            self.build(data, fields, use_pallas, sb)
        except Kill:
            return
        finally:
            self.sbmod.pipeline_point = real
        raise AssertionError(f"the build passed {label} #{at} without a kill")


def sb_fields(opts, spill_dir):
    out = {k: v for k, v in opts.items() if k not in ("index", "kill", "corrupt")}
    out.update(num_superblocks=S, emit_lcp=True)
    if opts.get("index"):
        out.update(spill_dir=spill_dir, write_manifest=True)
    return out


def corrupt_journal(spill_dir):
    """Flip a byte inside the journal's first record (an interior one)."""
    path = os.path.join(spill_dir, "build.journal")
    with open(path, "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0x01]))


def refusal(e):
    """What a refused resume raised, its paths aside."""
    return (type(e).__name__, getattr(e, "artifact", None) or str(e))


def run_case(pkg, name, use_pallas, base, copies, rank=0, barrier=lambda: None):
    """One case in ``pkg``; ``base`` is this package's directory, ``copies``
    holds the killed states (written by the port's rank 0, resumed by
    repro)."""
    kind, kind_corpus, fields, opts = CASES[name]
    data = corpus(kind_corpus)
    tag = f"{name}-{int(use_pallas)}"
    spill = os.path.join(base, tag)
    if kind == "build":
        sb = pkg.SuperblockConfig(**sb_fields(opts, spill))
        out = summary(pkg.build(data, fields, use_pallas, sb), sb.spill_dir)
        out["sanitizer"] = pkg.sanitizer_counts()
        return out
    if kind == "index":
        sb = pkg.SuperblockConfig(num_superblocks=S)
        idx_dir = spill if opts.get("index") else None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            idx = pkg.index.build(data, cfg=pkg.SAConfig(**fields, use_pallas=use_pallas),
                                  sb=sb, index_dir=idx_dir, num_shards=2, **pkg.extra)
        out = answers(idx, data)
        if idx_dir is not None:
            out["files"] = index_files(idx_dir)
        idx.close()
        return out
    # journaled: the port is killed, its rank 0 copies the state, both resume
    sb = pkg.SuperblockConfig(**sb_fields(opts, None), spill_dir=spill, resume=True,
                              write_manifest=True)
    copy = os.path.join(copies, tag)
    if pkg.name == "port":
        pkg.killed(data, fields, use_pallas, sb, *opts["kill"])
        barrier()  # rank 0's killed state is on disk
        with open(os.path.join(spill, "build.journal")) as f:
            pkg.journals[tag] = [json.loads(line) for line in f]
        barrier()  # read on every rank before rank 0 corrupts or copies it
        if rank == 0:
            if opts.get("corrupt"):
                corrupt_journal(spill)
            shutil.copytree(spill, copy)
        barrier()
    else:
        sb = dataclasses.replace(sb, spill_dir=copy)
    if kind == "refused":
        if not opts.get("corrupt"):
            data = data[::-1].copy()  # another corpus: its fingerprint differs
        try:
            pkg.build(data, fields, use_pallas, sb)
        except Exception as e:  # the refusal, compared with repro's
            return {"refused": refusal(e)}
        return {"refused": None}
    out = summary(pkg.build(data, fields, use_pallas, sb), sb.spill_dir)
    out["sanitizer"] = pkg.sanitizer_counts()
    return out


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------


def repro_main(out_path, group, base, copies):
    """``group``'s cases with use_pallas off and on, in repro (once, off, for
    the cases of ``PALLAS_INVARIANT``)."""
    pkg = Package("repro")
    results = {}
    for name in GROUPS[group]:
        results[name, False] = run_case(pkg, name, False, base, copies)
        results[name, True] = (results[name, False] if name in PALLAS_INVARIANT
                               else run_case(pkg, name, True, base, copies))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


def port_rank(rank, d, out_dir, group):
    """One gloo rank of ``d`` (a ``torch.multiprocessing`` spawn target):
    ``group``'s cases with use_pallas off and on; writes
    ``rank{rank}.pkl``.  The process group times out in 60 s, so a rank
    that raised alone fails the others instead of hanging them."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rdzv')}",
                            rank=rank, world_size=d,
                            timeout=datetime.timedelta(seconds=60))
    try:
        pkg = Package("port")
        base = os.path.join(out_dir, "port")
        copies = os.path.join(out_dir, "copies")
        results = {}
        for name in GROUPS[group]:
            for use_pallas in (False, True):
                results[name, use_pallas] = run_case(
                    pkg, name, use_pallas, base, copies, rank, dist.barrier)
        results["journals"] = pkg.journals
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# running both
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def start_repro(group, d, out_dir):
    """repro on d fake devices, in a subprocess; :func:`finish_repro` reads
    its results."""
    path = os.path.join(out_dir, "repro.pkl")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    code = (f"import _torch_dist_ooc_cases as c; c.repro_main({path!r}, {group!r}, "
            f"{os.path.join(out_dir, 'repro')!r}, {os.path.join(out_dir, 'copies')!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE), path


def finish_repro(started):
    proc, path = started
    try:
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def spawn_ranks(group, d, out_dir):
    """:func:`port_rank` on d gloo ranks; every rank's results.  A rank
    left running past the time limit is killed and fails the test."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(port_rank, args=(d, out_dir, group), nprocs=d,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{d} ranks did not finish in {TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for rank in range(d):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
