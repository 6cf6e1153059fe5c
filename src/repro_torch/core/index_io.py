"""Persistent suffix-array index layout: manifest + SA/LCP arrays + corpus.

The port of ``repro.core.index_io``: the same directory, file names, bytes
and manifest, so an index saved by either package opens in the other.

A *built index* is a directory the query engine can reopen with no rebuild
and no re-threading of the corpus by hand (Giacomelli's Bigtable SA: the
index is a persistent, queryable store — construction is just its producer):

    {index_dir}/
      manifest.json       geometry, SAConfig echo, artifact pointers, stats
      suffix_array.npy    (n,) int64 global suffix indexes, final order
      lcp.npy             (n,) int64 adjacent-pair LCP array (optional)
      corpus.sachunk      chunked corpus (repro.data.chunk_store format),
                          unless the manifest points at an external corpus
                          file the caller already owns

Writers: the out-of-core build streams ``suffix_array.npy``/``lcp.npy``
directly into ``spill_dir`` and calls :func:`save_index` to finalize
(``SuperblockConfig.write_manifest``); ``SuffixArrayIndex.save`` does the
same for in-memory results.  Reader: :func:`open_index` reconstructs a
read-only :class:`~repro_torch.core.store.StoreBackend` over the persisted
corpus plus memmapped SA/LCP — the ``CorpusStore`` open path; the backend's
windows land on ``device`` (the card by default).

All artifact pointers in the manifest are relative to the index directory
when the artifact lives inside it (the directory stays relocatable), and
absolute when it points at an external corpus file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dataclasses import asdict

from repro_torch.config import SAConfig
from repro_torch.core.integrity import (
    CorruptionError,
    crc32_bytes,
    crc32_file,
    fsync_file,
    publish_file,
)
from repro_torch.core.sanitize import SanitizingBackend, sanitize_enabled
from repro_torch.core.store import (
    ChunkedFileBackend,
    InMemoryBackend,
    StoreBackend,
    stream_backend_items,
)

MANIFEST_NAME = "manifest.json"
SA_FILE = "suffix_array.npy"
LCP_FILE = "lcp.npy"
CORPUS_FILE = "corpus.sachunk"
FORMAT = "repro-sa-index"
VERSION = 2  # v2 adds the per-artifact checksum digests + manifest self-crc

# Items per read_items batch when serializing a backend's corpus to disk —
# bounds the host copy during save regardless of corpus size.
_SERIALIZE_BATCH = 1 << 16


def _same_file(a: Optional[str], b: str) -> bool:
    return a is not None and os.path.abspath(a) == os.path.abspath(b)


def _write_array(arr: np.ndarray, path: str) -> None:
    """np.save via the durable atomic-publish helper, unless ``arr`` is
    already memmapped at ``path`` (the streaming build's sink wrote it in
    place) — then it is flushed and fsync'd where it lies."""
    if isinstance(arr, np.memmap) and _same_file(getattr(arr, "filename", None), path):
        arr.flush()  # msync: pages reach the file
        fsync_file(path)  # and the file reaches the platter
        return
    tmp = path + ".tmp.npy"  # np.save appends .npy to suffix-less paths
    np.save(tmp, np.asarray(arr))
    publish_file(tmp, path)


def _serialize_corpus(backend: StoreBackend, path: str, chunk_items: int = 0) -> None:
    """Stream the backend's items into a chunked corpus file, atomically.

    ``write_chunked_stream`` owns the whole safe-publish sequence (sibling
    tmp, back-patched header, fsync'd rename via
    :func:`repro.core.integrity.publish_file`) — a crash mid-serialization
    can never leave a plausible but truncated ``corpus.sachunk`` for a
    later ``open_index`` to trust.
    """
    from repro_torch.data.chunk_store import write_chunked_stream

    write_chunked_stream(
        stream_backend_items(backend, _SERIALIZE_BATCH), path,
        chunk_items=chunk_items,
    )


def save_index(
    index_dir: str,
    cfg: SAConfig,
    backend: StoreBackend,
    sa: np.ndarray,
    lcp: Optional[np.ndarray] = None,
    stats: Optional[Dict[str, Any]] = None,
    corpus_ref: Optional[str] = None,
    chunk_items: int = 0,
) -> str:
    """Write a complete index directory; returns the manifest path.

    ``corpus_ref``: a persistent chunked corpus file to *point at* instead
    of serializing (the user's own ``--corpus-file``, or a file the build
    already placed inside ``index_dir``).  None serializes the backend's
    items into ``{index_dir}/corpus.sachunk``.  Arrays already memmapped at
    their target paths (the streaming sink's output) are not rewritten.
    """
    os.makedirs(index_dir, exist_ok=True)
    _write_array(sa, os.path.join(index_dir, SA_FILE))
    if lcp is not None:
        _write_array(lcp, os.path.join(index_dir, LCP_FILE))

    if corpus_ref is None:
        corpus_path = os.path.join(index_dir, CORPUS_FILE)
        if not _same_file(getattr(backend, "path", None), corpus_path):
            _serialize_corpus(backend, corpus_path, chunk_items)
        corpus_entry = CORPUS_FILE
    else:
        ref = os.path.abspath(corpus_ref)
        inside = os.path.dirname(ref) == os.path.abspath(index_dir)
        corpus_entry = os.path.basename(ref) if inside else ref
        corpus_path = ref

    # end-to-end digests: whole-file crc32 of every artifact the manifest
    # points at, verified by open_index(verify="eager") before any query
    # trusts the bytes.
    checksums = {
        SA_FILE: crc32_file(os.path.join(index_dir, SA_FILE)),
        "corpus": crc32_file(corpus_path),
    }
    if lcp is not None:
        checksums[LCP_FILE] = crc32_file(os.path.join(index_dir, LCP_FILE))

    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "suffix_array": SA_FILE,
        "lcp": LCP_FILE if lcp is not None else None,
        "corpus": {"kind": "chunked", "path": corpus_entry},
        "checksums": checksums,
        "geometry": {
            "text_mode": bool(backend.text_mode),
            "items": int(backend.n),
            "row_len": int(backend.row_len),
            "stride_bits": int(backend.stride_bits),
            "suffixes": int(np.asarray(sa).shape[0]),
        },
        "sa_config": asdict(cfg),
        "stats": _json_safe(stats or {}),
    }
    # self-crc over the canonical manifest body: any later bit-flip in the
    # manifest file is detectable, not just flips that break json parsing
    manifest["manifest_crc"] = crc32_bytes(
        json.dumps(manifest, sort_keys=True,
                   separators=(",", ":")).encode("utf-8"))
    mpath = os.path.join(index_dir, MANIFEST_NAME)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    publish_file(tmp, mpath)
    return mpath


def _json_safe(obj: Any) -> Any:
    """Stats dicts carry numpy scalars; coerce to plain json types (drop
    anything that still won't serialize rather than failing the save)."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist() if obj.size <= 64 else f"<array {obj.shape}>"
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def read_manifest(index_dir: str) -> Dict[str, Any]:
    mpath = os.path.join(index_dir, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise CorruptionError("index manifest", detail=str(e),
                              path=mpath) from e
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise CorruptionError(
            "index manifest", detail=f"not a {FORMAT} manifest", path=mpath)
    if manifest.get("version", 0) > VERSION:
        raise ValueError(
            f"{mpath}: version {manifest['version']} is newer than "
            f"this reader ({VERSION})"
        )
    expected = manifest.pop("manifest_crc", None)
    if expected is not None:
        got = crc32_bytes(json.dumps(manifest, sort_keys=True,
                                     separators=(",", ":")).encode("utf-8"))
        if got != expected:
            raise CorruptionError(
                "index manifest",
                detail=f"self-crc 0x{got:08x} != recorded 0x{expected:08x}",
                path=mpath)
    return manifest


def _verify_artifact(path: str, expected: int, artifact: str) -> None:
    try:
        got = crc32_file(path)
    except OSError as e:
        raise CorruptionError(artifact, detail=f"unreadable: {e}",
                              path=path) from e
    if got != expected:
        raise CorruptionError(
            artifact,
            detail=f"crc 0x{got:08x} != manifest 0x{expected:08x}",
            path=path)


def open_index(
    index_dir: str,
    store_backend: str = "chunked",
    cache_budget_bytes: int = 0,
    verify: str = "lazy",
    device=None,
) -> Tuple[StoreBackend, np.ndarray, Optional[np.ndarray], Dict[str, Any]]:
    """Read-only open: ``(backend, sa, lcp, manifest)``, no rebuild.

    ``store_backend`` picks the corpus residency regime for serving:
    ``"chunked"`` (default) keeps the corpus on disk behind the budgeted LRU
    chunk cache; ``"memory"`` materializes it resident on ``device`` for
    latency.  The SA (and LCP, when present) are memmapped read-only.

    ``verify`` picks the integrity posture (manifest self-crc is always
    checked):

    * ``"eager"`` — every artifact's whole-file crc32 is verified against
      the manifest digests before the open returns: nothing a query later
      touches is unchecked.  One sequential pass over each file.
    * ``"lazy"`` (default) — corpus chunks are verified per-read as the LRU
      loads them (v2 chunk footer); whole-file digests are not pre-checked.
    * ``"off"`` — no checksum verification at all.

    Verification failures raise
    :class:`~repro_torch.core.integrity.CorruptionError` naming the
    artifact.  Under ``REPRO_SANITIZE`` the backend is wrapped in the
    sanitizer (:class:`~repro_torch.core.sanitize.SanitizingBackend`).
    """
    if verify not in ("eager", "lazy", "off"):
        raise ValueError(f"unknown verify mode {verify!r}")
    manifest = read_manifest(index_dir)
    cfg = SAConfig(**manifest["sa_config"])

    corpus_path = manifest["corpus"]["path"]
    if not os.path.isabs(corpus_path):
        corpus_path = os.path.join(index_dir, corpus_path)
    checksums = manifest.get("checksums") or {}
    if verify == "eager" and checksums:
        _verify_artifact(os.path.join(index_dir, SA_FILE),
                         checksums[SA_FILE], SA_FILE)
        if manifest.get("lcp") and LCP_FILE in checksums:
            _verify_artifact(os.path.join(index_dir, LCP_FILE),
                             checksums[LCP_FILE], LCP_FILE)
        if "corpus" in checksums:
            _verify_artifact(corpus_path, checksums["corpus"],
                             manifest["corpus"]["path"])
    if store_backend == "chunked":
        backend: StoreBackend = ChunkedFileBackend(
            corpus_path, cfg, cache_budget_bytes=cache_budget_bytes,
            verify=verify != "off", device=device,
        )
    elif store_backend == "memory":
        from repro_torch.data import chunk_store

        backend = InMemoryBackend(chunk_store.load_corpus(corpus_path), cfg,
                                  device=device)
    else:
        raise ValueError(f"unknown store backend {store_backend!r}")
    if sanitize_enabled():
        backend = SanitizingBackend(backend)

    sa = np.load(os.path.join(index_dir, SA_FILE), mmap_mode="r")
    lcp = None
    if manifest.get("lcp"):
        lcp = np.load(os.path.join(index_dir, LCP_FILE), mmap_mode="r")
    return backend, sa, lcp, manifest
