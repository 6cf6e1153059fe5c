"""Artifact integrity primitives: error taxonomy, checksums, atomic publish.

A numpy copy of ``repro.core.integrity`` (the port imports nothing of the
JAX package).  Three small, widely-shared pieces that make the out-of-core
build crash-safe (see ``docs/fault_tolerance.md``):

* **Error taxonomy.**  :class:`CorruptionError` means *bytes on disk are
  wrong* — a checksum mismatch, a torn artifact, a bad magic.  It names the
  artifact, and it is **fatal**: retrying a corrupt read can only return the
  same corrupt bytes (or, worse, a different wrong answer), so no retry
  layer may catch it.  :class:`TransientError` is the opposite contract —
  a fault that *may* succeed on retry (an injected store fault, a flaky
  remote read).  The retry layers (``repro_torch.core.store.RetryingBackend``)
  share this split so a corruption can never be masked by a retry loop.

* **Checksums.**  Thin stdlib ``zlib.crc32`` helpers over bytes, arrays and
  files.  crc32 is not cryptographic — the threat model is torn writes,
  truncation and bit rot, not adversaries — and it is cheap enough to leave
  on by default (the ``benchmarks.run build`` integrity section gates the
  overhead under 5%).

* **Atomic publish.**  ``tmp + os.replace`` alone does not survive power
  loss: the rename itself lives in the directory, and the directory entry
  is not durable until the directory is fsync'd.  :func:`publish_file` /
  :func:`publish_dir` are the *only* sanctioned way to move a finished
  build/index artifact to its final name (salint SAL012 flags
  ``os.replace`` / ``os.rename`` elsewhere).
"""
from __future__ import annotations

import os
import zlib
from typing import Optional

import numpy as np

__all__ = [
    "CorruptionError",
    "TransientError",
    "TransientStoreError",
    "DEFAULT_RETRYABLE",
    "crc32_bytes",
    "crc32_array",
    "crc32_file",
    "fsync_dir",
    "fsync_file",
    "publish_file",
    "publish_dir",
]


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


class CorruptionError(Exception):
    """On-disk artifact bytes failed verification.  Fatal: never retried.

    ``artifact`` names what failed (e.g. ``"spilled run run3.npy"``,
    ``"chunk 7 of corpus.sachunk"``, ``"build journal record 12"``) so the
    operator knows *which file* to restore; ``path`` is the offending file
    when one exists.
    """

    def __init__(self, artifact: str, detail: str = "",
                 path: Optional[str] = None):
        self.artifact = artifact
        self.detail = detail
        self.path = path
        msg = f"corrupt artifact: {artifact}"
        if path:
            msg += f" ({path})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)

    def __reduce__(self):
        # pickled with its own fields (a refusal broadcast to other ranks)
        return type(self), (self.artifact, self.detail, self.path)


class TransientError(RuntimeError):
    """A fault that may succeed on retry (network blip, injected fault).

    The shared base of ``runtime.fault.TransientFault`` and
    :class:`TransientStoreError`; the default ``retryable`` allowlist of the
    retry layers.
    """


class TransientStoreError(TransientError):
    """Transient fault raised from a store backend read/gather."""


# what retry layers retry unless told otherwise
DEFAULT_RETRYABLE = (TransientError,)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------


def crc32_bytes(data, seed: int = 0) -> int:
    """crc32 of a bytes-like object, as an unsigned int."""
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def crc32_array(arr: np.ndarray, seed: int = 0) -> int:
    """crc32 of an array's raw bytes (C order; copies only if non-contiguous)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(memoryview(a).cast("B"), seed) & 0xFFFFFFFF


def crc32_file(path: str, block: int = 1 << 20) -> int:
    """Streaming crc32 of a whole file (bounded memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(block)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# durable atomic publish
# ---------------------------------------------------------------------------


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it survive power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_file(path: str) -> None:
    """fsync a file's contents by path (for data written via memmap/other fds)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def publish_file(tmp_path: str, final_path: str, *,
                 durable: bool = True) -> None:
    """Atomically publish ``tmp_path`` at ``final_path``.

    ``durable=True`` (default) fsyncs the tmp file's contents first and the
    containing directory after the rename — the full power-loss-safe
    sequence.  ``durable=False`` keeps just the atomicity (crash-safe, not
    power-loss-safe) for callers on scratch data where the fsync cost is
    not warranted.
    """
    if durable:
        fsync_file(tmp_path)
    os.replace(tmp_path, final_path)  # salint: disable=SAL012
    if durable:
        fsync_dir(os.path.dirname(os.path.abspath(final_path)))


def publish_dir(tmp_dir: str, final_dir: str, *, durable: bool = True) -> None:
    """Atomically publish a finished directory (e.g. a checkpoint step dir).

    ``os.rename`` (not ``replace``): directory-over-directory replace is not
    portable, and publish targets are fresh names by construction.
    """
    if durable:
        fsync_dir(tmp_dir)
    os.rename(tmp_dir, final_dir)  # salint: disable=SAL012
    if durable:
        fsync_dir(os.path.dirname(os.path.abspath(final_dir)))
