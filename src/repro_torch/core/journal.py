"""Append-only build journal: crash-safe progress records for the
out-of-core superblock build (the port of ``repro.core.journal``).

One JSON record per line, each carrying a ``crc`` of its own canonical
serialization, fsync'd at unit-of-recovery boundaries.  The journal lives
under ``SuperblockConfig.spill_dir`` next to the stable scratch directory;
``resume=True`` replays it on re-entry and skips every verified-complete
block (``docs/fault_tolerance.md`` has the record format and the resume
semantics).  The format is the JAX package's byte for byte: the same
canonical form and the same crc, so a journal written by either package
resumes in the other.

Record types (``"t"``):

* ``begin``: the build fingerprint (corpus geometry, a content signature
  and the plan shape).  A resume against a different corpus or plan is
  refused.
* ``block``: block ``i``'s sorted run is durably spilled: run file name,
  content crc, row count, and the block's build stats and footprint
  contributions, so a resumed build adopts the block without rebuilding
  it.  Always fsync'd: this is the unit of recovery.
* ``emit``: the merge's emission watermark (rows emitted so far), with a
  batched fsync: the merge is redone wholesale on resume.
* ``done``: the build finished and its artifacts are published.

On replay a torn **final** record (the crash landed mid-append) is dropped
and its unit replays; a corrupt **interior** record is a
:class:`~repro_torch.core.integrity.CorruptionError`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.integrity import (
    CorruptionError,
    crc32_array,
    crc32_bytes,
    fsync_dir,
)

__all__ = ["JOURNAL_NAME", "BuildJournal", "verify_spilled_run"]

JOURNAL_NAME = "build.journal"

# non-durable records (emit) still reach the disk at this cadence, so a
# crash loses at most a bounded window of observability records
_SYNC_EVERY = 64


def _coerce(x):
    """json default hook: numpy scalars and arrays -> Python natives;
    anything else degrades to ``str`` (deterministic, so the replayed
    canonical form still matches the crc)."""
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def _canon(rec: Dict[str, Any]) -> str:
    """Canonical serialization the crc is computed over: sorted keys, no
    whitespace, numpy coerced to the natives json parses back."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"),
                      default=_coerce)


class BuildJournal:
    """Writer and replayer of the build journal.  Main-thread only: a
    block's record is appended once its spill write is observed done
    (``PipelineTask.done()``), so no locking is needed (salint
    SAL008/SAL009).  At D ranks only rank 0 opens it: the build's
    ``spill_dir`` is rank 0's."""

    VERSION = 1

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._unsynced = 0
        self.appended = 0

    # -- writing ----------------------------------------------------------

    def open(self) -> "BuildJournal":
        self._f = open(self.path, "a", encoding="utf-8")
        return self

    def append(self, rec: Dict[str, Any], durable: bool = True) -> None:
        """Append one record (its ``crc`` stamped here); ``durable=True``
        fsyncs before returning, and the record's unit is then
        recoverable."""
        assert self._f is not None, "journal not open"
        body = _canon(rec)
        rec = dict(rec)
        rec["crc"] = crc32_bytes(body.encode("utf-8"))
        self._f.write(_canon(rec) + "\n")
        self._f.flush()
        self.appended += 1
        if durable:
            os.fsync(self._f.fileno())
            self._unsynced = 0
        else:
            self._unsynced += 1
            if self._unsynced >= _SYNC_EVERY:
                os.fsync(self._f.fileno())
                self._unsynced = 0

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def finalize(self) -> None:
        """A finished build: remove the journal durably, so a later build
        in the same directory starts clean."""
        self.close()
        if os.path.exists(self.path):
            os.unlink(self.path)
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))

    # -- replay -----------------------------------------------------------

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        """The journal's validated records.  A torn final append (a
        truncated line, no trailing newline) is dropped; any other record
        that fails validation raises :class:`CorruptionError` naming it."""
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            raw = f.read().decode("utf-8", errors="replace")
        lines = raw.split("\n")
        tail_torn = bool(lines) and lines[-1] != ""  # no trailing newline
        if lines and lines[-1] == "":
            lines.pop()
        records: List[Dict[str, Any]] = []
        for idx, line in enumerate(lines):
            rec: Optional[Dict[str, Any]] = None
            ok = False
            try:
                parsed = json.loads(line)
                if isinstance(parsed, dict) and "crc" in parsed:
                    crc = parsed.pop("crc")
                    ok = crc == crc32_bytes(_canon(parsed).encode("utf-8"))
                    rec = parsed
            except ValueError:
                ok = False
            if not ok:
                if idx == len(lines) - 1 and tail_torn:
                    break  # torn final append: dropped, its unit replays
                raise CorruptionError(f"build journal record {idx}", path=path)
            records.append(rec)
        return records


def verify_spilled_run(path: str, expected_crc: int, artifact: str) -> np.ndarray:
    """A journaled spilled run's read-only memmap, its content crc checked.
    A load failure or a crc mismatch is a :class:`CorruptionError` naming
    the run: a run the journal called durable is never silently rebuilt."""
    try:
        mm = np.load(path, mmap_mode="r")
    except (ValueError, OSError, EOFError) as e:
        raise CorruptionError(artifact, detail=f"unreadable: {e}", path=path) from e
    got = crc32_array(mm)
    if got != expected_crc:
        raise CorruptionError(
            artifact,
            detail=f"crc 0x{got:08x} != journaled 0x{expected_crc:08x}",
            path=path)
    return mm
