"""Collective-byte accounting from compiled (post-SPMD) HLO text
(``repro.analysis.hlo``'s copy).  The port has no HLO: its dry-run derives
the same dict, one entry a collective kind and ``total``, from the spec
trees (``repro_torch.launch.dryrun.spec_collective_bytes``); this parser
stays for HLO text written by ``repro``.

``compiled.cost_analysis()`` has no collective category, so we parse the
partitioned module: every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute definition line carries its OUTPUT shape;
per-op *operand* bytes follow from the output shape and the replica-group
size (all-gather operand = out/G, reduce-scatter operand = out*G, others 1:1).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.-]+\s*=\s*(.*?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum operand bytes per collective kind (per-device program)."""
    out: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        if "-start(" in line or "-done(" in line:
            # async pairs: count the start only
            if "-done(" in line:
                continue
        m = _DEF_RE.match(line)
        if not m:
            continue
        shape_text, kind = m.group(1), m.group(2)
        nbytes = _shape_bytes(shape_text)
        g = _group_size(line)
        if kind == "all-gather":
            nbytes = nbytes // max(g, 1)
        elif kind == "reduce-scatter":
            nbytes = nbytes * max(g, 1)
        out[kind] += nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)
