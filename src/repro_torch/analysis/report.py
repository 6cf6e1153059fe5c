"""Generate the §Dry-run/§Roofline/§Perf tables from the dry-run JSON
artifacts (``repro.analysis.report``'s copy; a port record's memory is its
``peak_memory_bytes``, where ``repro``'s is XLA's ``memory_analysis``).

    PYTHONPATH=src python -m repro_torch.analysis.report
"""
from __future__ import annotations

import json
import os
import re


def _fmt(x, nd=3):
    if x is None:
        return "—"
    if isinstance(x, float):
        if x == 0:
            return "0"
        if abs(x) < 1e-2 or abs(x) >= 1e4:
            return f"{x:.2e}"
        return f"{x:.{nd}f}"
    return str(x)


def _mem_gb(r) -> str:
    if r.get("peak_memory_bytes") is not None:
        return f"{r['peak_memory_bytes'] / 1e9:.1f}"
    txt = r.get("memory_analysis") or r.get("memory_analysis_L2") or ""
    m = re.search(r"temp_size_in_bytes=(\d+)", txt)
    a = re.search(r"argument_size_in_bytes=(\d+)", txt)
    if not m:
        return "—"
    gb = (int(m.group(1)) + (int(a.group(1)) if a else 0)) / 1e9
    return f"{gb:.1f}"


def dryrun_table(path="dryrun_results.json") -> str:
    with open(path) as f:
        rs = json.load(f)
    out = [
        "| arch | shape | mesh | status | per-dev GFLOPs | per-dev GB "
        "accessed | collective MB | peak GB |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r['status']}: {r.get('reason', r.get('error', ''))[:60]} "
                f"| — | — | — | — |"
            )
            continue
        coll = r.get("collective", {}).get("total", 0) / 1e6
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{_fmt(r['hlo_flops'] / 1e9)} | {_fmt(r['hlo_bytes'] / 1e9)} | "
            f"{_fmt(coll)} | {_mem_gb(r)} |"
        )
    return "\n".join(out)


def roofline_table(path="corrected_results.json") -> str:
    with open(path) as f:
        rs = [r for r in json.load(f) if r["status"] == "ok"]
    out = [
        "| arch | shape | compute s | memory s | collective s | bottleneck | "
        "6ND/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rs, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt(r['t_compute'])} | "
            f"{_fmt(r['t_memory'])} | {_fmt(r['t_collective'])} | "
            f"{r['bottleneck']} | {_fmt(r['useful_flops_ratio'], 2)} | "
            f"{_fmt(r['roofline_fraction'], 4)} |"
        )
    return "\n".join(out)


def perf_table(path="perf_experiments.json") -> str:
    if not os.path.exists(path):
        return "(pending)"
    with open(path) as f:
        rs = json.load(f)
    out = [
        "| experiment | compute s | memory s | collective s | bottleneck | "
        "roofline frac |",
        "|---|---|---|---|---|---|",
    ]
    for r in rs:
        if r["status"] != "ok":
            out.append(f"| {r['exp']} | error: {r.get('error', '')[:70]} | | | | |")
            continue
        out.append(
            f"| {r['exp']} | {_fmt(r['t_compute'])} | {_fmt(r['t_memory'])} | "
            f"{_fmt(r['t_collective'])} | {r['bottleneck']} | "
            f"{_fmt(r['roofline_fraction'], 4)} |"
        )
    return "\n".join(out)


def main():
    print("## §Dry-run (raw, per-device partitioned program)\n")
    print(dryrun_table())
    print("\n## §Roofline (scan-once corrected, single pod)\n")
    print(roofline_table())
    print("\n## §Perf experiments\n")
    print(perf_table())


if __name__ == "__main__":
    main()
