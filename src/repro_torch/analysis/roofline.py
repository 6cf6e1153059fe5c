"""Roofline terms of a dry-run cell (``repro.analysis.roofline``'s copy,
with NVIDIA H100 SXM targets in place of its TPU v5e ones).

    compute term    = per-device FLOPs / peak_FLOP/s
    memory term     = per-device bytes / HBM_bw
    collective term = per-device collective bytes / link_bw

The dry-run (``repro_torch.launch.dryrun``) records each device's share of
the work, so the three terms come directly from the per-device numbers,
and ``chips`` multiplies them back for the cluster's totals.  MODEL_FLOPS =
6·N(_active)·D tokens (dense/MoE).  The keys keep ``repro``'s names
(``hlo_flops``, ``hlo_bytes``); in the port they are counted on the
``meta`` device, not read from an HLO module.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Dict, Optional

# NVIDIA H100 SXM (NVIDIA's H100 data sheet; dense, at the 700 W limit)
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s / GPU, without sparsity
HBM_BW = 3.35e12  # HBM3 bytes/s / GPU
# NVLink 4: 900 GB/s a GPU counts both directions; a collective's bytes
# leave a GPU at the one-direction rate, 450 GB/s
LINK_BW = 450e9  # bytes/s / GPU, one direction


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device (partitioned program) numbers
    hlo_flops: float
    hlo_bytes: float
    collective: Dict[str, int]
    model_flops_total: float
    # terms in seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0
    peak_memory_bytes: float = 0.0

    def finish(self) -> "Roofline":
        self.t_compute = self.hlo_flops / PEAK_FLOPS
        self.t_memory = self.hlo_bytes / HBM_BW
        self.t_collective = self.collective.get("total", 0) / LINK_BW
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        self.bottleneck = max(terms, key=terms.get)
        total_hlo = self.hlo_flops * self.chips
        self.useful_flops_ratio = (
            self.model_flops_total / total_hlo if total_hlo else 0.0
        )
        return self

    def roofline_fraction(self) -> float:
        """useful-FLOPs-time / dominant-term time (1.0 = at the roofline)."""
        t_useful = self.model_flops_total / (self.chips * PEAK_FLOPS)
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_dom if t_dom else 0.0

    def to_dict(self) -> dict:
        return asdict(self)


def _attention_ctx_tokens(cfg, seq_len: int) -> float:
    """Sum over layers of the average causal context per query token."""
    if cfg.attention is None:
        return 0.0
    a = cfg.attention
    total = 0.0
    for i in range(cfg.num_layers):
        w = a.window_for_layer(i, seq_len)
        if w >= seq_len:
            total += seq_len / 2.0
        else:
            total += w * (1.0 - w / (2.0 * seq_len))
    return total


def model_flops(cfg, shape) -> float:
    """Useful FLOPs: 6·N(_active)·D matmuls (2·N·D fwd-only for prefill)
    plus the attention context term 4·ctx·H·hd per query token (x3 for
    training's backward)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind in ("train", "prefill"):
        attn = 0.0
        if cfg.attention is not None:
            a = cfg.attention
            ctx = _attention_ctx_tokens(cfg, shape.seq_len)
            attn = 4.0 * tokens * ctx * a.num_heads * a.head_dim
        if shape.kind == "train":
            return 6.0 * n * tokens + 3.0 * attn
        return 2.0 * n * tokens + attn
    # decode: one token per sequence, attention over the (window-aware) cache
    tokens = shape.global_batch
    flops = 2.0 * n * tokens
    if cfg.attention is not None:
        a = cfg.attention
        eff = sum(
            a.window_for_layer(i, shape.seq_len) for i in range(cfg.num_layers)
        )
        flops += 4.0 * tokens * eff * a.num_heads * a.head_dim
    return flops


def summarize(records) -> str:
    """Markdown table of roofline rows."""
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "bottleneck | 6ND/HLO | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in records:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute:.3e} | "
            f"{r.t_memory:.3e} | {r.t_collective:.3e} | {r.bottleneck} | "
            f"{r.useful_flops_ratio:.2f} | {r.roofline_fraction():.3f} |"
        )
    return hdr + "\n".join(rows)
