"""Two-point correction over depth (``repro.analysis.corrected``'s copy).

In the port the dry-run counts every layer of its eager loop, so
``run_cell_corrected`` needs no correction for the layer stack; it uses
``two_point`` where a recurrent arch's time loop makes a cell's full-depth
count too slow (``repro_torch.launch.dryrun``).  ``repro``'s reason for it,
kept as written:

Scan-once correction for XLA cost analysis.

``HloCostAnalysis`` visits a while/scan body ONCE, so scan-over-layers
programs underreport FLOPs/bytes/collectives by ~the layer count (verified
empirically: gemma3-27b prefill HLO flops == logits + ~one layer; unrolled
lowering matches 6ND·(remat,attention) as expected).

Correction: lower the same (shape, mesh) cell with num_layers=1 and
num_layers=2 **unrolled** (cheap — seconds), then

    corrected(L) = cost(1) + (L - 1) * (cost(2) - cost(1))

which is exact for homogeneous stacks (all scanned stacks here are
structurally homogeneous; the local/global window pattern changes masks, not
shapes).  The non-layer parts (embedding, logits, loss, optimizer on
non-layer params) live in cost(1).

xLSTM scans over *time* as well, so the same trick cannot recover its
per-token costs; xlstm rows use the analytic FLOPs model below (linear ops
are exactly countable) and carry the raw-bytes caveat.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


def two_point(cost1: Dict[str, float], cost2: Dict[str, float], l: int):
    out = {}
    keys = set(cost1) | set(cost2)
    for k in keys:
        a, b = float(cost1.get(k, 0.0)), float(cost2.get(k, 0.0))
        # fusion differences can make cost(2) < cost(1) on tiny programs;
        # clamp the per-layer slope at 0 so extrapolation never goes negative
        per_layer = max(b - a, 0.0)
        out[k] = max(a + (l - 1) * per_layer, a, b)
    return out


def reduced_arch(cfg, num_layers: int):
    """cfg with ``num_layers`` unrolled layers (same family/shapes)."""
    return dataclasses.replace(cfg, num_layers=num_layers, scan_layers=False)


def xlstm_analytic_flops(cfg, shape) -> float:
    """Exact matmul+state FLOPs for the xLSTM stack (fwd; train x3)."""
    d = cfg.d_model
    h = cfg.attention.num_heads
    hd = d // h
    kinds = []
    pat = cfg.ssm.block_pattern
    for i in range(cfg.num_layers):
        kinds.append(pat[i % len(pat)])
    per_tok = 0.0
    for k in kinds:
        if k == "m":
            per_tok += 2 * 5 * d * d + 2 * 2 * d * h  # projections
            per_tok += 8 * h * hd * hd  # C update + readout
        else:
            per_tok += 2 * 6 * d * d + 2 * d * d  # projections + recurrent
            per_tok += 10 * d
    per_tok += 2 * d * cfg.vocab_size  # logits
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        tokens = shape.global_batch
    flops = per_tok * tokens
    if shape.kind == "train":
        flops *= 3.0
    return flops
