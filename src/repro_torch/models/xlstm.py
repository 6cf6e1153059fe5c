"""xLSTM stack of the port (``repro.models.xlstm``): sLSTM + mLSTM blocks
(arXiv:2405.04517).

Per-layer parameters differ between block kinds, so the stack unrolls, as
in ``repro``.  Decode state is O(1) in sequence length.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.config import ArchConfig
from repro_torch.models import layers, ssm
from repro_torch.models.params import ParamDef, tree_map
from repro_torch.models.transformer import embed_inputs


def layer_kinds(cfg: ArchConfig):
    pat = cfg.ssm.block_pattern if cfg.ssm else "m"
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    blocks = {}
    for i, kind in enumerate(layer_kinds(cfg)):
        inner = ssm.mlstm_defs(cfg) if kind == "m" else ssm.slstm_defs(cfg)
        blocks[f"layer_{i:02d}"] = {
            "kind": kind,  # static metadata, stripped before init
            "ln": layers.rmsnorm_defs(cfg.d_model),
            "cell": inner,
        }
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "blocks": blocks,
        "ln_out": layers.rmsnorm_defs(cfg.d_model),
    }


def strip_static(defs):
    """Remove the 'kind' metadata strings before init/abstract."""

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items() if k != "kind"}
        return x

    return walk(defs)


def forward(cfg: ArchConfig, params, tokens=None, embeds=None, state=None,
            return_state: bool = False):
    x = embed_inputs(cfg, params, tokens, embeds)
    cdt = x.dtype
    new_state = {}
    for i, kind in enumerate(layer_kinds(cfg)):
        name = f"layer_{i:02d}"
        p = tree_map(lambda a: a.to(cdt), params["blocks"][name])
        h = layers.rmsnorm(p["ln"], x, cfg.norm_eps)
        st = state[name] if state is not None else None
        scan = ssm.mlstm_scan if kind == "m" else ssm.slstm_scan
        out, new_state[name] = scan(p["cell"], h, cfg, st)
        x = x + out
    x = layers.rmsnorm(params["ln_out"], x, cfg.norm_eps)
    logits = x @ params["embed"].to(cdt).t()
    if return_state:
        return logits, new_state
    return logits


def init_state(cfg: ArchConfig, batch: int, device=None):
    h = cfg.attention.num_heads
    hd = cfg.d_model // h
    return {f"layer_{i:02d}": (ssm.mlstm_init_state(batch, h, hd, device) if kind == "m"
                               else ssm.slstm_init_state(batch, cfg.d_model, device))
            for i, kind in enumerate(layer_kinds(cfg))}


def decode_step(cfg: ArchConfig, params, state, tokens, pos):
    """One-token decode: the forward with S = 1 and the carried state."""
    del pos  # recurrent: position-free
    return forward(cfg, params, tokens=tokens, state=state, return_state=True)
