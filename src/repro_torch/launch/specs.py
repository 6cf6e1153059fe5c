"""input_specs(): ``meta``-device stand-ins for every model input
(``repro.launch.specs``'s counterpart: ``jax.ShapeDtypeStruct`` there).

Shapes and dtypes, no allocation.  Modality frontends ([audio]/[vlm]) are
stubs: their specs are precomputed frame/patch embeddings (B, S, d_model).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ArchConfig, ShapeConfig
from repro_torch.models.transformer import dtype_of
from repro_torch.train.optimizer import adamw_abstract
from repro_torch.train.step import TrainState


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs for one (arch x shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.input_mode == "embeddings":
            return {
                "embeds": sds((b, s, cfg.d_model), dtype_of(cfg.compute_dtype)),
                "labels": sds((b, s), torch.int32),
            }
        return {
            "tokens": sds((b, s), torch.int32),
            "labels": sds((b, s), torch.int32),
        }
    if shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            return {"embeds": sds((b, s, cfg.d_model), dtype_of(cfg.compute_dtype))}
        return {"tokens": sds((b, s), torch.int32)}
    # decode: one new token + positions; the KV cache spec comes from
    # Model.abstract_cache (seq_len-deep).
    return {
        "tokens": sds((b, 1), torch.int32),
        "pos": sds((b,), torch.int32),
    }


def train_state_specs(model) -> TrainState:
    params = model.abstract()
    return TrainState(params=params, opt=adamw_abstract(params))


def long_context_supported(cfg: ArchConfig) -> bool:
    """long_500k needs sub-quadratic attention (a window or a recurrence)."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    a = cfg.attention
    if a is not None and a.sliding_window is not None:
        return True  # SWA / 5:1 local:global
    return False
