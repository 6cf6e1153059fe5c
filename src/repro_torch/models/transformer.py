"""Decoder-only LM of the port (``repro.models.transformer``) covering the
assigned architecture families but xLSTM (``models/xlstm.py``).

One block (attention [+ parallel Mamba heads] + MLP/MoE) runs over the
stacked ``(L, ...)`` parameters, layer ``i`` reading ``p[i]`` of every
leaf, so ``repro``'s parameter tree carries across as a plain copy.  The
per-layer windows are data, as in ``repro``: ``window_schedule`` encodes
gemma3's 5:1 local:global pattern and Mixtral's SWA.  ``repro``'s
``lax.scan`` over layers is a Python loop here, so ``cfg.scan_layers`` (a
compile policy of jax that changes no value) is accepted and does nothing.
``cfg.remat`` is honoured in the train forward, as ``repro``'s
``jax.checkpoint`` of each block: under autograd each block runs inside
``torch.utils.checkpoint`` (``"nothing_saveable"``: only the block's input
is kept and the block is recomputed in the backward; ``"dots_saveable"``:
the matmul outputs are kept too, by a selective-checkpoint policy;
``"none"``: no checkpoint).  It changes what the backward keeps, not a
value: the recomputed block gives the same tensors.

Interfaces (functions of (cfg, params, inputs)):
  forward      : full-sequence causal logits
  prefill      : forward + a populated KV cache
  decode_step  : one token against the cache

The decode steps write the new token's K/V (and the hybrid's SSM state)
into the cache they are given and return it: ``repro`` returns a new
pytree with the same values, which would copy every layer's cache a step.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.models import layers, ssm
from repro_torch.models.params import ParamDef, stack_layer_defs, tensor_leaves, tree_map


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    defs: Dict[str, Any] = {
        "ln_attn": layers.rmsnorm_defs(d),
        "ln_mlp": layers.rmsnorm_defs(d),
    }
    if cfg.attention is not None:
        defs["attn"] = layers.attention_defs(cfg)
    if cfg.moe is not None:
        defs["moe"] = layers.moe_defs(cfg)
    elif cfg.d_ff > 0:
        defs["mlp"] = layers.mlp_defs(cfg)
    if cfg.ssm is not None and cfg.family == "hybrid":
        defs["mamba"] = ssm.mamba_defs(cfg)
    return defs


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    defs = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "blocks": stack_layer_defs(block_defs(cfg), cfg.num_layers),
        "ln_out": layers.rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), init="scaled"
        )
    return defs


def window_schedule(cfg: ArchConfig, seq_len: int) -> np.ndarray:
    """(L,) int32 per-layer attention window (== seq_len for global)."""
    if cfg.attention is None:
        return np.full((cfg.num_layers,), seq_len, np.int32)
    return np.array(
        [cfg.attention.window_for_layer(i, seq_len) for i in range(cfg.num_layers)],
        np.int32,
    )


def layer_params(params, i: int, cdt: torch.dtype):
    """Layer ``i`` of the stacked blocks, in the compute dtype."""
    return tree_map(lambda a: a[i].to(cdt), params["blocks"])


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ArchConfig, params, tokens=None, embeds=None):
    cdt = dtype_of(cfg.compute_dtype)
    if embeds is None:
        x = params["embed"][tokens].to(cdt)
        return x * layers.embed_scale(cfg.d_model, cdt, x.device)
    return embeds.to(cdt)


def unembed(cfg: ArchConfig, params, x):
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].to(cdt).t())
    return torch.matmul(x, params["unembed"].to(cdt))


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, p, x, token_ranks=None):
    h_in = layers.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    if "moe" in p:
        return x + layers.moe(p["moe"], h_in, cfg.moe, token_ranks)
    if "mlp" in p:
        return x + layers.mlp(p["mlp"], h_in, cfg.act)
    return x


def _block_train(cfg: ArchConfig, p, x, window: int, token_ranks=None):
    a_in = layers.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    delta = torch.zeros_like(x)
    if "attn" in p:
        delta = layers.attention_train(p["attn"], a_in, cfg.attention, window,
                                       cfg.norm_eps, chunk=cfg.attn_chunk)
    if "mamba" in p:  # hymba: parallel attention + SSM heads, fused mean
        m_out, _ = ssm.mamba_scan(p["mamba"], a_in, cfg)
        delta = (delta + m_out) * 0.5 if "attn" in p else m_out
    return _ffn(cfg, p, x + delta, token_ranks)


# the ops whose outputs ``dots_saveable`` keeps: what einsum and matmul
# dispatch to (jax's dot_general)
MATMUL_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                        torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _dots_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in MATMUL_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, block):
    """``block`` under ``cfg.remat`` (``repro``'s ``_remat``): checkpointed
    when autograd records it, plain otherwise (serving, prefill)."""
    if cfg.remat == "none":
        return block
    if cfg.remat not in ("nothing_saveable", "dots_saveable"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    from torch.utils import checkpoint as ckpt

    context = (functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_saveable)
               if cfg.remat == "dots_saveable" else ckpt.noop_context_fn)

    def run(p, x, *args):
        if not torch.is_grad_enabled() or not (
                x.requires_grad or any(t.requires_grad for t in tensor_leaves(p))):
            return block(p, x, *args)
        return ckpt.checkpoint(block, p, x, *args, use_reentrant=False, context_fn=context)

    return run


def forward_hidden(cfg: ArchConfig, params, tokens=None, embeds=None, token_ranks=None):
    """Forward up to the final norm (no logits) — used by chunked CE.
    ``token_ranks``: see ``layers.moe``."""
    x = embed_inputs(cfg, params, tokens, embeds)
    cdt = x.dtype
    windows = window_schedule(cfg, x.shape[1])
    block = _remat(cfg, lambda p, h, w: _block_train(cfg, p, h, w, token_ranks))
    for i in range(cfg.num_layers):
        x = block(layer_params(params, i, cdt), x, int(windows[i]))
    return layers.rmsnorm(params["ln_out"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params, tokens=None, embeds=None, token_ranks=None):
    """Causal full-sequence forward.  Returns logits (B, S, V)."""
    return unembed(cfg, params, forward_hidden(cfg, params, tokens, embeds, token_ranks))


def _nll(logits, labels):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return logz - gold


def loss_fn(cfg: ArchConfig, params, batch, denom=None,
            token_ranks=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy.  batch: {tokens|embeds, labels, mask?}.

    ``denom``: the loss's denominator when ``batch`` is a rank's part of a
    larger batch (that batch's token count, or its mask's sum clamped at
    1); by default this batch's own.  ``token_ranks``: see ``layers.moe``."""
    if cfg.loss_chunk:
        x = forward_hidden(cfg, params, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"), token_ranks=token_ranks)
        return chunked_ce(cfg, params, x, batch["labels"], batch.get("mask"), denom)
    logits = forward(cfg, params, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                     token_ranks=token_ranks)
    labels = batch["labels"]
    mask = batch.get("mask")
    nll = _nll(logits, labels)
    if mask is not None:
        nll = nll * mask
    if denom is None:
        denom = (torch.clamp(torch.sum(mask), min=1.0) if mask is not None
                 else np.prod(labels.shape))
    loss = torch.sum(nll) / denom
    return loss, {"loss": loss, "ntokens": denom}


def chunked_ce(cfg: ArchConfig, params, x_final, labels, mask=None, denom=None):
    """Sequence-chunked cross entropy: the (B, C, V) logits chunk is the
    largest live value; full (B, S, V) logits never exist.  ``denom`` as in
    ``loss_fn``."""
    b, s, _ = x_final.shape
    c = min(cfg.loss_chunk or s, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=x_final.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x_final.device)
    for lo in range(0, s, c):
        lc = labels[:, lo: lo + c]
        mc = (mask[:, lo: lo + c].float() if mask is not None
              else torch.ones(lc.shape, dtype=torch.float32, device=x_final.device))
        nll = _nll(unembed(cfg, params, x_final[:, lo: lo + c]), lc) * mc
        tot = tot + torch.sum(nll)
        cnt = cnt + torch.sum(mc)
    loss = tot / (torch.clamp(cnt, min=1.0) if denom is None else denom)
    return loss, {"loss": loss, "ntokens": cnt}


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------


def _hybrid(cfg: ArchConfig) -> bool:
    return cfg.ssm is not None and cfg.family == "hybrid"


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Stacked per-layer cache (all zeros); ``device="meta"`` allocates
    nothing (``Model.abstract_cache``)."""
    dtype = dtype or dtype_of(cfg.compute_dtype)
    cache: Dict[str, Any] = {}
    if cfg.attention is not None:
        a = cfg.attention
        shape = (cfg.num_layers, batch, max_seq, a.num_kv_heads, a.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if _hybrid(cfg):
        s = cfg.ssm
        inner = s.expand * cfg.d_model
        cache["conv"] = torch.zeros((cfg.num_layers, batch, s.conv_width - 1, inner),
                                    dtype=dtype, device=device)
        cache["ssm"] = torch.zeros((cfg.num_layers, batch, inner, s.state_dim),
                                   dtype=torch.float32, device=device)
    return cache


def _attend_one(cfg: ArchConfig, p, a_in, ck, cv, slot, pos, mask):
    """Write the token's K/V at ``slot`` of (B, T, KV, hd) caches first, so
    it attends to itself, then attend under ``mask`` (B, T)."""
    a = cfg.attention
    b = a_in.shape[0]
    q, k_new, v_new = layers._qkv(p["attn"], a_in, a, pos[:, None], cfg.norm_eps)
    rows = torch.arange(b, device=a_in.device)
    ck[rows, slot] = k_new[:, 0]
    cv[rows, slot] = v_new[:, 0]
    o = layers._sdpa(q, ck, cv, mask[:, None, :], a)
    return torch.matmul(o.reshape(b, 1, -1), p["attn"]["wo"])


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """One decode step.

    tokens: (B, 1) int; pos: (B,) positions being written.
    Returns (logits (B, 1, V), cache), the cache updated in place.
    """
    x = embed_inputs(cfg, params, tokens[:, 0])[:, None, :]
    cdt = x.dtype
    max_seq = cache["k"].shape[2] if "k" in cache else 0
    windows = window_schedule(cfg, max_seq or 1)
    for i in range(cfg.num_layers):
        p = layer_params(params, i, cdt)
        a_in = layers.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        delta = torch.zeros_like(x)
        if "k" in cache:
            j = torch.arange(max_seq, device=x.device)[None, :]
            mask = (j <= pos[:, None]) & (j > pos[:, None] - int(windows[i]))
            delta = _attend_one(cfg, p, a_in, cache["k"][i], cache["v"][i], pos, pos, mask)
        if "mamba" in p:
            m_out, (conv_s, ssm_s) = ssm.mamba_scan(
                p["mamba"], a_in, cfg, state=(cache["conv"][i], cache["ssm"][i]))
            cache["conv"][i] = conv_s
            cache["ssm"][i] = ssm_s
            delta = (delta + m_out) * 0.5 if "attn" in p else m_out
        x = _ffn(cfg, p, x + delta)
    x = layers.rmsnorm(params["ln_out"], x, cfg.norm_eps)
    return unembed(cfg, params, x), cache


def init_cache_windowed(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                        device=None):
    """Per-layer caches sized to each layer's attention window (ring buffers
    for local layers): {"layer_XX": {"k": (B, W_i, KV, hd), "v": ...}} (+ the
    hybrid's ssm/conv stacks)."""
    dtype = dtype or dtype_of(cfg.compute_dtype)
    cache: Dict[str, Any] = {}
    a = cfg.attention
    for i in range(cfg.num_layers):
        w = min(a.window_for_layer(i, max_seq), max_seq)
        shape = (batch, w, a.num_kv_heads, a.head_dim)
        cache[f"layer_{i:02d}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    if _hybrid(cfg):
        s = cfg.ssm
        inner = s.expand * cfg.d_model
        cache["ssm_conv"] = torch.zeros((cfg.num_layers, batch, s.conv_width - 1, inner),
                                        dtype=dtype, device=device)
        cache["ssm_state"] = torch.zeros((cfg.num_layers, batch, inner, s.state_dim),
                                         dtype=torch.float32, device=device)
    return cache


def decode_step_windowed(cfg: ArchConfig, params, cache, tokens, pos):
    """One decode step with window-sized ring caches (slot = pos mod W;
    entries hold the last W positions), updated in place.  Exactly
    equivalent to decode_step for window >= pos+1."""
    x = embed_inputs(cfg, params, tokens[:, 0])[:, None, :]
    cdt = x.dtype
    for i in range(cfg.num_layers):
        p = layer_params(params, i, cdt)
        cl = cache[f"layer_{i:02d}"]
        w = cl["k"].shape[1]
        a_in = layers.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        slot = pos % w
        # global position of ring slot s: pos - ((slot - s) mod W)
        s_idx = torch.arange(w, device=x.device)[None, :]
        gpos = pos[:, None] - ((slot[:, None] - s_idx) % w)
        mask = (gpos >= 0) & (gpos <= pos[:, None]) & (gpos > pos[:, None] - w)
        delta = _attend_one(cfg, p, a_in, cl["k"], cl["v"], slot, pos, mask)
        if "mamba" in p:
            m_out, (conv_s, ssm_s) = ssm.mamba_scan(
                p["mamba"], a_in, cfg,
                state=(cache["ssm_conv"][i], cache["ssm_state"][i]))
            cache["ssm_conv"][i] = conv_s
            cache["ssm_state"][i] = ssm_s
            delta = (delta + m_out) * 0.5
        x = _ffn(cfg, p, x + delta)
    x = layers.rmsnorm(params["ln_out"], x, cfg.norm_eps)
    return unembed(cfg, params, x), cache


def prefill(cfg: ArchConfig, params, tokens=None, embeds=None,
            max_seq: Optional[int] = None):
    """Full-sequence forward that also fills a cache of ``max_seq``
    positions (zeros past the prompt).  Returns (logits, cache)."""
    x = embed_inputs(cfg, params, tokens, embeds)
    cdt = x.dtype
    b, s, _ = x.shape
    windows = window_schedule(cfg, s)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = {}
    if cfg.attention is not None:
        a = cfg.attention
        shape = (cfg.num_layers, b, max_seq or s, a.num_kv_heads, a.head_dim)
        cache["k"] = torch.zeros(shape, dtype=cdt, device=x.device)
        cache["v"] = torch.zeros(shape, dtype=cdt, device=x.device)
    conv, state = [], []
    for i in range(cfg.num_layers):
        p = layer_params(params, i, cdt)
        a_in = layers.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        delta = torch.zeros_like(x)
        if "attn" in p:
            a = cfg.attention
            q, k, v = layers._qkv(p["attn"], a_in, a, positions, cfg.norm_eps)
            w = int(windows[i])
            if cfg.attn_chunk and s > cfg.attn_chunk:
                o = layers._flash_sdpa(q, k, v, w, a, cfg.attn_chunk)
            else:
                o = layers._sdpa(q, k, v, layers.causal_mask(s, w, x.device)[None], a)
            delta = torch.matmul(o.reshape(b, s, -1), p["attn"]["wo"])
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        if "mamba" in p:
            m_out, (conv_s, ssm_s) = ssm.mamba_scan(p["mamba"], a_in, cfg)
            conv.append(conv_s)
            state.append(ssm_s)
            delta = (delta + m_out) * 0.5 if "attn" in p else m_out
        x = _ffn(cfg, p, x + delta)
    if conv:
        cache["conv"], cache["ssm"] = torch.stack(conv), torch.stack(state)
    x = layers.rmsnorm(params["ln_out"], x, cfg.norm_eps)
    return unembed(cfg, params, x), cache
