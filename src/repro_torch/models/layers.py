"""Transformer layer computations of the port (``repro.models.layers``):
RMSNorm, RoPE, GQA/MQA attention with sliding windows, (Sw)iGLU MLP and the
sort-based, capacity-padded MoE.

Plain functions ``fn(params_subtree, inputs, cfg, ...)`` on tensors, with
the same parameter definitions (``*_defs``) as ``repro``.  The large
products are ``torch.einsum``/``matmul``: ``repro`` computes them outside
any Pallas kernel.  Where the obvious torch idiom would give another number,
``repro``'s arithmetic is kept: RMSNorm scales by ``1 + scale`` in float32;
RoPE is half-split with float32 angles; GQA query head ``h`` reads KV head
``h // G`` (the ``(B, S, KV, G, hd)`` reshape); masked scores are
``finfo(float32).min``, so a fully masked row is uniform rather than NaN;
GeLU is the tanh approximation (``jax.nn.gelu``'s default); the MoE's top-k
breaks ties toward the lower expert index (``jax.lax.top_k``) through a
stable sort, and its combine sums each token's ``top_k`` contributions in a
fixed order instead of scatter-adding them (no atomics, so a run on the card
is deterministic).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig, AttentionConfig, MoEConfig
from repro_torch.models.params import ParamDef

NEG = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(d: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), (None,), init="ones")}


def rmsnorm(p, x, eps: float):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + p["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Half-split, not interleaved."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    a = cfg.attention
    d = cfg.d_model
    q, kv = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    defs = {
        "wq": ParamDef((d, q), ("embed", "q_proj"), init="scaled"),
        "wk": ParamDef((d, kv), ("embed", "kv_proj"), init="scaled"),
        "wv": ParamDef((d, kv), ("embed", "kv_proj"), init="scaled"),
        "wo": ParamDef((q, d), ("q_proj", "embed"), init="scaled"),
    }
    if a.qk_norm:
        defs["q_norm"] = ParamDef((a.head_dim,), (None,), init="ones")
        defs["k_norm"] = ParamDef((a.head_dim,), (None,), init="ones")
    return defs


def _qkv(p, x, a: AttentionConfig, positions, eps: float):
    b, s, _ = x.shape
    q = torch.matmul(x, p["wq"]).reshape(b, s, a.num_heads, a.head_dim)
    k = torch.matmul(x, p["wk"]).reshape(b, s, a.num_kv_heads, a.head_dim)
    v = torch.matmul(x, p["wv"]).reshape(b, s, a.num_kv_heads, a.head_dim)
    if "q_norm" in p:
        q = _headnorm(q, p["q_norm"], eps)
        k = _headnorm(k, p["k_norm"], eps)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)
    return q, k, v


def _headnorm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def _softcap(scores, cap: float):
    return torch.tanh(scores / cap) * cap if cap > 0 else scores


def _sdpa(q, k, v, mask, a: AttentionConfig):
    """q: (B,S,H,hd)  k,v: (B,T,KV,hd)  mask: (B|1, S, T) bool."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = q.reshape(b, s, kvh, group, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = _softcap(scores / np.sqrt(hd), a.logit_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: key j visible from query i (causal, within ``window``)."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (j > i - window)


def attention_train(p, x, a: AttentionConfig, window: int, eps: float, chunk: int = 0):
    """Full-sequence causal attention with a per-layer sliding window
    (``window == S`` on global layers); ``chunk > 0`` takes the online-softmax
    path (no S x S scores)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(p, x, a, positions, eps)
    if chunk and s > chunk:
        out = _flash_sdpa(q, k, v, window, a, chunk)
    else:
        out = _sdpa(q, k, v, causal_mask(s, window, x.device)[None], a)
    return torch.matmul(out.reshape(b, s, -1), p["wo"])


def _flash_sdpa(q, k, v, window: int, a: AttentionConfig, chunk: int):
    """Online-softmax attention over KV blocks (exact; causal + window).

    Never materializes (S, S) scores: the peak intermediate is
    (B, KV, G, C, C) a block pair.  ``repro``'s ``lax.map``/``lax.scan`` over
    blocks become two Python loops.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of attn_chunk {chunk}")
    nq = s // chunk
    qg = q.reshape(b, nq, chunk, kvh, g, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(b, nq, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nq, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / np.sqrt(hd)
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for i in range(nq):
        qi = qg[i]  # (B, KV, G, C, hd)
        m = torch.full((b, kvh, g, chunk), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, chunk, hd), dtype=torch.float32, device=q.device)
        rows = i * chunk + ar
        for j in range(nq):
            cols = j * chunk + ar
            sc = torch.einsum("bkgch,bkth->bkgct", qi, kb[j]).float() * scale
            sc = _softcap(sc, a.logit_softcap)
            mask = (cols[None, :] <= rows[:, None]) & (cols[None, :] > rows[:, None] - window)
            sc = torch.where(mask[None, None, None], sc, NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pr = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            acc = acc * corr[..., None] + torch.einsum("bkgct,bkth->bkgch", pr, vb[j].float())
            l = l * corr + pr.sum(dim=-1)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)  # (nq, B, KV, G, C, hd) -> (B, S, H, hd)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, hd)


def attention_decode(p, x, a: AttentionConfig, cache_k, cache_v, pos, window: int,
                     eps: float):
    """One-token decode against a KV cache.

    x: (B, 1, d);  cache_k/v: (B, T, KV, hd);  pos: (B,) current positions.
    Returns (out, new_k_entry, new_v_entry); the caller owns the cache.
    """
    b = x.shape[0]
    t = cache_k.shape[1]
    q, k_new, v_new = _qkv(p, x, a, pos[:, None], eps)
    j = torch.arange(t, device=x.device)[None, :]
    mask = (j <= pos[:, None]) & (j > pos[:, None] - window)  # (B, T)
    out = _sdpa(q, cache_k, cache_v, mask[:, None, :], a)
    return torch.matmul(out.reshape(b, 1, -1), p["wo"]), k_new, v_new


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": ParamDef((d, f), ("embed", "mlp"), init="scaled"),
        "w_down": ParamDef((f, d), ("mlp", "embed"), init="scaled"),
    }
    if cfg.act == "silu":
        defs["w_gate"] = ParamDef((d, f), ("embed", "mlp"), init="scaled")
    return defs


def mlp(p, x, act: str):
    up = torch.matmul(x, p["w_up"])
    if act == "silu":
        h = F.silu(torch.matmul(x, p["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# MoE: sort-based capacity-padded dispatch (index-routed)
# ---------------------------------------------------------------------------


def moe_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ffn_dim, m.num_experts
    return {
        "router": ParamDef((d, e), ("embed", "experts"), init="scaled"),
        "w_gate": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"), init="scaled"),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"), init="scaled"),
        "w_down": ParamDef((e, f, d), ("experts", "expert_mlp", "embed"), init="scaled"),
    }


def _route(p, xt, m: MoEConfig):
    """(top_p (T, k) renormalized, top_e (T, k), probs (T, E)); top-k by a
    stable descending sort, so ties go to the lower expert index."""
    logits = torch.matmul(xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, : m.top_k], top_e[:, : m.top_k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_e, probs


def expert_counts(expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """How many pairs each expert got: ``torch.bincount(expert,
    minlength=num_experts)`` for experts below ``num_experts``, as a
    scatter-add, which has a kernel on the ``meta`` device too (the
    dry-run's)."""
    ones = torch.ones_like(expert, dtype=torch.int64)
    return torch.zeros(num_experts, dtype=torch.int64, device=expert.device).scatter_add_(
        0, expert.long(), ones)


def moe(p, x, m: MoEConfig, token_ranks=None):
    """x: (B, S, d) -> (B, S, d).

    1. top-k routing -> (T*k) (expert, token) pairs;
    2. a capacity-padded slot a pair (stable argsort by expert + the count
       before it); capacity = ceil(T*k/E * cf), computed on the host;
    3. tokens gathered into (E, C, d), batched expert products, each pair's
       output weighted by its gate; pairs past capacity are dropped.

    ``token_ranks`` (a ``core.distributed.Ranks``): the ranks a batch's
    rows are spread over, this rank's rows being the ``rank``-th equal block.
    The dispatch then runs over every rank's tokens in rank order, the
    global batch's (its capacity from the global T, as ``repro``'s one
    dispatch under GSPMD), and the rank keeps its own rows' outputs; the
    gather's backward sums the grads of a rank's rows over the ranks.
    """
    if token_ranks is not None and token_ranks.size > 1:
        from repro_torch.core.distributed import gather_rows

        b = x.shape[0]
        out = moe(p, gather_rows(x, token_ranks), m)
        return out[token_ranks.rank * b: (token_ranks.rank + 1) * b]
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_e, _ = _route(p, xt, m)
    e_count = m.num_experts
    n = t * m.top_k
    cap = int(np.ceil(t * m.top_k / e_count * m.capacity_factor))
    expert = top_e.reshape(n)
    tok = torch.arange(t, device=x.device).repeat_interleave(m.top_k)
    gate = top_p.reshape(n).to(x.dtype)

    order = torch.argsort(expert, stable=True)
    e_sorted = expert[order]
    hist = expert_counts(expert, e_count)
    start = torch.cumsum(hist, 0) - hist
    slot_in_e = torch.arange(n, device=x.device) - start[e_sorted]
    ok = slot_in_e < cap
    flat_slot = torch.where(ok, e_sorted * cap + slot_in_e, e_count * cap)

    # gather tokens into expert buffers (overflow goes to a guard row)
    buf = torch.zeros((e_count * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_slot] = xt[tok[order]]
    h = buf[: e_count * cap].reshape(e_count, cap, d)

    gateh = torch.einsum("ecd,edf->ecf", h, p["w_gate"])
    up = torch.einsum("ecd,edf->ecf", h, p["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", F.silu(gateh) * up, p["w_down"])

    flat = torch.cat([out_e.reshape(e_count * cap, d),
                      torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    back = flat[flat_slot]  # (n, d) in sorted order
    contrib = back * (gate[order] * ok)[:, None]
    # each token's top_k contributions, back in pair order, summed
    pairs = torch.empty_like(contrib)
    pairs[order] = contrib
    return pairs.reshape(t, m.top_k, d).sum(dim=1).reshape(b, s, d)


def moe_ref_dense(p, x, m: MoEConfig):
    """Oracle: dense all-experts compute with the top-k mask."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    top_p, top_e, probs = _route(p, xt, m)
    w = torch.zeros_like(probs).scatter_(1, top_e, top_p)
    gate = torch.einsum("td,edf->tef", xt, p["w_gate"])
    up = torch.einsum("td,edf->tef", xt, p["w_up"])
    out_e = torch.einsum("tef,efd->ted", F.silu(gate) * up, p["w_down"])
    out = torch.einsum("ted,te->td", out_e, w.to(x.dtype))
    return out.reshape(b, s, d)


def embed_scale(d_model: int, dtype: torch.dtype, device) -> torch.Tensor:
    """sqrt(d_model) rounded to the compute dtype first, as ``repro`` does
    (``jnp.asarray(np.sqrt(d), cdt)``: 33.94 is 34.0 in bfloat16)."""
    return torch.tensor(math.sqrt(d_model), dtype=dtype, device=device)
