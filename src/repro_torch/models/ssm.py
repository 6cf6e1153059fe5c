"""Recurrent / state-space blocks of the port (``repro.models.ssm``): mLSTM
and sLSTM (xLSTM, arXiv:2405.04517) and the Mamba-style selective SSM head
of Hymba's parallel attention + SSM blocks (arXiv:2411.13676).

Decode carries O(1)-in-sequence state.  ``repro``'s ``lax.scan`` over time
is a Python loop over timesteps here.  The Mamba head keeps ``repro``'s
chunking (chunks of ``ssm.chunk_size``, one chunk when the length is not a
multiple of it); within a chunk ``repro`` evaluates the linear recurrence
with an associative scan, and the port runs it sequentially, which computes
the same recurrence.  The initial ``m`` of both LSTM cells is ``-1e9``, not
``-inf``, as in ``repro``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.models.params import ParamDef

M0 = -1e9


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)
# ---------------------------------------------------------------------------


def mlstm_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h = cfg.attention.num_heads
    return {
        "wq": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wk": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wv": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wi": ParamDef((d, h), ("embed", None), init="scaled"),
        "wf": ParamDef((d, h), ("embed", None), init="scaled"),
        "wo_gate": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wo": ParamDef((d, d), ("q_proj", "embed"), init="scaled"),
    }


def mlstm_init_state(batch: int, heads: int, hd: int, device):
    f32 = torch.float32
    return (torch.zeros((batch, heads, hd, hd), dtype=f32, device=device),
            torch.zeros((batch, heads, hd), dtype=f32, device=device),
            torch.full((batch, heads), M0, dtype=f32, device=device))


def _mlstm_step(carry, q, k, v, i_t, f_t):
    """carry: (C (B,H,hd,hd), n (B,H,hd), m (B,H)); one timestep."""
    c, n, m = carry
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    f_eff = torch.exp(logf + m - m_new)[..., None]
    i_eff = torch.exp(i_t - m_new)[..., None]
    c = f_eff[..., None] * c + (i_eff * k)[..., None] * v[..., None, :]
    n = f_eff * n + i_eff * k
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))[..., None]
    out = torch.einsum("bhde,bhd->bhe", c, q) / denom
    return (c, n, m_new), out


def mlstm_scan(p, x, cfg: ArchConfig, state=None):
    """x: (B, S, d) -> (out (B,S,d), state).  Exact sequential semantics."""
    b, s, d = x.shape
    h = cfg.attention.num_heads
    hd = d // h
    q = (torch.matmul(x, p["wq"]).reshape(b, s, h, hd) / (hd ** 0.5)).float()
    k = (torch.matmul(x, p["wk"]).reshape(b, s, h, hd) / (hd ** 0.5)).float()
    v = torch.matmul(x, p["wv"]).reshape(b, s, h, hd).float()
    i_g = torch.matmul(x, p["wi"]).float()
    f_g = torch.matmul(x, p["wf"]).float()
    if state is None:
        state = mlstm_init_state(b, h, hd, x.device)
    outs = []
    for t in range(s):
        state, o = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_g[:, t], f_g[:, t])
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(b, s, d).to(x.dtype)
    gate = torch.sigmoid(torch.matmul(x, p["wo_gate"]))
    return torch.matmul(out * gate, p["wo"]), state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, non-linear recurrence)
# ---------------------------------------------------------------------------


def slstm_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    return {
        "wz": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wi": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wf": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "wo_gate": ParamDef((d, d), ("embed", "q_proj"), init="scaled"),
        "rz": ParamDef((d, d), ("embed", "q_proj"), init="scaled", scale=0.0),
        "wo": ParamDef((d, d), ("q_proj", "embed"), init="scaled"),
    }


def slstm_init_state(batch: int, d: int, device):
    zeros = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (zeros, zeros.clone(), torch.full((batch, d), M0, dtype=torch.float32,
                                             device=device), zeros.clone())


def slstm_scan(p, x, cfg: ArchConfig, state=None):
    b, s, d = x.shape
    z_in = torch.matmul(x, p["wz"]).float()
    i_in = torch.matmul(x, p["wi"]).float()
    f_in = torch.matmul(x, p["wf"]).float()
    o_in = torch.matmul(x, p["wo_gate"]).float()
    rz = p["rz"].float()
    if state is None:
        state = slstm_init_state(b, d, x.device)
    c, n, m, hprev = state
    outs = []
    for t in range(s):
        z = torch.tanh(z_in[:, t] + hprev @ rz)
        logf = F.logsigmoid(f_in[:, t])
        m_new = torch.maximum(logf + m, i_in[:, t])
        f_eff = torch.exp(logf + m - m_new)
        i_eff = torch.exp(i_in[:, t] - m_new)
        c = f_eff * c + i_eff * z
        n = f_eff * n + i_eff
        hprev = torch.sigmoid(o_in[:, t]) * c / torch.clamp(n, min=1.0)
        m = m_new
        outs.append(hprev)
    out = torch.stack(outs, dim=1).to(x.dtype)
    return torch.matmul(out, p["wo"]), (c, n, m, hprev)


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (diagonal A)
# ---------------------------------------------------------------------------


def mamba_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    s = cfg.ssm
    inner = s.expand * d
    return {
        "w_in": ParamDef((d, 2 * inner), ("embed", "ssm_inner"), init="scaled"),
        "conv": ParamDef((s.conv_width, inner), ("conv", "ssm_inner"), init="scaled"),
        "w_dt": ParamDef((inner,), ("ssm_inner",), init="ones"),
        "w_bc": ParamDef((inner, 2 * s.state_dim), ("ssm_inner", None), init="scaled"),
        "a_log": ParamDef((inner, s.state_dim), ("ssm_inner", "ssm_state"), init="zeros"),
        "w_out": ParamDef((inner, d), ("ssm_inner", "embed"), init="scaled"),
    }


def _mamba_inner(p, xi, z, cfg: ArchConfig, conv_state, h0):
    """One chunk of the selective scan.  xi/z: (B, C, inner)."""
    b, c_len, inner = xi.shape
    s = cfg.ssm
    w = s.conv_width
    xpad = torch.cat([conv_state, xi], dim=1)
    xc = sum(xpad[:, i: i + c_len, :] * p["conv"][i][None, None, :] for i in range(w))
    xc = F.silu(xc)
    if w > 1:
        new_conv_state = xpad[:, -(w - 1):, :]
    else:
        new_conv_state = torch.zeros((b, 0, inner), dtype=xi.dtype, device=xi.device)

    dt = F.softplus(xc * p["w_dt"][None, None, :]).float()
    bc = torch.matmul(xc, p["w_bc"]).float()
    b_t, c_t = bc[..., : s.state_dim], bc[..., s.state_dim:]
    a = -torch.exp(p["a_log"].float())  # (inner, N) negative
    decay = torch.exp(dt[..., None] * a[None, None])  # (B, C, inner, N)
    drive = dt[..., None] * b_t[:, :, None, :] * xc.float()[..., None]
    hs = []
    h = h0
    for t in range(c_len):  # h_t = decay_t * h_{t-1} + drive_t
        h = decay[:, t] * h + drive[:, t]
        hs.append(h)
    hseq = torch.stack(hs, dim=1)  # (B, C, inner, N)
    y = torch.einsum("bsin,bsn->bsi", hseq, c_t).to(xi.dtype)
    return y * F.silu(z), new_conv_state, h


def mamba_scan(p, x, cfg: ArchConfig, state=None):
    """x: (B, S, d) -> (out, (conv_state, ssm_state)), chunk by chunk of
    ``cfg.ssm.chunk_size`` (one chunk for a ragged length)."""
    b, s_len, d = x.shape
    s = cfg.ssm
    inner = s.expand * d
    xz = torch.matmul(x, p["w_in"])
    xi, z = xz[..., :inner], xz[..., inner:]
    if state is not None:
        conv_state, h = state
    else:
        conv_state, h = mamba_init_state(cfg, b, x.dtype, x.device)

    c = min(s.chunk_size or s_len, s_len)
    if s_len % c != 0:
        c = s_len  # one chunk for ragged lengths
    ys = []
    for lo in range(0, s_len, c):
        y, conv_state, h = _mamba_inner(p, xi[:, lo: lo + c], z[:, lo: lo + c], cfg,
                                        conv_state, h)
        ys.append(y)
    return torch.matmul(torch.cat(ys, dim=1), p["w_out"]), (conv_state, h)


def mamba_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    conv = torch.zeros((batch, s.conv_width - 1, inner), dtype=dtype, device=device)
    h = torch.zeros((batch, inner, s.state_dim), dtype=torch.float32, device=device)
    return (conv, h)
