"""AdamW with cosine / WSD (warmup-stable-decay, MiniCPM) schedules
(``repro.train.optimizer``'s counterpart).

State layout (MaxText-style memory discipline):
  * live params: ``param_dtype`` (bf16) — what the forward pass reads
  * master:      fp32 copy (updates accumulate without bf16 round-trip loss)
  * m, v:        fp32 first/second moments

All state mirrors the parameter tree, so one spec tree describes everything.
The arithmetic is ``repro``'s, op for op, in float32 tensors: the schedule
is computed on a float32 step tensor (not in Python floats), the bias
corrections are ``beta ** step`` in float32, the global norm sums the
leaves' float32 squares in ``jax.tree`` leaf order (sorted dict keys), and
the new live params take the dtype of the first leaf.  ``torch.optim.AdamW``
is not used: its update (``param.mul_(1 - lr * wd)``, then ``addcdiv``
with ``sqrt(v) / sqrt(bc2) + eps``) rounds differently.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.params import tensor_leaves as _leaves
from repro_torch.models.params import tensor_map as _map
from repro_torch.models.params import tree_unflatten


def lr_schedule(tcfg: TrainConfig, step) -> torch.Tensor:
    """cosine | wsd | constant, with linear warmup; a float32 scalar tensor
    on ``step``'s device (the CPU for a Python number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    base = tcfg.learning_rate
    if tcfg.schedule == "constant":
        return base * warm
    if tcfg.schedule == "wsd":
        # warmup -> stable plateau -> 1-sqrt decay (MiniCPM, arXiv:2404.06395)
        decay_start = tcfg.warmup_steps + tcfg.stable_steps
        frac = torch.clamp((step - decay_start) / max(tcfg.decay_steps, 1), 0.0, 1.0)
        decay = 1.0 - (1.0 - tcfg.min_lr_ratio) * torch.sqrt(frac)
        return base * warm * decay
    # cosine
    frac = torch.clamp((step - tcfg.warmup_steps) / max(tcfg.decay_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return base * warm * (tcfg.min_lr_ratio + (1 - tcfg.min_lr_ratio) * cos)


def adamw_init(params) -> Dict[str, Any]:
    """Step 0, a float32 master copy and zero moments, on the params'
    devices (the master never shares storage with a float32 param)."""
    first = _leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "master": _map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                  params),
        "v": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                  params),
    }


def adamw_abstract(params) -> Dict[str, Any]:
    """The state tree as ``meta`` tensors (shapes and dtypes, no memory)."""
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
    return {
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "master": _map(meta, params),
        "m": _map(meta, params),
        "v": _map(meta, params),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in _leaves(tree)))


def adamw_update(tcfg: TrainConfig, params, grads, opt, inplace: bool = False,
                 grad_norm=None):
    """One AdamW step with global-norm clipping.  Returns (params, opt,
    {"lr", "grad_norm"}).  ``inplace`` writes the results into ``params``'
    and ``opt``'s tensors (leaf by leaf, so a leaf's temporaries are the
    only extra memory) and returns those trees; the params must then share
    one dtype, which the new params keep.  ``grad_norm``: the global norm,
    where the trees are a rank's slices of the whole (a D-rank step);
    ``global_norm(grads)`` by default."""
    step = opt["step"] + 1
    lr = lr_schedule(tcfg, step)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.tensor(tcfg.grad_clip, dtype=torch.float32, device=gn.device)
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    bc1 = 1 - tcfg.beta1 ** step.to(torch.float32)
    bc2 = 1 - tcfg.beta2 ** step.to(torch.float32)

    def upd(g, m, v, master):
        g = g.to(torch.float32) * scale
        m = tcfg.beta1 * m + (1 - tcfg.beta1) * g
        v = tcfg.beta2 * v + (1 - tcfg.beta2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + tcfg.eps) + tcfg.weight_decay * master
        return m, v, master - lr * delta

    pdt = _leaves(params)[0].dtype
    if inplace and any(p.dtype != pdt for p in _leaves(params)):
        raise ValueError("an in-place update keeps each param's dtype: every leaf "
                         f"must be {pdt}, the first leaf's")
    flat = zip(_leaves(grads), _leaves(opt["m"]), _leaves(opt["v"]),
               _leaves(opt["master"]), _leaves(params), strict=True)
    new_m, new_v, new_ma, new_p = [], [], [], []
    for g, m, v, ma, p in flat:
        m2, v2, ma2 = upd(g, m, v, ma)
        p2 = ma2.to(pdt, copy=True)  # the live params never share the master's storage
        if inplace:
            for dst, src in ((m, m2), (v, v2), (ma, ma2), (p, p2)):
                dst.copy_(src)
            m2, v2, ma2, p2 = m, v, ma, p
        new_m.append(m2)
        new_v.append(v2)
        new_ma.append(ma2)
        new_p.append(p2)
    if inplace:
        opt["step"].copy_(step)
        return params, opt, {"lr": lr, "grad_norm": gn}

    new_opt = {"step": step, "master": tree_unflatten(grads, new_ma),
               "m": tree_unflatten(grads, new_m), "v": tree_unflatten(grads, new_v)}
    return tree_unflatten(grads, new_p), new_opt, {"lr": lr, "grad_norm": gn}
