"""Train / prefill / decode step factories (``repro.train.step``'s
counterpart), with ``repro``'s signatures.

``repro`` jits each step with explicit shardings (GSPMD); the port's steps
are eager functions on one process, and the "shardings" they return are the
spec trees of ``repro_torch.sharding`` for the ``mesh`` given (a
``sharding.Mesh``), equal to ``repro``'s.  The train step runs the whole
batch on the params' device, so a mesh of more than one device is refused:
training over D ranks is not ported.

The train step detaches the params tree's leaves with
``requires_grad_(True)`` (the model's registered parameters stay frozen),
runs ``model.loss`` and takes ``torch.autograd.grad``; the AdamW update runs
under ``torch.no_grad()``.  The dtype flow is ``repro``'s: with one
microbatch the grads are in the param dtype; with ``microbatches > 1`` each
batch leaf (the mask included) is sliced along dim 0, as
``dynamic_slice_in_dim`` slices it, a float32 zero tree accumulates
``g / mb`` (the division in the param dtype, the sum in float32), and
``loss / mb`` goes into a float32 scalar.  ``donate=True`` writes the new
state into the old state's tensors once every grad is computed (``repro``
donates the buffers to XLA instead); the old state's tensors then hold the
new values.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.config import ShardingPolicy, TrainConfig
from repro_torch.models.params import tensor_leaves, tensor_map, tree_unflatten
from repro_torch.sharding.rules import (
    Mesh,
    P,
    batch_specs,
    cache_specs,
    keystr_map,
    param_specs,
)
from repro_torch.train import optimizer as opt_lib


class TrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]


def state_specs(model, mesh: Mesh, policy: ShardingPolicy) -> TrainState:
    ps = param_specs(model, mesh, policy)
    return TrainState(params=ps, opt={"step": P(), "master": ps, "m": ps, "v": ps})


def loss_and_grads(model, params, batch):
    """(loss, aux, grads) of ``model.loss`` at ``params``: grads of detached
    copies of the leaves (same storage), in each leaf's dtype; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    live = tensor_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tensor_leaves(live)
    with torch.enable_grad():
        loss, aux = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


def _slice(x, i: int, mb: int):
    n = x.shape[0] // mb
    return x[i * n: (i + 1) * n]


def make_train_step(model, mesh: Mesh, policy: ShardingPolicy, tcfg: TrainConfig,
                    global_batch: int, seq_len: int, donate: bool = True,
                    with_mask: bool = False):
    """Returns (step, state_specs, batch_specs); ``step(state, batch)`` ->
    (TrainState, {"loss", "lr", "grad_norm"}), batch leaves numpy arrays or
    tensors.

    with_mask: batches carry a per-token loss mask (the SA-dedup pipeline's
    keep-mask) — adds its spec so the trees match."""
    if mesh.size > 1:
        raise ValueError(f"the train step runs on one process; a mesh of {mesh.size} "
                         "devices needs training over D ranks, which is not ported")
    cfg = model.cfg
    sspecs = state_specs(model, mesh, policy)
    bspecs = batch_specs(cfg, mesh, policy, global_batch, kind="train")
    if with_mask:
        bspecs = dict(bspecs, mask=bspecs["labels"])

    def step(state: TrainState, batch):
        params = state.params
        mb = tcfg.microbatches
        if mb > 1:
            # gradient accumulation over the leading batch dim
            first = tensor_leaves(params)[0]
            loss = torch.zeros((), dtype=torch.float32, device=first.device)
            grads = tensor_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            acc = tensor_leaves(grads)
            for i in range(mb):
                sl = {k: _slice(v, i, mb) for k, v in batch.items()}
                l, _, g = loss_and_grads(model, params, sl)
                loss = loss + l / mb
                for a, gi in zip(acc, tensor_leaves(g), strict=True):
                    a.add_(gi / mb)
                del g
        else:
            loss, _, grads = loss_and_grads(model, params, batch)
        with torch.no_grad():
            new_params, opt, info = opt_lib.adamw_update(
                tcfg, params, grads, state.opt, inplace=donate)
        return TrainState(new_params, opt), {"loss": loss, **info}

    return step, sspecs, bspecs


def make_prefill_step(model, mesh: Mesh, policy: ShardingPolicy,
                      batch: int, seq_len: int, max_seq: Optional[int] = None):
    """Returns (step, param_specs, batch_specs); ``step(params, batch_in)``
    -> (logits, cache)."""
    cfg = model.cfg
    pspecs = param_specs(model, mesh, policy)
    bspecs = batch_specs(cfg, mesh, policy, batch, kind="prefill")

    def step(params, batch_in):
        with torch.no_grad():
            return model.prefill(params, tokens=batch_in.get("tokens"),
                                 embeds=batch_in.get("embeds"),
                                 max_seq=max_seq or seq_len)

    in_b = {k: v for k, v in bspecs.items() if k != "labels"}
    return step, pspecs, in_b


def make_decode_step(model, mesh: Mesh, policy: ShardingPolicy,
                     batch: int, max_seq: int, long_context: bool = False):
    """serve_step: one new token against a ``max_seq`` cache.  Returns
    (step, param_specs, cache_specs, (tokens_spec, pos_spec)); the cache's
    specs are path-aware, as ``repro``'s."""
    cfg = model.cfg
    pspecs = param_specs(model, mesh, policy)
    dspecs = batch_specs(cfg, mesh, policy, batch, kind="decode")
    cspec = cache_specs(cfg, mesh, policy, batch, long_context=long_context)
    cache_sh = keystr_map(cspec, model.abstract_cache(batch, max_seq))

    def step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos)

    return step, pspecs, cache_sh, (dspecs["tokens"], dspecs["pos"])
