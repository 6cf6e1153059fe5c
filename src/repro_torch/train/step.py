"""Train / prefill / decode step factories (``repro.train.step``'s
counterpart), with ``repro``'s signatures.

``repro`` jits each step with explicit shardings (GSPMD); the port's steps
are eager functions, and the "shardings" they return are the spec trees of
``repro_torch.sharding`` for the ``mesh`` given (a ``sharding.Mesh``),
equal to ``repro``'s.

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

On a mesh of D devices (``(D, 1)`` over ``("data", "model")``, as
``repro``'s launcher makes it) the step runs on the D ranks of the
initialized ``torch.distributed`` world, one a device, and computes what
``repro``'s GSPMD step computes on the global batch; a mesh of one device
is this process alone (``distributed.SINGLE``), where every collective
below is the identity:

* the state is FSDP-sharded by the spec trees (``sharding.placement``):
  each rank holds its slice of every leaf whose spec names ``"data"`` (the
  params, master, m and v alike) and the whole of every other leaf;
* every rank is given the whole global batch; a microbatch's rows are
  spread over the ranks in equal contiguous blocks when they divide by D,
  and otherwise every rank computes the whole microbatch (``repro``'s
  ``batch_specs`` replicates an indivisible batch);
* the forward all-gathers the cut params in the compute dtype; the loss
  of a rank's rows is their NLL sum over the denominator of the whole
  microbatch (its token count, or its mask's sum), so the sum over the
  ranks is the global loss; the MoE dispatch runs over the whole
  microbatch's tokens (``layers.moe``'s ``token_ranks``);
* each cut leaf's grad is reduce-scattered (summed) and each whole leaf's
  all-reduced; a microbatch every rank computed whole is not summed, each
  rank takes its slice;
* the global norm is the psum of each rank's squares over its slices plus
  the whole leaves' squares counted once (at one rank ``global_norm``'s
  sum, in its order), and each rank runs AdamW on its slices.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import ShardingPolicy, TrainConfig
from repro_torch.core import distributed
from repro_torch.models.params import tensor_leaves, tensor_map, tree_unflatten
from repro_torch.models.transformer import dtype_of
from repro_torch.sharding.placement import placement
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


def loss_and_grads(model, params, batch, denom=None, token_ranks=None):
    """(loss, aux, grads) of ``model.loss`` at ``params``: grads of detached
    copies of the leaves (same storage), in each leaf's dtype; a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives.  ``denom`` and
    ``token_ranks`` go to ``model.loss`` (a D-rank step's)."""
    live = tensor_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tensor_leaves(live)
    with torch.enable_grad():
        loss, aux = model.loss(live, batch, denom=denom, token_ranks=token_ranks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


def make_train_step(model, mesh: Mesh, policy: ShardingPolicy, tcfg: TrainConfig,
                    global_batch: int, seq_len: int, donate: bool = True,
                    with_mask: bool = False):
    """Returns (step, state_specs, batch_specs); ``step(state, batch)`` ->
    (TrainState, {"loss", "lr", "grad_norm"}), batch leaves numpy arrays or
    tensors.  On a mesh of D > 1 devices ``step`` runs on the D ranks of the
    initialized world (see the module docstring): the state is each rank's
    slices (``sharding.placement(state_specs, mesh, ranks).shard`` of a
    whole state), the batch the whole global batch, and the metrics the
    global ones on every rank.

    with_mask: batches carry a per-token loss mask (the SA-dedup pipeline's
    keep-mask) — adds its spec so the trees match."""
    cfg = model.cfg
    sspecs = state_specs(model, mesh, policy)
    bspecs = batch_specs(cfg, mesh, policy, global_batch, kind="train")
    if with_mask:
        bspecs = dict(bspecs, mask=bspecs["labels"])
    ranks = distributed.world() if mesh.size > 1 else distributed.SINGLE
    return _step(model, tcfg, placement(sspecs, mesh, ranks), donate), sspecs, bspecs


def _rows(n: int, ranks) -> Optional[slice]:
    """This rank's block of a microbatch of ``n`` rows, or None when the
    rows do not divide over the ranks (every rank computes all of them)."""
    if n % ranks.size:
        return None
    k = n // ranks.size
    return slice(ranks.rank * k, (ranks.rank + 1) * k)


def _denominator(batch):
    """The loss's denominator of a whole (micro)batch: its mask's sum
    clamped at 1 (float32), or its token count (``transformer.loss_fn``)."""
    mask = batch.get("mask")
    if mask is None:
        return int(np.prod(batch["labels"].shape))
    return torch.clamp(torch.sum(mask.float()), min=1.0)


def _step(model, tcfg: TrainConfig, place, donate: bool):
    """The train step (the module docstring); ``place`` is the state's
    placement."""
    ranks = place.ranks
    cdt = dtype_of(model.cfg.compute_dtype)

    def step(state: TrainState, batch):
        params = state.params
        pleaves = tensor_leaves(params)
        dims = place.dims[:len(pleaves)]  # the params lead the state's leaves
        dev = pleaves[0].device
        batch = {k: torch.as_tensor(np.asarray(v)).to(dev) if not isinstance(v, torch.Tensor)
                 else v.to(dev) for k, v in batch.items()}
        # the forward's params: the cut leaves all-gathered in the compute dtype
        whole = tree_unflatten(params, [
            p if dim is None else distributed.gather_along(p.to(cdt), dim, ranks)
            for p, dim in zip(pleaves, dims, strict=True)])
        mb = tcfg.microbatches
        n = next(iter(batch.values())).shape[0] // mb
        rows = _rows(n, ranks)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = None
        for i in range(mb):
            part = {k: v[i * n: (i + 1) * n] for k, v in batch.items()}
            # at one rank the rows are the microbatch: the loss's own denominator
            denom = _denominator(part) if ranks.size > 1 else None
            if rows is not None:
                part = {k: v[rows] for k, v in part.items()}
            l, _, g = loss_and_grads(model, whole, part, denom=denom,
                                     token_ranks=ranks if rows is not None else None)
            g = [gi.to(p.dtype) for gi, p in zip(tensor_leaves(g), pleaves, strict=True)]
            if mb == 1:
                loss, acc = l, g
                break
            # gradient accumulation: g / mb in the param dtype, summed in float32
            loss = loss + l / mb
            if acc is None:
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in g]
            for a, gi in zip(acc, g, strict=True):
                a.add_(gi / mb)
            del g
        del whole
        if rows is not None:  # each rank's part of the sums
            loss = distributed.psum(loss.float(), ranks)
            grads = [distributed.scatter_along(a, dim, ranks) if dim is not None
                     else distributed.psum(a, ranks) for a, dim in zip(acc, dims, strict=True)]
        else:  # every rank computed the whole batch: its slices as they are
            grads = [place.take(a, i) for i, a in enumerate(acc)]
        del acc
        squares = [torch.sum(g.to(torch.float32) ** 2) for g in grads]
        sq = sum(s for s, dim in zip(squares, dims, strict=True) if dim is None)
        if any(dim is not None for dim in dims):
            sq = sq + distributed.psum(
                sum(s for s, dim in zip(squares, dims, strict=True) if dim is not None), ranks)
        gn = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32, device=dev))
        with torch.no_grad():
            new_params, opt, info = opt_lib.adamw_update(
                tcfg, params, tree_unflatten(params, grads), state.opt, inplace=donate,
                grad_norm=gn)
        return TrainState(new_params, opt), {"loss": loss, **info}

    return step


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
