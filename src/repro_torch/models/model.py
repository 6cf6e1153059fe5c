"""Model facade of the port (``repro.models.model``): one interface over the
architecture families.

    model = Model(get_arch("gemma3-1b"))           # parameters on ``meta``
    params = model.init(torch.Generator("cuda").manual_seed(0))   # the card
    logits = model.forward(params, tokens=batch)
    loss, aux = model.loss(params, {"tokens": t, "labels": l})
    logits, cache = model.prefill(params, tokens=t, max_seq=S)
    logits, cache = model.decode_step(params, cache, tok, pos)

``Model`` is an ``nn.Module`` whose parameters are registered under the
names of ``repro``'s parameter tree flattened with dots
(``blocks.attn.wq``, with its leading layer axis).  Until ``init`` or
``params_from_reference`` fills them they lie on the ``meta`` device, so
``Model(cfg)`` of any size allocates nothing.  ``params()`` is the module's
tree as nested dicts, and the compute methods take such a tree first, as
``repro``'s do.  Methods that allocate take a ``device``: the card by
default (``repro_torch.device.resolve_device``: it raises without CUDA
unless ``device="cpu"``).  Inputs given as numpy arrays go to the
parameters' device.  The registered parameters are frozen
(``requires_grad=False``): the train step (``repro_torch.train.step``)
takes the grads of ``loss`` at detached copies of a tree's leaves, so
``loss`` builds an autograd graph only when its parameter tree asks for
one, and no other method builds one.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer, xlstm
from repro_torch.models.params import (
    abstract_params,
    axes_tree,
    count_params,
    init_params,
    tree_map,
)
from repro_torch.models.transformer import dtype_of


class _Tree(nn.Module):
    """A dict node of the parameter tree: sub-dicts as child modules,
    tensors as (frozen) parameters."""

    def __init__(self, tree):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, _Tree(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    def tree(self):
        out = {name: p for name, p in self._parameters.items()}
        out.update((name, m.tree()) for name, m in self._modules.items())
        return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.is_xlstm = cfg.family == "ssm"
        if self.is_xlstm:
            self._defs = xlstm.strip_static(xlstm.model_defs(cfg))
        else:
            self._defs = transformer.model_defs(cfg)
        self._load(self.abstract())

    def _load(self, tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                setattr(self, name, _Tree(leaf))
            else:
                setattr(self, name, nn.Parameter(leaf, requires_grad=False))

    def params(self):
        """The module's parameters as ``repro``'s nested-dict tree."""
        out = {}
        for name in self._defs:
            leaf = getattr(self, name)
            out[name] = leaf.tree() if isinstance(leaf, _Tree) else leaf
        return out

    @staticmethod
    def _tensors(params, *xs):
        """Inputs given as numpy arrays, on the parameters' device."""
        dev = params["embed"].device
        return [x if x is None or isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev) for x in xs]

    # -- parameters ------------------------------------------------------
    def param_defs(self):
        """The ``ParamDef`` tree (shapes, logical axes, init kinds)."""
        return self._defs

    def init(self, generator: Optional[torch.Generator] = None, dtype: Optional[Any] = None,
             device=None):
        """Draw every parameter on ``device`` (the card by default) in
        ``dtype`` (the config's ``param_dtype``) from ``generator`` (seed 0
        when None), register them and return the tree."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        dtype = dtype or dtype_of(self.cfg.param_dtype)
        self._load(init_params(self._defs, generator, dtype, dev))
        return self.params()

    def abstract(self, dtype: Optional[Any] = None):
        """Meta-device tensors of every parameter (no allocation)."""
        return abstract_params(self._defs, dtype or dtype_of(self.cfg.param_dtype))

    def axes(self):
        return axes_tree(self._defs)

    def num_params(self) -> int:
        return count_params(self._defs)

    # -- compute ----------------------------------------------------------
    def forward(self, params, tokens=None, embeds=None):
        tokens, embeds = self._tensors(params, tokens, embeds)
        if self.is_xlstm:
            return xlstm.forward(self.cfg, params, tokens=tokens, embeds=embeds)
        return transformer.forward(self.cfg, params, tokens=tokens, embeds=embeds)

    def loss(self, params, batch, denom=None, token_ranks=None):
        """(loss, aux) of ``batch``; ``denom`` and ``token_ranks`` are a D-rank
        step's (``transformer.loss_fn``)."""
        batch = dict(zip(batch, self._tensors(params, *batch.values()), strict=True))
        if not self.is_xlstm:
            return transformer.loss_fn(self.cfg, params, batch, denom, token_ranks)
        logits = xlstm.forward(self.cfg, params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"))
        labels = batch["labels"]
        denom = np.prod(labels.shape) if denom is None else denom
        loss = torch.sum(transformer._nll(logits, labels)) / denom
        return loss, {"loss": loss}

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device=None):
        dev = device if device == "meta" else resolve_device(device)
        if self.is_xlstm:
            return xlstm.init_state(self.cfg, batch, dev)
        if self.cfg.window_decode_cache:
            return transformer.init_cache_windowed(self.cfg, batch, max_seq, device=dev)
        return transformer.init_cache(self.cfg, batch, max_seq, device=dev)

    def abstract_cache(self, batch: int, max_seq: int):
        """The cache's shapes and dtypes as meta-device tensors."""
        return self.init_cache(batch, max_seq, device="meta")

    def prefill(self, params, tokens=None, embeds=None, max_seq=None):
        tokens, embeds = self._tensors(params, tokens, embeds)
        if self.is_xlstm:
            return xlstm.forward(self.cfg, params, tokens=tokens, embeds=embeds,
                                 return_state=True)
        return transformer.prefill(self.cfg, params, tokens=tokens, embeds=embeds,
                                   max_seq=max_seq)

    def decode_step(self, params, cache, tokens, pos):
        """One token a row at ``pos``; the cache is updated in place and
        returned (see ``models/transformer.py``)."""
        tokens, pos = self._tensors(params, tokens, pos)
        if self.is_xlstm:
            return xlstm.decode_step(self.cfg, params, cache, tokens, pos)
        if self.cfg.window_decode_cache:
            return transformer.decode_step_windowed(self.cfg, params, cache, tokens, pos)
        return transformer.decode_step(self.cfg, params, cache, tokens, pos)


def _torch_array(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(np.shape(a))  # a 0-d array stays 0-d
    bf16 = a.dtype.name == "bfloat16"  # numpy has no bfloat16: carry the bits
    if bf16:
        a = a.view(np.uint16)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def params_from_reference(model: Model, tree, device=None):
    """Load ``repro``'s parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into ``model`` on ``device`` (the
    card by default), keeping each array's dtype; returns ``model.params()``.
    Raises ``ValueError`` when a name or a shape differs."""
    dev = resolve_device(device)
    want = model.abstract()
    got, names = set(_paths(tree)), set(_paths(want))
    if got != names:
        raise ValueError(f"parameter trees differ in {sorted(got ^ names)}")

    def load(a, w):
        t = _torch_array(a, dev)
        if tuple(t.shape) != tuple(w.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(w.shape)}")
        return t

    model._load(tree_map(load, tree, want, is_leaf=lambda x: not isinstance(x, dict)))
    return model.params()


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, (*prefix, k))
    else:
        yield ".".join(prefix)


def train_state_from_reference(model: Model, state, device=None):
    """Carry ``repro``'s ``TrainState`` (params and opt as numpy, e.g.
    ``jax.tree.map(np.asarray, state)``) into the port's on ``device`` (the
    card by default): the params load into ``model`` as
    ``params_from_reference`` loads them, and opt's ``step``, ``master``,
    ``m`` and ``v`` keep their dtypes.  Raises ``ValueError`` when a name or
    a shape differs."""
    from repro_torch.train.step import TrainState

    params, opt = state
    params = params_from_reference(model, params, device=device)
    dev = resolve_device(device)
    want = set(_paths(params))
    new_opt = {"step": _torch_array(opt["step"], dev)}
    if tuple(new_opt["step"].shape) != () or new_opt["step"].dtype != torch.int32:
        raise ValueError("opt['step'] must be an int32 scalar")
    for key in ("master", "m", "v"):
        if set(_paths(opt[key])) != want:
            raise ValueError(f"opt[{key!r}] differs from the parameter tree")

        def load(a, p):
            t = _torch_array(a, dev)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(t.shape)} != {tuple(p.shape)}")
            return t

        new_opt[key] = tree_map(load, opt[key], params,
                                is_leaf=lambda x: not isinstance(x, dict))
    return TrainState(params=params, opt=new_opt)
