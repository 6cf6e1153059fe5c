"""Shared cases of the train-step tests: ``repro``'s loss, grads and AdamW
steps for a tiny arch, computed in one ``jax.jit`` per arch and process, and
the port's on the same state and batch.

The state: ``repro``'s ``Model.init`` weights (float32 configs), the master
a float32 copy, and first and second moments drawn from a numpy seed
(``m`` ~ 0.01·N(0, 1), ``v`` ~ 1e-4·U(0, 1) + 1e-5) at step 3.  Nonzero
moments keep the update a smooth function of the grads: from zero moments
AdamW's first update is ``lr · sign(g)``, and a grad within round-off of
zero could flip its sign in one package and not the other.  The batch is
``_torch_lm_cases.inputs``' (2 x 16, the mask included).

``repro``'s steps come from its own ``make_train_step`` on a (1, 1) mesh
(``donate=False``), called inside the arch's one jit: one microbatch, two
microbatches, and the mask; its grads from ``jax.value_and_grad`` of
``Model.loss``.

Tolerances (float32 on the CPU), each the rtol and, scaled by the tensor's
largest magnitude where that exceeds 1, the atol (``_torch_lm_cases.close``):
the loss 2e-4 (the LM tests'); grads and ``grad_norm`` 1e-3: the tiny
configs' activations reach the hundreds, so float32 round-off in the
backward pass scales with the terms summed, and XLA and PyTorch sum in
other orders (the largest measured: 3.6e-4 of tiny-minicpm's embedding
grad, 5.8e-4 of tiny-musicgen's grad norm); every leaf of the state after a
step 2e-4 (largest measured 5.1e-5); ``lr`` and the step counter exactly.
The bfloat16 case (tiny-gemma3 with bfloat16 params and compute, a float32
master): the loss within 0.02 (measured 0.0018), each grad leaf within a
relative RMS error of 0.1, the forward logits' bound (measured up to 0.070:
XLA on the CPU fuses chains of bfloat16 ops in float32 where PyTorch
rounds after each), each leaf's update of the float32 master within a
relative RMS error of 0.05 of ``repro``'s (measured up to 0.0056), and the
bfloat16 params exactly the new master rounded.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_lm_cases as C
from repro.config import ShardingPolicy as RefPolicy
from repro.config import TrainConfig as RefTrainConfig
from repro.config import get_arch as ref_arch
from repro.models.model import Model as RefModel
from repro.train.step import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_train_step
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch
from repro_torch.models.model import Model, train_state_from_reference
from repro_torch.models.params import tensor_leaves
from repro_torch.sharding.rules import make_mesh
from repro_torch.train.step import loss_and_grads, make_train_step

LOSS_TOL, GRAD_TOL, STATE_TOL = 2e-4, 1e-3, 2e-4
BF16_LOSS, BF16_GRAD_RMS, BF16_UPDATE_RMS = 0.02, 0.1, 0.05
BF16_ARCH = "tiny-gemma3"
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=20)
CHECKS = ("loss", "grads", "step", "microbatches", "mask")


def cases(archs):
    return [(n, c) for n in archs for c in CHECKS + (("bf16",) if n == BF16_ARCH else ())]


def moments(model, seed=1):
    """(m, v) trees of numpy float32 over ``model.abstract()``'s shapes."""
    rng = np.random.default_rng(seed)
    ab = model.abstract()
    m = jax.tree.map(lambda a: (0.01 * rng.normal(size=a.shape)).astype(np.float32), ab)
    v = jax.tree.map(lambda a: (1e-4 * rng.random(size=a.shape) + 1e-5).astype(np.float32),
                     ab)
    return m, v


def batches(cfg):
    x = C.inputs(cfg)
    batch = {**C.model_inputs(cfg, x), "labels": x["labels"]}
    return batch, {**batch, "mask": x["mask"]}


def _state(p, m, v, dtype=None):
    live = p if dtype is None else jax.tree.map(lambda a: a.astype(dtype), p)
    return RefTrainState(live, {"step": jnp.int32(3), "master": p, "m": m, "v": v})


@functools.lru_cache(maxsize=None)
def reference(name):
    """``repro``'s numpy outputs for ``name``: the initial state, the loss
    and grads, and (state, metrics) after each of its three steps (and, for
    ``BF16_ARCH``, the bfloat16 loss, grads and step)."""
    cfg = C.f32(ref_arch(name))
    model = RefModel(cfg)
    batch, bmask = (jax.tree.map(jnp.asarray, b) for b in batches(cfg))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    tcfg = RefTrainConfig(**TRAIN)

    def make(tc, mask=False, mdl=model):
        return ref_train_step(mdl, mesh, RefPolicy(), tc, 2, 16, donate=False,
                              with_mask=mask)[0]

    steps = {"step": (make(tcfg), batch),
             "microbatches": (make(dataclasses.replace(tcfg, microbatches=2)), batch),
             "mask": (make(tcfg, mask=True), bmask)}
    bf16 = name == BF16_ARCH
    if bf16:
        bmodel = RefModel(ref_arch(name))
        bstep = make(tcfg, mdl=bmodel)
    m, v = moments(model)

    def run(key, m, v):
        p = model.init(key)
        st = _state(p, m, v)
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(p, batch)
        out = {"params": p, "loss": loss, "grads": grads}
        for k, (fn, b) in steps.items():
            out[k] = fn(st, b)
        if bf16:
            pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
            (bl, _), bg = jax.value_and_grad(bmodel.loss, has_aux=True)(pb, batch)
            out["bf16"] = (bl, bg, bstep(_state(p, m, v, jnp.bfloat16), batch))
        return out

    out = C.ref_jit(run)(C.ref_key(0), m, v)
    return jax.tree.map(np.asarray, out), (m, v)


def port_state(name, dtype=None):
    """The port's model and ``TrainState`` carried from ``repro``'s."""
    out, (m, v) = reference(name)
    p = out["params"]
    base = get_arch(name)
    cfg = base if dtype == "bfloat16" else C.f32(base)
    model = Model(cfg)
    live = p if dtype is None else jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    state = train_state_from_reference(
        model, (live, {"step": np.int32(3), "master": p, "m": m, "v": v}), device="cpu")
    return model, state


def port_step(name, what):
    """The port's (state, metrics) of check ``what`` (a step variant)."""
    model, state = port_state(name)
    tcfg = TrainConfig(**TRAIN)
    if what == "microbatches":
        tcfg = dataclasses.replace(tcfg, microbatches=2)
    batch, bmask = batches(model.cfg)
    step = make_train_step(model, make_mesh((1, 1), ("data", "model")), ShardingPolicy(),
                           tcfg, 2, 16, donate=False, with_mask=what == "mask")[0]
    return step(state, bmask if what == "mask" else batch)


def _rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / max(np.mean(want ** 2), 1e-30)))


def check(name, what):
    """Hold the port's ``what`` for ``name`` to ``repro``'s."""
    ref, _ = reference(name)
    if what in ("loss", "grads"):
        model, state = port_state(name)
        loss, _, grads = loss_and_grads(model, state.params, batches(model.cfg)[0])
        C.close(loss.numpy(), ref["loss"], LOSS_TOL)
        if what == "grads":
            C.assert_trees_close(C.numpy_tree(grads), C.numpy_tree(ref["grads"]), GRAD_TOL)
        return
    if what == "bf16":
        model, state = port_state(name, "bfloat16")
        old = C.numpy_tree(state.opt["master"])
        bl, bg, (bstate, _) = ref["bf16"]
        loss, _, grads = loss_and_grads(model, state.params, batches(model.cfg)[0])
        assert abs(float(loss) - float(bl)) <= BF16_LOSS
        got, want = C.numpy_tree(grads), C.numpy_tree(bg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert _rms(got[k], want[k]) <= BF16_GRAD_RMS, k
        new, _ = make_train_step(model, make_mesh((1, 1), ("data", "model")),
                                 ShardingPolicy(), TrainConfig(**TRAIN), 2, 16,
                                 donate=False)[0](state, batches(model.cfg)[0])
        got, want = C.numpy_tree(new.opt["master"]), C.numpy_tree(bstate.opt["master"])
        for k in want:
            assert _rms(got[k] - old[k], want[k] - old[k]) <= BF16_UPDATE_RMS, k
        for p, ma in zip(tensor_leaves(new.params), tensor_leaves(new.opt["master"]),
                         strict=True):
            assert p.dtype == torch.bfloat16 and torch.equal(p, ma.to(torch.bfloat16))
        return
    new, met = port_step(name, what)
    rstate, rmet = ref[what]
    C.close(met["loss"].numpy(), rmet["loss"], LOSS_TOL)
    np.testing.assert_array_equal(met["lr"].numpy(), rmet["lr"])
    C.close(met["grad_norm"].numpy(), rmet["grad_norm"], GRAD_TOL)
    assert int(new.opt["step"]) == int(rstate.opt["step"]) == 4
    assert new.opt["step"].dtype == torch.int32
    C.assert_trees_close(C.numpy_tree(new), C.numpy_tree(rstate), STATE_TOL)
