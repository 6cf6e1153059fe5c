"""``cfg.remat`` in the port's train forward: each block under
``torch.utils.checkpoint`` (``nothing_saveable``), with a policy that keeps
the matmul outputs (``dots_saveable``), or plain (``none``).

The recomputed blocks give the same tensors, so on the CPU the loss and
every grad are bit-equal across the three modes (the dense, MoE, hybrid and
embeddings-input tiny archs, a loss mask, chunked cross entropy and chunked
attention, one and two microbatches).  ``repro``'s loss and grads under
``dots_saveable`` and ``none`` (one ``jax.jit``) hold the port's within the
train tests' tolerances.  Outside autograd (serving) no block is
checkpointed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as C
import _torch_train_cases as T
from _torch_lm_cases import one_torch_thread  # noqa: F401
from repro.config import get_arch as ref_arch
from repro.models.model import Model as RefModel
from repro_torch.config import ShardingPolicy, TrainConfig, get_arch
from repro_torch.models.model import Model
from repro_torch.models.params import tensor_leaves, tensor_map
from repro_torch.sharding.rules import make_mesh
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import TrainState, loss_and_grads, make_train_step

pytestmark = pytest.mark.usefixtures("one_torch_thread")
MODES = ("nothing_saveable", "dots_saveable", "none")
ARCHS = ("tiny-gemma3", "tiny-mixtral", "tiny-hymba", "tiny-internvl2")
VARIANTS = {"plain": {}, "chunked": dict(loss_chunk=8, attn_chunk=8)}


@functools.lru_cache(maxsize=None)
def _params(name):
    """The float32 config's params, drawn on the CPU from seed 0."""
    return Model(C.f32(get_arch(name))).init(torch.Generator().manual_seed(0), device="cpu")


def _grads(name, remat, variant="plain", mask=False):
    model = Model(dataclasses.replace(C.f32(get_arch(name)), remat=remat,
                                      **VARIANTS[variant]))
    batch, bmask = T.batches(model.cfg)
    loss, _, grads = loss_and_grads(model, _params(name), bmask if mask else batch)
    return loss, grads


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", ARCHS)
def test_grads_bit_equal_under_every_remat(name, variant):
    mask = variant == "chunked"
    base_loss, base = _grads(name, "none", variant, mask)
    for remat in MODES[:2]:
        loss, grads = _grads(name, remat, variant, mask)
        assert torch.equal(loss, base_loss), remat
        for g, b in zip(tensor_leaves(grads), tensor_leaves(base), strict=True):
            assert torch.equal(g, b), remat


def test_microbatched_step_bit_equal_under_every_remat():
    out = []
    params = _params("tiny-gemma3")
    state = TrainState(params, adamw_init(params))
    for remat in MODES:
        model = Model(dataclasses.replace(C.f32(get_arch("tiny-gemma3")), remat=remat))
        step = make_train_step(model, make_mesh((1, 1), ("data", "model")), ShardingPolicy(),
                               TrainConfig(**T.TRAIN, microbatches=2), 2, 16, donate=False)[0]
        new, met = step(state, T.batches(model.cfg)[1])
        out.append((met, tensor_leaves(new)))
    for met, leaves in out[1:]:
        assert all(torch.equal(met[k], out[0][0][k]) for k in met)
        assert all(torch.equal(a, b) for a, b in zip(leaves, out[0][1], strict=True))


def test_serving_checkpoints_nothing(monkeypatch):
    """Without autograd the blocks run plain: forward and prefill never
    enter ``torch.utils.checkpoint``."""
    from torch.utils import checkpoint as ckpt

    model, params = Model(C.f32(get_arch("tiny-gemma3"))), _params("tiny-gemma3")
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = T.batches(model.cfg)[0]["tokens"]
    model.forward(params, tokens=x)
    with torch.no_grad():
        model.prefill(params, tokens=x, max_seq=20)
    assert calls == []
    loss_and_grads(model, params, T.batches(model.cfg)[0])
    assert len(calls) == model.cfg.num_layers


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        _grads("tiny-gemma3", "everything")


def test_remat_modes_match_repro():
    """``repro``'s loss and grads under ``dots_saveable`` and ``none``, on
    the port's params and the train tests' masked batch."""
    params = jax.tree.map(jnp.asarray, tensor_map(lambda t: t.numpy(), _params("tiny-gemma3")))
    cfg = C.f32(ref_arch("tiny-gemma3"))
    batch = jax.tree.map(jnp.asarray, T.batches(cfg)[1])

    def run(p):
        return {m: jax.value_and_grad(RefModel(dataclasses.replace(cfg, remat=m)).loss,
                                      has_aux=True)(p, batch) for m in MODES[1:]}

    want = jax.tree.map(np.asarray, C.ref_jit(run)(params))
    for remat, ((loss, _), grads) in want.items():
        got_loss, got = _grads("tiny-gemma3", remat, mask=True)
        C.close(got_loss.numpy(), loss, T.LOSS_TOL)
        C.assert_trees_close(C.numpy_tree(got), C.numpy_tree(grads), T.GRAD_TOL)
