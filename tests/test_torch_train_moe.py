"""The port's train step against ``repro``'s on the MoE archs
(tiny-mixtral: SWA + 4 experts top-2; tiny-granite-moe: 5 experts top-3)
and the embeddings-mode ones (tiny-musicgen: GeLU; tiny-internvl2: GQA):
the loss, every grad leaf (through the dispatch's indexed writes to the
guard row and the combine's permuted write), and the state after one AdamW
step with one microbatch, two, and a loss mask; and the MoE layer's grads
with pairs dropped past capacity.  Cases and tolerances:
``tests/_torch_train_cases.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as C
import _torch_train_cases as T
from _torch_lm_cases import one_torch_thread  # noqa: F401
from repro.config import get_arch as ref_arch
from repro.models import layers as ref_layers
from repro.models.params import init_params as ref_init
from repro_torch.config import get_arch
from repro_torch.models import layers

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("tiny-mixtral", "tiny-granite-moe", "tiny-musicgen", "tiny-internvl2")


@pytest.mark.parametrize("name,what", T.cases(ARCHS), ids=lambda v: str(v))
def test_train_step_matches_repro(name, what):
    T.check(name, what)


@pytest.mark.parametrize("name,cf", [("tiny-mixtral", 0.5), ("tiny-granite-moe", 0.5),
                                     ("tiny-granite-moe", 8.0)])
def test_moe_grads_match_repro_with_overflow(name, cf):
    """Grads of sum(moe(x) * w) in every expert weight, the router and x, at
    a capacity factor that drops pairs (0.5) and one that drops none."""
    cfg = get_arch(name)
    m = dataclasses.replace(cfg.moe, capacity_factor=cf)
    ref_p = C.ref_jit(lambda k: ref_init(ref_layers.moe_defs(ref_arch(name)), k,
                                         jnp.float32))(C.ref_key(3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)

    def ref_loss(p, x):
        return jnp.sum(ref_layers.moe(p, x, m) * w)

    want = C.ref_jit(jax.grad(ref_loss, argnums=(0, 1)))(ref_p, jnp.asarray(x))
    p = {k: t.requires_grad_(True) for k, t in C.torch_tree(ref_p).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(layers.moe(p, xt, m) * torch.from_numpy(w))
    got = torch.autograd.grad(loss, [*p.values(), xt])
    for k, g in zip(p, got, strict=False):
        C.close(g.numpy(), np.asarray(want[0][k]), T.GRAD_TOL)
    C.close(got[-1].numpy(), np.asarray(want[1]), T.GRAD_TOL)
