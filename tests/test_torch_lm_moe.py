"""The port's LM path against ``repro`` on the MoE archs (tiny-mixtral:
SWA + 4 experts top-2; tiny-granite-moe: 5 experts top-3), and the MoE
layer against ``repro``'s and its dense oracle.  Cases and tolerances:
``tests/_torch_lm_cases.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as C
from _torch_lm_cases import one_torch_thread  # noqa: F401
from repro.config import get_arch as ref_arch
from repro.models import layers as ref_layers
from repro.models.params import init_params as ref_init
from repro_torch.config import get_arch
from repro_torch.models import layers

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("tiny-mixtral", "tiny-granite-moe")


@pytest.mark.parametrize("name,what", C.cases(ARCHS), ids=lambda v: str(v))
def test_port_matches_repro(name, what):
    C.check(name, what)


@pytest.mark.parametrize("name,cf", [("tiny-mixtral", 8.0), ("tiny-granite-moe", 8.0),
                                     ("tiny-granite-moe", 0.5)])
def test_moe_matches_repro_and_the_dense_oracle(name, cf):
    """Capacity-padded dispatch == repro's, and == the dense oracle when no
    pair overflows (cf 8); at cf 0.5 pairs are dropped as in repro."""
    cfg = get_arch(name)
    m = dataclasses.replace(cfg.moe, capacity_factor=cf)
    ref_p = C.ref_jit(lambda k: ref_init(ref_layers.moe_defs(ref_arch(name)), k, jnp.float32))(
        C.ref_key(3))
    p = C.torch_tree(ref_p)
    x = np.random.default_rng(4).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    got = layers.moe(p, torch.from_numpy(x), m).numpy()
    want, want_dense = C.ref_jit(lambda p, x: (ref_layers.moe(p, x, m),
                                             ref_layers.moe_ref_dense(p, x, m)))(
        ref_p, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    dense = layers.moe_ref_dense(p, torch.from_numpy(x), m).numpy()
    np.testing.assert_allclose(dense, np.asarray(want_dense), rtol=1e-4, atol=1e-4)
    if cf >= 8.0:
        np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - dense).max() > 1e-3  # overflow was dropped


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: jax.lax.top_k picks the lower index."""
    m = get_arch("tiny-granite-moe").moe
    d = get_arch("tiny-granite-moe").d_model
    p = {"router": torch.zeros(d, m.num_experts)}
    top_p, top_e, _ = layers._route(p, torch.ones(3, d), m)
    assert top_e.tolist() == [[0, 1, 2]] * 3
    _, want = jax.lax.top_k(jnp.full((3, m.num_experts), 0.2), m.top_k)
    assert np.asarray(want).tolist() == top_e.tolist()


