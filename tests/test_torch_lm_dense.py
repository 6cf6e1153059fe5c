"""The port's LM path against ``repro`` on the dense attention archs
(tiny-gemma3: 5:1 local:global with qk-norm; tiny-granite: MQA with GeLU;
tiny-minicpm: MHA), float32 and bfloat16, and the attention layers alone.
Cases and tolerances: ``tests/_torch_lm_cases.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_cases import cases, check, one_torch_thread, ref_jit, ref_key  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
from repro.config import get_arch as ref_arch
from repro.models import layers as ref_layers
from repro.models.params import init_params as ref_init
from repro_torch.config import get_arch
from repro_torch.models import layers

ARCHS = ("tiny-gemma3", "tiny-granite", "tiny-minicpm")


@pytest.mark.parametrize("name,what", cases(ARCHS), ids=lambda v: str(v))
def test_port_matches_repro(name, what):
    check(name, what)


def _attn_params(name, seed):
    p = ref_jit(lambda k: ref_init(ref_layers.attention_defs(ref_arch(name)), k,
                                   jnp.float32))(ref_key(seed))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("window", [24, 5])
@pytest.mark.parametrize("chunk", [0, 8])
def test_attention_train_matches_repro(window, chunk):
    """GQA (2 query heads on one KV head), qk-norm, RoPE, a sliding window
    and the chunked path, layer alone."""
    ref_p, p = _attn_params("tiny-gemma3", 3)
    a = get_arch("tiny-gemma3").attention
    x = np.random.default_rng(3).normal(size=(2, 24, 48)).astype(np.float32)
    want = ref_jit(lambda p, x: ref_layers.attention_train(
        p, x, ref_arch("tiny-gemma3").attention, jnp.int32(window), 1e-6, chunk=chunk))(
        ref_p, jnp.asarray(x))
    got = layers.attention_train(p, torch.from_numpy(x), a, window, 1e-6, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_attention_decode_matches_repro():
    """One token against a cache whose rows sit at other positions; a window
    of 3 masks all but the last entries."""
    ref_p, p = _attn_params("tiny-granite", 4)
    a = get_arch("tiny-granite").attention
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(3, 10, 1, 16)).astype(np.float32)
    cv = rng.normal(size=(3, 10, 1, 16)).astype(np.float32)
    pos = np.array([0, 4, 9], np.int32)
    want = ref_jit(lambda p, *a: ref_layers.attention_decode(
        p, a[0], ref_arch("tiny-granite").attention, *a[1:], jnp.int32(3), 1e-6))(
        ref_p, *map(jnp.asarray, (x, ck, cv, pos)))
    got = layers.attention_decode(p, torch.from_numpy(x), a, torch.from_numpy(ck),
                                  torch.from_numpy(cv), torch.from_numpy(pos), 3, 1e-6)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_rmsnorm_rope_and_gelu_match_repro():
    """``1 + scale`` in float32, half-split RoPE with float32 angles, and
    the tanh GeLU, in float32 and bfloat16 (bf16: one rounding apart)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) * 1000
    ref = ref_jit(lambda x, s, pos: (ref_layers.rmsnorm({"scale": s}, x, 1e-6),
                                     ref_layers.rope(x, pos, 1e6), jax.nn.gelu(x[0])))
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2e-2)):
        xt = torch.from_numpy(x).to(dt)
        want = [np.asarray(w, np.float32) for w in ref(jnp.asarray(x).astype(jdt),
                                                       jnp.asarray(scale), jnp.asarray(pos))]
        got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, xt, 1e-6).float().numpy()
        np.testing.assert_allclose(got, want[0], rtol=tol, atol=tol)
        got = layers.rope(xt, torch.from_numpy(pos), 1e6).float().numpy()
        np.testing.assert_allclose(got, want[1], rtol=tol, atol=tol * 10)
        p = {"w_up": torch.eye(16, dtype=dt), "w_down": torch.eye(16, dtype=dt)}
        got = layers.mlp(p, xt[0], "gelu").float().numpy()
        np.testing.assert_allclose(got, want[2], rtol=tol, atol=tol)


def test_embedding_scale_is_rounded_to_the_compute_dtype():
    assert layers.embed_scale(1152, torch.bfloat16, "cpu").item() == 34.0
    assert float(jnp.asarray(np.sqrt(1152), jnp.bfloat16)) == 34.0
