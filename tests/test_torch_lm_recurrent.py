"""The port's LM path against ``repro`` on the recurrent archs
(tiny-hymba: SWA + parallel Mamba heads; tiny-xlstm: m and s blocks), the
Mamba, mLSTM and sLSTM scans against ``repro``'s and their stepwise runs,
and the state the engine carries across the requests of a slot.  Cases and
tolerances: ``tests/_torch_lm_cases.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as C
from _torch_lm_cases import one_torch_thread  # noqa: F401
from repro.config import get_arch as ref_arch
from repro.models import ssm as ref_ssm
from repro.models.params import init_params as ref_init
from repro_torch.config import get_arch
from repro_torch.models import ssm

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("tiny-hymba", "tiny-xlstm")


@pytest.mark.parametrize("name,what", C.cases(ARCHS), ids=lambda v: str(v))
def test_port_matches_repro(name, what):
    C.check(name, what)


@pytest.mark.parametrize("length", [12, 128, 130])
def test_mamba_scan_matches_repro_and_its_stepwise_run(length):
    """One chunk (12), two chunks of 64 (128) and a ragged length that falls
    back to one chunk (130), each against repro's scan and against the
    port's token-by-token recurrence."""
    cfg = get_arch("tiny-hymba")
    ref_p = C.ref_jit(lambda k: ref_init(ref_ssm.mamba_defs(ref_arch("tiny-hymba")), k,
                                       jnp.float32))(C.ref_key(5))
    p = C.torch_tree(ref_p)
    x = (np.random.default_rng(6).normal(size=(2, length, cfg.d_model)) * 0.1).astype(np.float32)
    full, (conv, h) = ssm.mamba_scan(p, torch.from_numpy(x), cfg)
    want, (wconv, wh) = C.ref_jit(lambda p, x: ref_ssm.mamba_scan(p, x, ref_arch("tiny-hymba")))(
        ref_p, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(conv.numpy(), np.asarray(wconv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=1e-4, atol=1e-4)
    state = ssm.mamba_init_state(cfg, 2)
    outs = []
    for t in range(length):
        o, state = ssm.mamba_scan(p, torch.from_numpy(x[:, t:t + 1]), cfg, state=state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_lstm_scan_matches_repro_and_its_stepwise_run(kind):
    cfg = get_arch("tiny-xlstm")
    defs = getattr(ref_ssm, f"{kind}_defs")(ref_arch("tiny-xlstm"))
    ref_p = C.ref_jit(lambda k: ref_init(defs, k, jnp.float32))(C.ref_key(7))
    p = C.torch_tree(ref_p)
    x = (np.random.default_rng(8).normal(size=(2, 10, cfg.d_model)) * 0.1).astype(np.float32)
    scan = getattr(ssm, f"{kind}_scan")
    full, state = scan(p, torch.from_numpy(x), cfg)
    ref_scan = getattr(ref_ssm, f"{kind}_scan")
    want, wstate = C.ref_jit(lambda p, x: ref_scan(p, x, ref_arch("tiny-xlstm")))(
        ref_p, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for s, w in zip(state, wstate, strict=True):
        np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    state, outs = None, []
    for t in range(10):
        o, state = scan(p, torch.from_numpy(x[:, t:t + 1]), cfg, state=state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


def test_admitted_request_starts_from_the_slots_last_mamba_state_as_in_repro():
    """ServeEngine does not reset a slot's cache when it admits a request:
    the second request's Mamba state starts from the first's, in both
    packages (ROADMAP section 3)."""
    out = C.slot_state_runs("tiny-hymba")
    for label in ("after", "alone"):
        C.assert_trees_close(out["port", label], out["repro", label], C.DECODE_TOL)
    for pkg in ("repro", "port"):
        moved = out[pkg, "after"]["ssm"] - out[pkg, "alone"]["ssm"]
        assert np.abs(moved).max() > 1e-3
        # the first layer's K at position 0 is the second request's alone;
        # the next layer's already reads the carried Mamba state
        after, alone = out[pkg, "after"]["k"][:, 0, 0], out[pkg, "alone"]["k"][:, 0, 0]
        np.testing.assert_allclose(after[0], alone[0], rtol=1e-6, atol=1e-6)
        assert np.abs(after[1] - alone[1]).max() > 1e-3


def test_admitted_request_starts_from_the_slots_last_lstm_state_as_in_repro():
    """ServeEngine does not reset a slot's state when it admits a request:
    on xLSTM the second of two one-token requests through one slot starts
    from the first's state, in both packages (ROADMAP section 3)."""
    out = C.slot_state_runs("tiny-xlstm")
    for label in ("after", "alone"):
        C.assert_trees_close(out["port", label], out["repro", label], C.DECODE_TOL)
    for pkg in ("repro", "port"):
        moved = max(np.abs(out[pkg, "after"][k] - out[pkg, "alone"][k]).max()
                    for k in out[pkg, "after"])
        assert moved > 1e-3
