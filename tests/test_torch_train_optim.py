"""The port's optimizer, compression and runtime against ``repro``'s on the
CPU: ``lr_schedule``'s three schedules step by step, ``adamw_update`` and
``global_norm`` on random trees (clipping on and off, a bfloat16 first
leaf), ``quantize_int8`` and top-k with ties, the compressed all-reduces on
4 gloo ranks, ``StepMonitor`` on an injected clock, ``retry_step`` and the
fault taxonomy, ``replan_mesh``'s factorizations.

Tolerances: the schedule exactly, but 2 float32 ulps (rtol 2.4e-7) for the
cosine, whose ``cos`` is XLA's in ``repro`` and libm's here; an AdamW step
in float32 within rtol 1e-6 (the norm's sum runs in another order), the
step counter and ``lr`` exactly; quantization exactly (``torch.round`` and
``jnp.round`` both round half to even); the compressed means within 1e-6 of
the mean of ``repro``'s per-rank dequantized (or sparsified) tensors.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_ranks as ranks
from repro.config import TrainConfig as RefTrainConfig
from repro.runtime.elastic import replan_mesh as ref_replan
from repro.runtime.monitor import StepMonitor as RefMonitor
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro_torch.config import TrainConfig
from repro_torch.core.integrity import CorruptionError, TransientError
from repro_torch.runtime import elastic, fault
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.train import compression, optimizer

SCHEDULES = {
    "cosine": dict(schedule="cosine", warmup_steps=5, decay_steps=50),
    "cosine-no-warmup": dict(schedule="cosine", warmup_steps=0, decay_steps=0,
                             learning_rate=3e-4, min_lr_ratio=0.05),
    "wsd": dict(schedule="wsd", warmup_steps=10, stable_steps=30, decay_steps=20),
    "constant": dict(schedule="constant", warmup_steps=7, learning_rate=1e-2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_repro(name):
    kw = SCHEDULES[name]
    want = np.array([np.asarray(ref_opt.lr_schedule(RefTrainConfig(**kw), s))
                     for s in range(90)])
    got = np.array([optimizer.lr_schedule(TrainConfig(**kw), s).numpy() for s in range(90)])
    assert got.dtype == want.dtype == np.float32
    if name.startswith("cosine"):
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    # a step tensor on its device gives the same
    st = torch.tensor(17, dtype=torch.int32)
    assert optimizer.lr_schedule(TrainConfig(**kw), st).numpy() == got[17]


def _tree(rng, scale=1.0):
    return {"b": {"d": (scale * rng.normal(size=(2, 3, 4))).astype(np.float32),
                  "c": (scale * rng.normal(size=(5,))).astype(np.float32)},
            "a": (scale * rng.normal(size=(3, 4))).astype(np.float32)}


def _torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype or torch.float32),
                        tree)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor)
                                             else a.astype(jnp.float32)), tree)


@pytest.mark.parametrize("clip", [1e9, 0.5], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("bf16_first", [False, True], ids=["f32", "bf16-first-leaf"])
def test_adamw_update_matches_repro(clip, bf16_first):
    rng = np.random.default_rng(7)
    params, grads = _tree(rng), _tree(rng, 3.0)
    m, v = _tree(rng, 0.01), jax.tree.map(np.abs, _tree(rng, 1e-3))
    kw = dict(learning_rate=1e-2, warmup_steps=3, decay_steps=10, grad_clip=clip,
              weight_decay=0.1)
    rp = dict(params)
    tp = _torch(params)
    if bf16_first:  # "a" is the first leaf in jax.tree order
        rp["a"] = jnp.asarray(params["a"]).astype(jnp.bfloat16)
        tp["a"] = tp["a"].to(torch.bfloat16)
    ropt = {"step": jnp.int32(2), "master": params, "m": m, "v": v}
    topt = {"step": torch.tensor(2, dtype=torch.int32), "master": _torch(params),
            "m": _torch(m), "v": _torch(v)}
    want_p, want_o, want_i = ref_opt.adamw_update(RefTrainConfig(**kw), rp, grads, ropt)
    got_p, got_o, got_i = optimizer.adamw_update(TrainConfig(**kw), tp, _torch(grads), topt)
    want_dt = torch.bfloat16 if bf16_first else torch.float32
    assert all(t.dtype == want_dt for t in jax.tree.leaves(got_p))
    for got, want in ((got_p, want_p), (got_o["master"], want_o["master"]),
                      (got_o["m"], want_o["m"]), (got_o["v"], want_o["v"])):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7),
                     _np(got), _np(want))
    assert got_o["step"].dtype == torch.int32 and int(got_o["step"]) == int(want_o["step"]) == 3
    assert got_i["lr"].numpy() == np.asarray(want_i["lr"])
    np.testing.assert_allclose(got_i["grad_norm"].numpy(), np.asarray(want_i["grad_norm"]),
                               rtol=1e-6)
    # in place: the same values, written into the given tensors (which
    # keep their dtypes, so a tree of mixed dtypes is refused)
    if bf16_first:
        with pytest.raises(ValueError, match="dtype"):
            optimizer.adamw_update(TrainConfig(**kw), tp, _torch(grads), topt, inplace=True)
        return
    ids = [id(t) for t in jax.tree.leaves(topt["m"])]
    ip_p, ip_o, _ = optimizer.adamw_update(TrainConfig(**kw), tp, _torch(grads), topt,
                                           inplace=True)
    assert ip_p is tp and [id(t) for t in jax.tree.leaves(ip_o["m"])] == ids
    for a, b in ((ip_p, got_p), (ip_o["master"], got_o["master"]), (ip_o["v"], got_o["v"])):
        jax.tree.map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)
    assert int(topt["step"]) == 3


def test_adamw_init_and_abstract():
    params = _torch(_tree(np.random.default_rng(1)))
    params["a"] = params["a"].to(torch.bfloat16)
    opt = optimizer.adamw_init(params)
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    for k in ("master", "m", "v"):
        assert [t.dtype for t in jax.tree.leaves(opt[k])] == [torch.float32] * 3
    assert torch.equal(opt["master"]["b"]["c"], params["b"]["c"])
    assert opt["master"]["b"]["c"].data_ptr() != params["b"]["c"].data_ptr()
    ab = optimizer.adamw_abstract(params)
    assert all(t.is_meta for t in jax.tree.leaves(ab))
    assert [t.shape for t in jax.tree.leaves(ab["m"])] == \
        [t.shape for t in jax.tree.leaves(params)]


def test_quantize_int8_matches_repro_with_ties_at_half():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(257,)).astype(np.float32)
    x[0] = 127.0  # scale exactly 1: the halves below round to even
    x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0]
    q, s = compression.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy() == np.asarray(rs) == np.float32(1.0)
    assert q[1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -127]
    np.testing.assert_array_equal(compression.dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_comp.dequantize_int8(rq, rs)))
    z, zs = compression.quantize_int8(torch.zeros(4))
    assert z.tolist() == [0] * 4 and zs.numpy() == np.asarray(ref_comp.quantize_int8(
        jnp.zeros(4))[1])


@pytest.mark.parametrize("ratio", [0.1, 0.25, 0.0])
def test_topk_matches_repro_with_ties(ratio):
    x = np.array([[1.0, -3.0, 3.0, 0.5], [-3.0, 2.0, 3.0, -2.0], [0.0, 0.0, 1.0, -1.0]],
                 np.float32)
    vals, idx = compression.topk_sparsify(torch.from_numpy(x), ratio)
    rv, ri = ref_comp.topk_sparsify(jnp.asarray(x), ratio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    back = compression.topk_restore(x.shape, vals, idx)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(ref_comp.topk_restore(x.shape, rv, ri)))


def test_compressed_allreduces_on_four_gloo_ranks(tmp_path):
    import pickle

    import torch.multiprocessing as mp

    d = 4
    ctx = mp.start_processes(ranks.compress_rank, args=(d, str(tmp_path)), nprocs=d,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=2):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(d):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    deq, sparse, errs = [], [], []
    for r in range(d):
        x, err = (jnp.asarray(a) for a in ranks.rank_inputs(r))
        deq.append(np.asarray(ref_comp.dequantize_int8(*ref_comp.quantize_int8(x))))
        acc = x + err
        vals, idx = ref_comp.topk_sparsify(acc, ranks.RATIO)
        sp = ref_comp.topk_restore(x.shape, vals, idx)
        sparse.append(np.asarray(sp))
        errs.append(np.asarray(acc - sp))
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["int8"], np.mean(deq, axis=0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["topk"], np.mean(sparse, axis=0), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(out["topk_error"], errs[r])


def test_step_monitor_on_an_injected_clock_matches_repro(monkeypatch):
    times = [0.01] * 12 + [0.05, 0.011, 0.2]
    clock = iter(np.cumsum([1.0] + [t for dt in times for t in (dt, 0.0)]).tolist())
    mon = StepMonitor(window=50, straggler_factor=3.0, clock=lambda: next(clock))
    got = []
    for s in range(len(times)):
        mon.start()
        got.append(mon.stop(s))
    # repro's monitor on the same step times, through its perf_counter
    import repro.runtime.monitor as ref_mod

    clock2 = iter(np.cumsum([1.0] + [t for dt in times for t in (dt, 0.0)]).tolist())
    monkeypatch.setattr(ref_mod.time, "perf_counter", lambda: next(clock2))
    ref = RefMonitor(window=50, straggler_factor=3.0)
    want = []
    for s in range(len(times)):
        ref.start()
        want.append(ref.stop(s))
    assert [g.get("straggler", False) for g in got] == [False] * 12 + [True, False, True]
    assert got == want and mon.summary() == ref.summary()
    assert mon.summary()["stragglers"] == 2 and mon.percentile(50) == pytest.approx(0.01)


def test_retry_step_counts_retries_and_never_retries_corruption():
    inj = fault.FaultInjector(fail_steps=[2], max_failures_per_step=2)
    seen = []
    out = fault.retry_step(lambda: (inj.maybe_fail(2), "ok")[1], backoff=0.0,
                           on_retry=lambda a, e: seen.append((a, type(e).__name__)))
    assert out == "ok" and inj.injected == 2 and seen == [(0, "TransientFault"),
                                                          (1, "TransientFault")]
    assert issubclass(fault.TransientFault, TransientError)
    calls = []

    def corrupt():
        calls.append(1)
        raise CorruptionError("arr_0.bin", "crc mismatch")

    with pytest.raises(CorruptionError):
        fault.retry_step(corrupt, backoff=0.0)
    assert calls == [1]
    with pytest.raises(fault.TransientFault):
        fault.retry_step(lambda: fault.FaultInjector([0], 9).maybe_fail(0), retries=2,
                         backoff=0.0)
    assert not issubclass(CorruptionError, TransientError)


@pytest.mark.parametrize("n,prefer", [(1, 16), (256, 16), (512, 16), (8, 16), (12, 16),
                                      (7, 4), (6, 4), (240, 16), (17, 16), (30, 8)])
def test_replan_mesh_matches_repro(n, prefer):
    import types

    got = elastic.replan_mesh(n, prefer_model=prefer)
    # repro builds a jax mesh of n devices; stand in jax.make_mesh for its sizes
    made = {}

    def fake_make_mesh(shape, names):
        made["shape"], made["names"] = shape, names
        return types.SimpleNamespace(devices=np.empty(shape), axis_names=names)

    orig = jax.make_mesh
    jax.make_mesh = fake_make_mesh
    try:
        ref_replan(n, prefer_model=prefer)
    finally:
        jax.make_mesh = orig
    assert got.shape == tuple(made["shape"]) and got.axis_names == tuple(made["names"])
    assert got.size == n


def test_surviving_devices_filters_by_index():
    devs = [torch.device("cuda", i) for i in range(4)]
    assert elastic.surviving_devices(devs, [1, 3]) == [torch.device("cuda", 0),
                                                       torch.device("cuda", 2)]
