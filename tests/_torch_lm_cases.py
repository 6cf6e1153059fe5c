"""Shared cases of the LM tests: ``repro``'s outputs for a tiny arch,
computed once per arch and process, and the port's on the same weights.

``repro``'s side is the slow one (XLA compiles each function), so every
output of an arch comes from one ``jax.jit`` (``reference``), and the
engine's from ``repro``'s own ``ServeEngine``.  ``ref_jit`` compiles with
LLVM's optimizations off (``FAST_COMPILE``): half the compile time, the
same functions, with float32 results that move within round-off.  Weights come from
``repro``'s ``Model.init`` and reach the port through
``params_from_reference``; inputs are numpy, from a seed.

Tolerances, all float32 on the CPU: logits, caches and losses at 2e-4,
the repo's own (``tests/test_models_smoke.py``); decode, the windowed decode
and the engine's caches at 2e-3, where ``repro``'s own decode test takes it.
Each is both the rtol and, scaled by the tensor's largest magnitude where
that exceeds 1, the atol (``close``).  The tiny configs' ``scaled`` init
has fan_in = the layer count (the stacked axis), so activations reach the
hundreds and a hybrid's SSM state 1e4; float32 round-off then scales with
the terms summed, not with each result (on tiny-mixtral ``repro``'s own
chunked attention differs from its plain path by 1.9e-4 of logits up to
7.0, where the port's two paths agree to 1.2e-5).  bfloat16 forward
logits: relative RMS error at most 0.1 and max |error| at most 0.25 x max
|logit|.  XLA on the CPU fuses chains of bf16 elementwise ops in float32
where PyTorch rounds after each op, and a token whose MoE routing flips
under that rounding changes its whole output: the largest measured values
are 0.078 and 0.213 (tiny-granite-moe), 0.043 and 0.110 elsewhere
(tiny-xlstm).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_arch
from repro.models.model import Model as RefModel
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.config import get_arch
from repro_torch.models import transformer
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.engine import Request, ServeEngine, schedule_steps

B, S, P, MAXSEQ, T_WIN, CHUNK = 2, 16, 8, 12, 20, 8
TOL, DECODE_TOL = 2e-4, 2e-3
BF16_RMS, BF16_MAX = 0.1, 0.25
# (prompt length, max_new) of the engine's five requests over two slots
ENGINE_REQS = ((3, 4), (5, 3), (2, 5), (4, 2), (6, 4))
ENGINE_SLOTS, ENGINE_MAXSEQ = 2, 32

# XLA options of every compile of repro's side: codegen without LLVM's
# optimization passes (the tiny shapes run in microseconds either way)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def ref_jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def ref_key(seed):
    """A key for ``repro``'s inits: the ``rbg`` generator compiles in less
    time than threefry's unrolled rounds (the draws differ; both are
    ``repro``'s ``Model.init``)."""
    return jax.random.key(seed, impl="rbg")


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the tiny tensors gain
    nothing from more, and the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CHECKS = ("forward", "prefill_logits", "prefill_cache", "decode_logits",
          "decode_cache", "windowed", "loss", "chunked_loss", "flash", "engine",
          "bf16")


# the archs whose chunked loss and chunked attention are checked (one a test
# file, and the embeddings-mode one): each variant is another graph for XLA
# to compile, and they take the same layer code as the plain paths
CHUNKED = ("tiny-gemma3", "tiny-mixtral", "tiny-hymba", "tiny-internvl2")


def checks_for(name):
    """The checks that apply to ``name``: the xLSTM family has no windowed
    cache; the chunked variants run on ``CHUNKED``."""
    skip = set() if name in CHUNKED else {"chunked_loss", "flash"}
    if get_arch(name).family == "ssm":
        skip.add("windowed")
    return [c for c in CHECKS if c not in skip]


def cases(archs):
    return [(n, c) for n in archs for c in checks_for(n)]


def f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def inputs(cfg):
    rng = np.random.default_rng(0)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
        "mask": (rng.random((B, S)) < 0.7).astype(np.float32),
        "seq": rng.integers(0, cfg.vocab_size, size=(B, T_WIN)).astype(np.int32),
        "prompts": [rng.integers(1, cfg.vocab_size, size=(n,)).tolist()
                    for n, _ in ENGINE_REQS],
    }
    if cfg.input_mode == "embeddings":
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return out


def model_inputs(cfg, x, stop=S):
    if cfg.input_mode == "embeddings":
        return {"embeds": x["embeds"][:, :stop]}
    return {"tokens": x["tokens"][:, :stop]}


def numpy_tree(tree):
    """Nested dicts/tuples of jax or torch arrays -> {path: float64 array}."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}" if path else k)
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        elif isinstance(t, torch.Tensor):
            out[path] = t.detach().float().cpu().numpy().astype(np.float64)
        else:
            out[path] = np.asarray(t).astype(np.float64)

    walk(tree, "")
    return out


def _variants(cfg):
    if cfg.name not in CHUNKED:
        return None, None
    return (dataclasses.replace(cfg, loss_chunk=CHUNK),
            dataclasses.replace(cfg, attn_chunk=CHUNK))


def _engine(engine_cls, request_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, batch_slots=ENGINE_SLOTS, max_seq=ENGINE_MAXSEQ, **kw)
    if engine_cls is RefEngine:  # repro's step, compiled as ref_jit compiles
        eng._step = ref_jit(model.decode_step)
    reqs = [request_cls(rid=i, prompt=list(p), max_new=n)
            for i, (p, (_, n)) in enumerate(zip(prompts, ENGINE_REQS, strict=True))]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return {"steps": eng.steps, "done": [r.rid for r in done],
            "generated": [list(r.generated) for r in reqs], "cache": numpy_tree(eng.cache)}


@functools.lru_cache(maxsize=None)
def reference(name):
    """``repro``'s outputs for ``name`` (numpy) and its float32 weights.

    One ``jax.jit`` draws the weights (``Model.init``) and computes every
    float32 output, the windowed decode (a ``lax.scan`` of ``T_WIN`` steps)
    and the bfloat16 forward on the same weights cast to bfloat16 (which is
    what ``Model.init`` in bfloat16 draws: it casts its float32 draws); the
    engine runs ``repro``'s own ``ServeEngine``."""
    base = ref_arch(name)
    cfg = f32(base)
    model = RefModel(cfg)
    x = inputs(cfg)
    chunk_cfg, flash_cfg = _variants(cfg)
    inp = {k: jnp.asarray(v) for k, v in model_inputs(cfg, x).items()}
    batch = {**inp, "labels": jnp.asarray(x["labels"])}

    def run(key):
        p = model.init(key)
        out = {"params": p, "forward": model.forward(p, **inp)}
        pre = {k: v[:, :P] for k, v in inp.items()}
        out["prefill_logits"], out["prefill_cache"] = model.prefill(p, **pre, max_seq=MAXSEQ)
        out["decode_logits"], out["decode_cache"] = model.decode_step(
            p, out["prefill_cache"], jnp.asarray(x["tokens"][:, P:P + 1]),
            jnp.full((B,), P, jnp.int32))
        out["loss"] = model.loss(p, batch)[0]
        if chunk_cfg is not None:
            mask = jnp.asarray(x["mask"])
            out["chunked_loss"] = RefModel(chunk_cfg).loss(p, {**batch, "mask": mask})[0]
            out["flash"] = RefModel(flash_cfg).forward(p, **inp)
        if cfg.family != "ssm":
            wmodel = RefModel(dataclasses.replace(cfg, window_decode_cache=True))

            def step(cache, t):
                tok = jax.lax.dynamic_slice_in_dim(jnp.asarray(x["seq"]), t, 1, axis=1)
                lg, cache = wmodel.decode_step(p, cache, tok, jnp.full((B,), t, jnp.int32))
                return cache, lg[:, 0]

            _, lg = jax.lax.scan(step, wmodel.init_cache(B, T_WIN), jnp.arange(T_WIN))
            out["windowed"] = lg.transpose(1, 0, 2)
        pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
        out["bf16_params"] = pb
        out["bf16"] = RefModel(base).forward(pb, **inp).astype(jnp.float32)
        return out

    out = ref_jit(run)(ref_key(0))
    params, bf16_params = out.pop("params"), out.pop("bf16_params")
    out = {k: numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in out.items()}
    out["engine"] = _engine(RefEngine, RefRequest, model, params, x["prompts"])
    return out, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bf16_params)


@functools.lru_cache(maxsize=None)
def port_model(name):
    ref_params = reference(name)[1]
    model = Model(f32(get_arch(name)))
    params_from_reference(model, ref_params, device="cpu")
    return model


@functools.lru_cache(maxsize=None)
def port_outputs(name):
    """The port's outputs for the checks of ``name``, on the reference's
    weights (each computed once)."""
    model = port_model(name)
    cfg = model.cfg
    p = model.params()
    x = inputs(cfg)
    inp = model_inputs(cfg, x)
    batch = {**inp, "labels": x["labels"]}
    out = {"forward": model.forward(p, **inp)}
    logits, cache = model.prefill(p, **model_inputs(cfg, x, P), max_seq=MAXSEQ)
    out["prefill_logits"], out["prefill_cache"] = logits, numpy_tree(cache)
    out["decode_logits"], cache = model.decode_step(
        p, cache, x["tokens"][:, P:P + 1], np.full((B,), P, np.int32))
    out["decode_cache"] = numpy_tree(cache)
    out["loss"] = model.loss(p, batch)[0]
    chunk_cfg, flash_cfg = _variants(cfg)
    if chunk_cfg is not None:
        out["chunked_loss"] = Model(chunk_cfg).loss(p, {**batch, "mask": x["mask"]})[0]
        out["flash"] = Model(flash_cfg).forward(p, **inp)
    if cfg.family != "ssm":
        out["windowed"], out["windowed_full"] = windowed_runs(model, x["seq"])
    out["engine"] = _engine(ServeEngine, Request, model, p, x["prompts"], device="cpu")
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def windowed_runs(model, seq):
    """Logits (B, T, V) of decoding ``seq`` token by token from empty caches
    with ``decode_step_windowed`` (ring caches) and with ``decode_step``."""
    cfg, p = model.cfg, model.params()
    ring = transformer.init_cache_windowed(cfg, seq.shape[0], seq.shape[1], device="cpu")
    full = transformer.init_cache(cfg, seq.shape[0], seq.shape[1], device="cpu")
    tok = torch.as_tensor(seq)
    got, want = [], []
    for t in range(seq.shape[1]):
        pos = torch.full((seq.shape[0],), t, dtype=torch.int32)
        lg, ring = transformer.decode_step_windowed(cfg, p, ring, tok[:, t:t + 1], pos)
        got.append(lg[:, 0])
        lg, full = transformer.decode_step(cfg, p, full, tok[:, t:t + 1], pos)
        want.append(lg[:, 0])
    return torch.stack(got, 1), torch.stack(want, 1)


def close(got, want, tol):
    """rtol = ``tol``, atol = ``tol`` x max(1, max |want|)."""
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max(initial=0))))


def assert_trees_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], tol)


def bf16_logits(name):
    """(port, repro) forward logits of the bfloat16 config on the same
    bfloat16 weights."""
    ref, _, params = reference(name)
    port = Model(get_arch(name))
    p = params_from_reference(port, params, device="cpu")
    return port.forward(p, **model_inputs(port.cfg, inputs(port.cfg))).float().numpy(), ref["bf16"]


def check(name, what):
    """Hold the port's ``what`` for ``name`` to ``repro``'s."""
    if what == "bf16":
        got, want = bf16_logits(name)
        assert np.isfinite(got).all()
        err = got - want
        assert np.sqrt(np.mean(err ** 2) / np.mean(want ** 2)) <= BF16_RMS
        assert np.abs(err).max() <= BF16_MAX * np.abs(want).max()
        return
    ref = reference(name)[0]
    out = port_outputs(name)
    if what == "engine":
        got, want = out["engine"], ref["engine"]
        assert got["steps"] == want["steps"] and got["done"] == want["done"]
        assert got["steps"] == max(schedule_steps([n for n, _ in ENGINE_REQS],
                                                  [m for _, m in ENGINE_REQS],
                                                  ENGINE_SLOTS))
        assert got["generated"] == want["generated"]
        assert [len(g) for g in got["generated"]] == [n for _, n in ENGINE_REQS]
        assert_trees_close(got["cache"], want["cache"], DECODE_TOL)
    elif what == "windowed":
        close(out["windowed"], ref["windowed"], DECODE_TOL)
        close(out["windowed"], out["windowed_full"], DECODE_TOL)
    elif what == "flash":
        close(out["flash"], ref["flash"], TOL)
        close(out["flash"], out["forward"], TOL)
    elif what.endswith("_cache"):
        assert_trees_close(out[what], ref[what], DECODE_TOL if what == "decode_cache" else TOL)
    else:
        close(out[what], ref[what], DECODE_TOL if what == "decode_logits" else TOL)


def torch_tree(p):
    """A flat dict of ``repro`` arrays as CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def slot_state_runs(name):
    """The engine's cache after two one-token requests through one slot, and
    after the second request alone, in both packages."""
    ref_params = reference(name)[1]
    ref_model = RefModel(f32(ref_arch(name)))
    model = port_model(name)
    out = {}
    for label, prompts in (("after", ([5], [7])), ("alone", ([7],))):
        for pkg, eng in (("repro", RefEngine(ref_model, jax.tree.map(jnp.asarray, ref_params),
                                             batch_slots=1, max_seq=4)),
                         ("port", ServeEngine(model, model.params(), batch_slots=1,
                                              max_seq=4, device="cpu"))):
            req_cls = RefRequest if pkg == "repro" else Request
            if pkg == "repro":
                eng._step = ref_jit(ref_model.decode_step)
            for i, pr in enumerate(prompts):
                eng.submit(req_cls(rid=i, prompt=pr, max_new=1))
            eng.run_until_drained()
            out[pkg, label] = numpy_tree(eng.cache)
    return out
