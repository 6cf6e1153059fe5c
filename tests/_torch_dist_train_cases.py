"""Cases of ``repro``'s train step on D fake devices against ``repro_torch``'s
on D gloo ranks.

Shared by ``tests/test_torch_train_ranks.py``: :func:`repro_main` runs every
case in a process whose jax sees D CPU devices (``repro``'s
``make_train_step`` on a ``(D, 1)`` mesh, GSPMD); :func:`port_rank` runs
every case on one of D spawned processes, a gloo rank each (the port's
``make_train_step`` on the same mesh, the state cut by its placement).  Both
start from the same state, made here with numpy from a seed (the params by
each leaf's init kind, a float32 master copy, moments m ~ 0.01 N(0, 1) and
v ~ 1e-4 U(0, 1) + 1e-5 at step 3: nonzero moments keep AdamW's update a
smooth function of the grads), and take one step on the same batch.  Each
writes its results as a pickle into the test's temporary directory: the
metrics and the whole new state (the port's gathered from the ranks), and
on the port's side the D-rank checkpoint of that state beside a
one-process checkpoint of its gathered leaves.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

S = 16
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=20)
# name -> (arch, global batch, microbatches, mask, MoE capacity_factor)
CASES = {
    "gemma3": ("tiny-gemma3", 4, 1, False, None),
    # capacity ceil(T*k/E * 0.5) holds half the pairs: some expert overflows
    "mixtral_overflow": ("tiny-mixtral", 4, 1, False, 0.5),
    "xlstm": ("tiny-xlstm", 4, 1, False, None),
    "gemma3_mb2_mask": ("tiny-gemma3", 8, 2, True, None),
    "gemma3_batch3": ("tiny-gemma3", 3, 1, False, None),
}
CKPT_CASE = "gemma3_mb2_mask"


def config(get_arch, name):
    """The case's config from a package's ``get_arch``, in float32."""
    arch, _, _, _, cf = CASES[name]
    cfg = dataclasses.replace(get_arch(arch), param_dtype="float32", compute_dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _draw(defs, rng):
    """A numpy tree of ``defs`` (``ParamDef`` leaves) by each init kind."""
    if isinstance(defs, dict):
        return {k: _draw(defs[k], rng) for k in sorted(defs)}
    if defs.init == "zeros":
        return np.zeros(defs.shape, np.float32)
    if defs.init == "ones":
        return np.ones(defs.shape, np.float32)
    scale = 1.0 / np.sqrt(max(defs.shape[0], 1)) if defs.init == "scaled" else defs.scale
    return (scale * rng.normal(size=defs.shape)).astype(np.float32)


def state_and_batch(name):
    """(params, opt, batch) of case ``name`` as numpy trees."""
    from repro_torch.config import get_arch
    from repro_torch.models.model import Model

    cfg = config(get_arch, name)
    _, b, _, mask, _ = CASES[name]
    rng = np.random.default_rng(7)
    defs = Model(cfg).param_defs()
    params = _draw(defs, rng)
    like = lambda fn: _map(fn, params)  # noqa: E731
    opt = {"step": np.int32(3), "master": like(np.copy),
           "m": like(lambda a: (0.01 * rng.normal(size=a.shape)).astype(np.float32)),
           "v": like(lambda a: (1e-4 * rng.random(size=a.shape) + 1e-5).astype(np.float32))}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}
    if mask:
        batch["mask"] = (rng.random((b, S)) < 0.7).astype(np.float32)
    return params, opt, batch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def flat(tree, path=""):
    """Nested dicts/tuples of arrays -> {path: float64 numpy array}."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat(tree[k], f"{path}.{k}" if path else k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{path}[{i}]"))
    else:
        out[path] = np.asarray(tree.detach().cpu() if hasattr(tree, "detach") else tree,
                               dtype=np.float64)
    return out


# ---------------------------------------------------------------------------
# repro on D fake devices
# ---------------------------------------------------------------------------


def repro_main(out_path):
    import jax
    import jax.numpy as jnp

    from repro.config import ShardingPolicy, TrainConfig, get_arch
    from repro.models.model import Model
    from repro.train.step import TrainState, make_train_step

    fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    d = jax.device_count()
    # GSPMD's auto axes: jax.make_mesh's default explicit axes refuse the
    # embedding gather of a data-sharded table by data-sharded tokens
    mesh = jax.make_mesh((d, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    results = {}
    for name, (_, b, mb, mask, _) in CASES.items():
        cfg = config(get_arch, name)
        params, opt, batch = state_and_batch(name)
        tcfg = TrainConfig(**TRAIN, microbatches=mb)
        step, state_sh, batch_sh = make_train_step(
            Model(cfg), mesh, ShardingPolicy(), tcfg, b, S, donate=False, with_mask=mask)
        state = jax.device_put(TrainState(params, opt), state_sh)
        batch = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, batch_sh)
        new, met = jax.jit(step, compiler_options=fast)(state, batch)
        results[name] = {"state": flat(jax.tree.map(np.asarray, new._asdict())),
                         "metrics": {k: np.asarray(v) for k, v in met.items()}}
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# repro_torch on D gloo ranks
# ---------------------------------------------------------------------------


def _checkpoints(out_dir, state, place, ranks):
    """The D-rank save of ``state`` (rank slices) and a one-process save of
    its gathered leaves on rank 0; whether a D-rank restore gives back each
    rank's slices bit for bit."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.params import tensor_leaves

    mgr = CheckpointManager(os.path.join(out_dir, f"ckpt_d{ranks.size}"))
    mgr.save(4, state, extra={"step": 4}, blocking=True, shardings=place)
    whole = place.unshard(state)
    if ranks.rank == 0:
        CheckpointManager(os.path.join(out_dir, "ckpt_one")).save(
            4, whole, extra={"step": 4}, blocking=True)
    back, extra = mgr.restore(state, shardings=place)
    return extra == {"step": 4} and all(
        torch.equal(a, b) for a, b in zip(tensor_leaves(back), tensor_leaves(state), strict=True))


def port_rank(rank, d, out_dir):
    """One gloo rank of ``d`` (a ``torch.multiprocessing`` spawn target):
    every case's step; writes ``rank{rank}.pkl``."""
    import torch
    import torch.distributed as dist

    from repro_torch.config import ShardingPolicy, TrainConfig, get_arch
    from repro_torch.core.distributed import world
    from repro_torch.models.model import Model, train_state_from_reference
    from repro_torch.sharding.placement import placement
    from repro_torch.sharding.rules import make_mesh
    from repro_torch.train.step import make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rdzv')}",
                            rank=rank, world_size=d)
    try:
        ranks = world()
        mesh = make_mesh((d, 1), ("data", "model"))
        results = {}
        for name, (_, b, mb, mask, _) in CASES.items():
            model = Model(config(get_arch, name))
            params, opt, batch = state_and_batch(name)
            state = train_state_from_reference(model, (params, opt), device="cpu")
            tcfg = TrainConfig(**TRAIN, microbatches=mb)
            step, sspecs, _ = make_train_step(model, mesh, ShardingPolicy(), tcfg, b, S,
                                              donate=False, with_mask=mask)
            place = placement(sspecs, mesh, ranks)
            new, met = step(place.shard(state), batch)
            results[name] = {"state": flat(place.unshard(new)._asdict()),
                             "metrics": {k: v.numpy() for k, v in met.items()},
                             "local_shapes": [tuple(t.shape) for t in
                                              _leaves(new)]}
            if name == CKPT_CASE:
                results["restore_equal"] = _checkpoints(out_dir, new, place, ranks)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    from repro_torch.models.params import tensor_leaves

    return tensor_leaves(tree)
