"""Dry-run of the port (``repro.launch.dryrun``'s counterpart): every
(architecture x input shape x mesh) cell's FLOPs, bytes, memory and
collective bytes a device, without a card and without allocating.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sa   # SA-pipeline sizing

``repro`` lowers each cell for 512 fake XLA devices and reads XLA's
``cost_analysis``, ``memory_analysis`` and the HLO's collectives.  The port
has no compiler to ask, so it counts one step of ``Model`` eagerly on the
``meta`` device (shapes and dtypes, no memory) at the cell's full global
shape (``launch.specs``), and derives the rest from the spec trees of
``repro_torch.sharding`` on the production mesh (``launch.mesh``).  The
result dicts keep ``repro``'s keys; the numbers are the port's own and are
not compared with XLA's:

* ``hlo_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of a
  train step (forward, backward with the recomputation ``cfg.remat`` asks
  for), a prefill or a decode step, divided by the chips (every chip of
  the mesh shares the work: data parallelism over the batch, tensor
  parallelism over the heads and the MLP).  It counts the matmul-class ops
  (matmul, einsum, attention products); elementwise work counts no FLOPs,
  as in ``repro``'s 6·N·D model.
* ``hlo_bytes``: the bytes every op the step dispatches reads and writes
  (its tensor inputs and outputs; views move none), divided by the chips:
  the eager program's unfused traffic.
* ``peak_memory_bytes``, with its parts under ``memory``: the state by the
  spec trees (each leaf's bytes over the product of the mesh axes its
  ``param_specs`` entry cuts it over; params, master, m and v), the grads
  the same way, the activations the forward leaves alive for the backward
  (the storages the forward made that are still referenced when it
  returns: what autograd saved, the checkpointed blocks' inputs and, under
  ``dots_saveable``, the matmul outputs), divided by the data shards of the
  batch, the largest transient (the float32 logits and their grad of the
  loss's chunk), and, for prefill and decode, the params and the cache by
  ``cache_specs``.
* ``collective``: ``repro.analysis.hlo.collective_bytes``' dict, derived
  from the spec trees: the all-gather of every leaf the data axes cut, in
  the compute dtype (again in the backward under remat), the
  reduce-scatter of its grad, and the all-reduce of every other leaf's
  grad over the data axes.  Tensor-parallel activation collectives cannot
  be read from the spec trees and are left out (``collective_omits``).

A record says how it was counted (``counted``).  A recurrent arch's time
loop over a long sequence is a Python loop of a step a position, which the
``meta`` device takes at about 0.1-0.3 ms an op on a CPU: xlstm-125m's
train step at 4096 positions would take hours.  Such a cell is counted at
a few short lengths (and depths) and extrapolated (``count``); a cell
counts in seconds either way.  ``run_cell_corrected`` takes the ssm
family's FLOPs from ``repro``'s analytic model
(``corrected.xlstm_analytic_flops``), as ``repro`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# a recurrent arch is counted directly up to this many time-loop steps
# (positions x recurrent layers); past it, at short lengths (``count``)
MAX_DIRECT_STEPS = 8_192
TRANSIENT = "logits"
OMITS = "tensor-parallel activation collectives (not read from the spec trees)"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpCount(TorchDispatchMode):
    """Bytes every op reads and writes (views none), and the storages the
    ops make, by weak reference, for the live-activation sum."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.made: Dict[int, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.multiprocessing.reductions import StorageWeakRef
        from torch.utils._pytree import tree_leaves

        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            s = t.untyped_storage()
            self.made.setdefault(s._cdata, (StorageWeakRef(s), s.nbytes()))
        return out

    def live_bytes(self, exclude=()) -> int:
        """Bytes of the storages made so far that something still holds."""
        return sum(n for key, (ref, n) in self.made.items()
                   if key not in exclude and not ref.expired())


def _storages(tree) -> set:
    from repro_torch.models.params import tensor_leaves

    return {t.untyped_storage()._cdata for t in tensor_leaves(tree)}


def count_step(model, shape, tcfg=None) -> dict:
    """FLOPs, bytes and live activations of one step of ``model`` at the
    global ``shape`` on the ``meta`` device (a ``ShapeConfig``): a train
    step (loss, grads, the AdamW update), a prefill or a decode step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import TrainConfig
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.params import tensor_leaves, tensor_map, tree_unflatten
    from repro_torch.train.optimizer import adamw_abstract, adamw_update

    cfg = model.cfg
    params = model.abstract()
    ins = input_specs(cfg, shape)
    out = {"activations": 0}
    with FlopCounterMode(display=False) as flops, _OpCount() as ops:
        if shape.kind == "train":
            live = tensor_map(lambda p: p.detach().requires_grad_(True), params)
            with torch.enable_grad():
                loss, _ = model.loss(live, ins)
                out["activations"] = ops.live_bytes(_storages(params) | _storages(ins))
                grads = torch.autograd.grad(loss, tensor_leaves(live), allow_unused=True,
                                            materialize_grads=True)
            del loss, live
            with torch.no_grad():
                adamw_update(tcfg or TrainConfig(), params, tree_unflatten(params, grads),
                             adamw_abstract(params))
        elif shape.kind == "prefill":
            with torch.no_grad():
                model.prefill(params, tokens=ins.get("tokens"), embeds=ins.get("embeds"),
                              max_seq=shape.seq_len)
        else:
            cache = model.abstract_cache(shape.global_batch, shape.seq_len)
            with torch.no_grad():
                model.decode_step(params, cache, ins["tokens"], ins["pos"])
    out.update(flops=float(flops.get_total_flops()), bytes=float(ops.bytes))
    return out


def _lagrange(points, x):
    """The polynomial through ``points`` ((x_i, {key: y_i}) pairs) at ``x``,
    key by key."""
    out = {}
    for key in points[0][1]:
        total = 0.0
        for i, (xi, yi) in enumerate(points):
            w = 1.0
            for j, (xj, _) in enumerate(points):
                if j != i:
                    w *= (x - xj) / (xi - xj)
            total += w * yi[key]
        out[key] = max(total, 0.0)
    return out


def time_loop_steps(cfg, shape) -> int:
    """Positions x recurrent layers one step of ``shape`` runs its time
    loops over (0 for attention-only archs and for decode)."""
    if shape.kind == "decode" or cfg.family not in ("ssm", "hybrid"):
        return 0
    return shape.seq_len * cfg.num_layers


def count(cfg, shape, tcfg=None):
    """(counts, how they were counted) of one step: ``count_step`` at the
    full shape, or, where a recurrent arch's time loop is longer than
    ``MAX_DIRECT_STEPS``, at short sequences and extrapolated to the full
    one.  Every count is a polynomial of degree 2 in the sequence length:
    the ssm family's time loop reads one position of its (B, S, ...)
    projections a step, and each such select's backward writes a grad of
    the whole projection (S steps of S positions), with no chunks, so it is
    counted at 16, 32 and 48 positions.  The hybrid's attention scores and
    masks are S x S and its SSM's time loop runs chunk by chunk, so in a
    whole number of chunks its counts are of degree 2 too: it is counted at
    1, 2 and 3 chunks.  Its layers are alike, so its FLOPs and activations
    grow linearly with depth (``corrected.two_point``'s premise), but a
    train step's bytes do not: each layer's ``a[i]`` of a stacked leaf
    writes a grad of the whole (L, ...) leaf in the backward, L x L in all.
    So each length is counted at depth 1, 2 and 3 and taken to the full
    depth by the polynomial of degree 2 first.  On tiny-xlstm and
    tiny-hymba at 256 positions the extrapolated FLOPs and activations
    equal the direct counts, and so do the bytes but a hybrid train step's,
    within 0.02 % (``tests/test_torch_dryrun.py``)."""
    from repro_torch.analysis.corrected import reduced_arch
    from repro_torch.models.model import Model

    if time_loop_steps(cfg, shape) <= MAX_DIRECT_STEPS:
        return count_step(Model(cfg), shape, tcfg), "direct: every layer of the eager loop"

    def at(s, depth=None):
        c = cfg if depth is None else reduced_arch(cfg, depth)
        return count_step(Model(c), dataclasses.replace(shape, seq_len=s), tcfg)

    if cfg.family == "ssm":
        points = [(s, at(s)) for s in (16, 32, 48)]
        how = "at full depth"
    else:
        chunk = cfg.ssm.chunk_size or 64
        points = [(k * chunk, _lagrange([(d, at(k * chunk, d)) for d in (1, 2, 3)],
                                        cfg.num_layers))
                  for k in (1, 2, 3)]
        how = f"at depth 1, 2 and 3 (degree 2 to {cfg.num_layers} layers)"
    lens = ", ".join(str(p[0]) for p in points)
    return (_lagrange(points, shape.seq_len),
            f"time loop: counted at sequence lengths {lens} {how} and extrapolated to "
            f"{shape.seq_len} (degree 2 in the length)")


def _shards(spec, sizes) -> int:
    n = 1
    for entry in spec:
        names = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        for a in names:
            n *= sizes[a]
    return n


def _per_device_bytes(tree, specs, sizes) -> float:
    from repro_torch.models.params import tensor_leaves, tree_leaves
    from repro_torch.sharding.rules import P

    leaves = tensor_leaves(tree)
    spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return float(sum(_nbytes(t) / _shards(s, sizes)
                     for t, s in zip(leaves, spec_leaves, strict=True)))


def spec_collective_bytes(model, mesh, policy, kind: str) -> Dict[str, int]:
    """A step's collective bytes a device, in ``collective_bytes``' dict
    (operand bytes: an all-gather's is the local shard, a reduce-scatter's
    the shard times the group), from the param spec tree: the all-gather of
    each leaf the data axes cut, in the compute dtype (twice in a train step
    under remat: the backward gathers again), and in a train step the
    reduce-scatter of its grad and the all-reduce over the data axes of
    every other leaf's grad.  No tensor-parallel activation collective."""
    from repro_torch.models.params import tensor_leaves, tree_leaves
    from repro_torch.models.transformer import dtype_of
    from repro_torch.sharding.rules import P, param_specs

    cfg = model.cfg
    sizes = mesh.axis_sizes
    data = tuple(a for a in policy.dp_axes if a in sizes)
    data_size = math.prod(sizes[a] for a in data)
    cbytes = torch.empty((), dtype=dtype_of(cfg.compute_dtype)).element_size()
    specs = tree_leaves(param_specs(model, mesh, policy), is_leaf=lambda x: isinstance(x, P))
    gathers = 2 if kind == "train" and cfg.remat != "none" else 1
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for t, spec in zip(tensor_leaves(model.abstract()), specs, strict=True):
        f_all = _shards(spec, sizes)
        f_data = _shards(P(*(tuple(a for a in (e if isinstance(e, tuple) else (e,))
                                   if a in data) or None for e in spec)), sizes)
        f_tp = f_all // f_data
        if f_data > 1:
            out["all-gather"] += gathers * t.numel() * cbytes // f_all
            if kind == "train":
                out["reduce-scatter"] += _nbytes(t) // f_tp
        elif kind == "train" and data_size > 1:
            out["all-reduce"] += _nbytes(t) // f_tp
    out = {k: int(v) for k, v in out.items() if v}
    out["total"] = sum(out.values())
    return out


def memory_parts(model, shape, mesh, policy, activations: float) -> Dict[str, float]:
    """Memory a device of one step, by part (bytes): see the module
    docstring."""
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.models.transformer import dtype_of
    from repro_torch.sharding.rules import batch_specs, cache_specs, keystr_map, param_specs
    from repro_torch.train.step import state_specs

    cfg = model.cfg
    sizes = mesh.axis_sizes
    bspec = batch_specs(cfg, mesh, policy, shape.global_batch, kind=shape.kind)
    first = next(iter(bspec.values()))
    data_shards = _shards(first[:1], sizes)
    b_local = shape.global_batch / data_shards
    cbytes = torch.empty((), dtype=dtype_of(cfg.compute_dtype)).element_size()
    pspecs = param_specs(model, mesh, policy)
    if shape.kind == "train":
        chunk = min(cfg.loss_chunk or shape.seq_len, shape.seq_len)
        return {
            "state": _per_device_bytes(train_state_specs(model),
                                       state_specs(model, mesh, policy), sizes),
            "grads": _per_device_bytes(model.abstract(), pspecs, sizes),
            "activations": activations / data_shards,
            TRANSIENT: b_local * chunk * cfg.vocab_size * 4.0,
        }
    cache = model.abstract_cache(shape.global_batch, shape.seq_len)
    cspec = keystr_map(cache_specs(cfg, mesh, policy, shape.global_batch,
                                   long_context=shape.name == "long_500k"), cache)
    tokens = shape.seq_len if shape.kind == "prefill" else 1
    return {
        "params": _per_device_bytes(model.abstract(), pspecs, sizes),
        "cache": _per_device_bytes(cache, cspec, sizes),
        TRANSIENT: b_local * tokens * cfg.vocab_size * cbytes,
    }


def _policy(multi_pod: bool):
    from repro_torch.config import ShardingPolicy

    return ShardingPolicy(fsdp_axes=("data",) if not multi_pod else ("pod", "data"),
                          dp_axes=("pod", "data"))


def run_cell(arch: str, shape_name: str, multi_pod: bool, record_hlo: bool = True,
             cfg_override=None, policy_override=None, mesh=None):
    """Count one cell on the ``meta`` device; returns a result dict with
    ``repro``'s keys (``record_hlo``: the collective bytes).  ``mesh``: a
    ``sharding.Mesh`` in place of the production mesh."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.config import LM_SHAPES, get_arch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import long_context_supported
    from repro_torch.models.model import Model

    cfg = get_arch(arch)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    shape = LM_SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(map(str, mesh.shape))
    t0 = time.time()
    if shape.name == "long_500k" and not long_context_supported(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": "pure full attention (DESIGN.md §5 long_500k policy)"}
    policy = policy_override if policy_override is not None else _policy(multi_pod)
    model = Model(cfg)
    counts, how = _cached_count(cfg, shape)
    chips = mesh.size
    coll = spec_collective_bytes(model, mesh, policy, shape.kind) if record_hlo else {}
    rec = rl.Roofline(arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
                      hlo_flops=counts["flops"] / chips, hlo_bytes=counts["bytes"] / chips,
                      collective=coll, model_flops_total=rl.model_flops(cfg, shape))
    parts = memory_parts(model, shape, mesh, policy, counts["activations"])
    rec.peak_memory_bytes = float(sum(parts.values()))
    rec.finish()
    out = rec.to_dict()
    out.update(status="ok", seconds=round(time.time() - t0, 1),
               roofline_fraction=rec.roofline_fraction(),
               memory=parts, memory_analysis=json.dumps(parts), num_params=model.num_params(),
               counted=how, collective_omits=OMITS, remat=cfg.remat)
    return out


_COUNTS: Dict[tuple, tuple] = {}


def _cached_count(cfg, shape):
    """``count`` once a (config, shape): a cell's count does not depend on
    its mesh, so ``--mesh both`` counts each once."""
    key = (cfg, shape)
    if key not in _COUNTS:
        _COUNTS[key] = count(cfg, shape)
    counts, how = _COUNTS[key]
    return dict(counts), how


def run_cell_corrected(arch: str, shape_name: str, multi_pod: bool = False,
                       cfg_override=None, policy_override=None):
    """``repro``'s scan-once-corrected cell.  The eager loop visits every
    layer, so the port's count needs no depth correction: the record is
    ``run_cell``'s and says so; the ssm family's FLOPs are ``repro``'s
    analytic model, as in ``repro``."""
    from repro_torch.analysis import corrected as corr
    from repro_torch.analysis import roofline as rl
    from repro_torch.config import LM_SHAPES, get_arch

    r = run_cell(arch, shape_name, multi_pod, cfg_override=cfg_override,
                 policy_override=policy_override)
    if r["status"] != "ok":
        return r
    cfg = get_arch(arch)
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    if cfg.family != "ssm":
        r["correction"] = "none: the eager loop counts every layer"
        return r
    shape = LM_SHAPES[shape_name]
    r["hlo_flops_analytic"] = corr.xlstm_analytic_flops(cfg, shape)
    rec = rl.Roofline(arch=arch, shape=shape_name, mesh=r["mesh"], chips=r["chips"],
                      hlo_flops=r["hlo_flops_analytic"] / r["chips"],
                      hlo_bytes=r["hlo_bytes"], collective=r["collective"],
                      model_flops_total=r["model_flops_total"])
    rec.peak_memory_bytes = r["peak_memory_bytes"]
    rec.finish()
    r.update(rec.to_dict(), roofline_fraction=rec.roofline_fraction(),
             correction="xlstm-analytic-flops", status="ok")
    return r


SA_READS_PER_SHARD, SA_READ_LEN = 2048, 200


def run_sa_dryrun(multi_pod: bool):
    """The SA pipeline's shard sizing on the production shard count
    (``repro``'s cell: 2048 reads of 200 tokens a shard on 256 or 512
    shards, ``SAConfig(vocab_size=4, packing="base", samples_per_shard=1024,
    adaptive=False)``), from the port's ``pipeline.plan`` and its shuffle
    and fetch capacities: rows and record bytes a shard, and the bytes a
    shard puts into the record shuffle's all-to-all and into one fetch
    round's two (requests, then responses)."""
    from repro_torch.config import SAConfig
    from repro_torch.core.pipeline import fetch_capacity, plan
    from repro_torch.launch.mesh import make_sa_mesh

    d = make_sa_mesh(512 if multi_pod else 256).size
    cfg = SAConfig(vocab_size=4, packing="base", samples_per_shard=1024, adaptive=False)
    t0 = time.time()
    info = plan((SA_READS_PER_SHARD * d, SA_READ_LEN), cfg, d)
    word = 4
    cap = info["shuffle_cap"]
    fcap = fetch_capacity(cap, cfg, d)
    resp_width = (cfg.key_words if cfg.server_pack else cfg.prefix_len) + 1
    shuffle = d * cap * 4 * word  # (D, cap, 4) int32 records
    fetch = {"requests": d * fcap * 2 * word, "responses": d * fcap * resp_width * word}
    return {
        "arch": "suffix-array-pipeline",
        "shape": f"reads{SA_READS_PER_SHARD * d}x{SA_READ_LEN}",
        "mesh": "512flat" if multi_pod else "256flat",
        "status": "ok",
        "seconds": round(time.time() - t0, 1),
        "rows_per_shard": info["rows_per_shard"],
        "records_per_shard": info["n_local"],
        "record_bytes_per_shard": info["n_local"] * 4 * word,
        "shuffle_cap": cap,
        "fetch_capacity": fcap,
        "max_rounds": info["max_rounds"],
        "shuffle_bytes_per_shard": shuffle,
        "fetch_round_bytes_per_shard": fetch,
        "collective": {"all-to-all": shuffle + sum(fetch.values()),
                       "total": shuffle + sum(fetch.values())},
        "counted": "plan: the shuffle's all-to-all and one fetch round's two",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sa", action="store_true", help="SA-pipeline dry-run")
    ap.add_argument("--corrected", action="store_true",
                    help="repro's corrected roofline accounting (the ssm FLOPs analytic)")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    from repro_torch.config import LM_SHAPES, list_archs

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.sa:
        for mp in meshes:
            r = run_sa_dryrun(mp)
            results.append(r)
            print(json.dumps({k: r[k] for k in ("arch", "mesh", "status", "seconds")}))
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        return

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(LM_SHAPES)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape, mesh_name) in done:
                    continue
                try:
                    if args.corrected:
                        r = run_cell_corrected(arch, shape, mp)
                    else:
                        r = run_cell(arch, shape, mp)
                except Exception as e:  # record the failure, keep going
                    r = {
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                results.append(r)
                print(
                    json.dumps(
                        {k: r.get(k) for k in
                         ("arch", "shape", "mesh", "status", "seconds",
                          "bottleneck", "roofline_fraction", "error")}
                    ),
                    flush=True,
                )
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
