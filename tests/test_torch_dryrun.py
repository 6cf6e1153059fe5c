"""The port's dry-run (``repro_torch.launch.dryrun``), mesh, perf driver
and the train launcher's ``--dry-run``, on the tiny configs.

The counts come from the ``meta`` device, so they are checked against what
fixes them independently: ``repro``'s analytic ``model_flops`` (a train
step counts at least 6·N·tokens), the depth two-point on a stack of like
layers, the spec trees' bytes against a state actually cut by its
placement, the order of the three remat policies, the port's ``plan`` for
the SA cell, and ``repro``'s own numbers where they are the same
arithmetic (the SA sizing, the skipped cells).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.config import get_arch as ref_arch
from repro.launch.specs import long_context_supported as ref_long_context
from repro_torch.analysis.corrected import reduced_arch, two_point
from repro_torch.config import LM_SHAPES, SAConfig, ShapeConfig, ShardingPolicy, get_arch
from repro_torch.core.distributed import Ranks
from repro_torch.core.pipeline import fetch_capacity, plan
from repro_torch.launch import dryrun, mesh as mesh_lib, perf
from repro_torch.launch import train as lm_train
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.models.params import tensor_leaves
from repro_torch.sharding.placement import placement
from repro_torch.sharding.rules import make_mesh
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import TrainState, state_specs

TINY = ("tiny-gemma3", "tiny-granite", "tiny-minicpm", "tiny-mixtral", "tiny-granite-moe",
        "tiny-hymba", "tiny-internvl2", "tiny-musicgen", "tiny-xlstm")
MESHES = {"1x1": ((1, 1), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
TRAIN = ShapeConfig("t", 32, 16, "train")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **kw):
    return dataclasses.replace(get_arch(name), **kw)


def test_tiny_list_is_every_tiny_arch():
    from repro_torch.config import list_archs

    assert sorted(TINY) == [n for n in list_archs(include_tiny=True) if n.startswith("tiny-")]


@pytest.mark.parametrize("name", TINY)
def test_train_flops_at_least_6nd_on_every_mesh(name, monkeypatch):
    """A train step counts at least 6·N·tokens, N the params a token meets
    (every param of a dense model; the MoE's active ones)."""
    cfg = get_arch(name)
    monkeypatch.setitem(LM_SHAPES, "t", TRAIN)
    n = Model(cfg).num_params() if cfg.moe is None else cfg.active_param_count()
    for key, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes)
        r = dryrun.run_cell(name, "t", False, mesh=mesh, policy_override=ShardingPolicy())
        assert r["status"] == "ok" and r["mesh"] == key and r["chips"] == mesh.size
        assert r["hlo_flops"] * mesh.size >= 6 * n * TRAIN.global_batch * TRAIN.seq_len, key
        if cfg.family != "ssm":  # repro's analytic model, attention included
            assert r["hlo_flops"] * mesh.size >= r["model_flops_total"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["tiny-granite", "tiny-mixtral"])
def test_two_point_over_depth_equals_the_direct_count(name, kind):
    """A stack of like layers: two_point of depth 1 and 2 gives depth 4's
    FLOPs and activations (a train step's bytes carry a depth-squared term:
    each layer's select of a stacked leaf writes a grad of the whole)."""
    cfg = _cfg(name, num_layers=4)
    shape = ShapeConfig("t", 16, 4, kind)
    one, two = (dryrun.count_step(Model(reduced_arch(cfg, k)), shape) for k in (1, 2))
    direct = dryrun.count_step(Model(cfg), shape)
    got = two_point(one, two, 4)
    keys = ("flops", "activations") if kind == "train" else ("flops", "activations", "bytes")
    for k in keys:
        assert got[k] == pytest.approx(direct[k], rel=1e-12), k


@pytest.mark.parametrize("name,kind", [("tiny-xlstm", "train"), ("tiny-hymba", "prefill")])
def test_time_loop_extrapolation_equals_the_direct_count(name, kind, monkeypatch):
    cfg = _cfg(name, num_layers=2)  # tiny-xlstm: one mLSTM and one sLSTM layer
    shape = ShapeConfig("t", 64 if kind == "train" else 256, 2, kind)
    direct = dryrun.count_step(Model(cfg), shape)
    monkeypatch.setattr(dryrun, "MAX_DIRECT_STEPS", 0)
    got, how = dryrun.count(cfg, shape)
    assert how.startswith("time loop")
    for k in direct:
        assert got[k] == pytest.approx(direct[k], rel=1e-9), k


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-mixtral", "tiny-xlstm"])
def test_state_bytes_a_device_are_the_spec_trees(name, mesh_key):
    cfg = get_arch(name)
    model = Model(cfg)
    mesh = make_mesh(*MESHES[mesh_key])
    parts = dryrun.memory_parts(model, TRAIN, mesh, ShardingPolicy(), 0.0)
    sizes = mesh.axis_sizes
    # each leaf at its local shape: every dim over the axes its spec names
    from repro_torch.launch.specs import train_state_specs
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding.rules import P

    want = 0.0
    specs = tree_leaves(state_specs(model, mesh, ShardingPolicy()),
                        is_leaf=lambda x: isinstance(x, P))
    for t, spec in zip(tensor_leaves(train_state_specs(model)), specs, strict=True):
        local = list(t.shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    local[i] /= sizes[a]
        want += np.prod(local) * t.element_size()
    assert parts["state"] == pytest.approx(want)
    grads = sum(t.numel() * t.element_size() for t in tensor_leaves(model.abstract()))
    assert parts["grads"] <= grads


@pytest.mark.parametrize("d", [2, 4])
def test_state_bytes_match_a_state_cut_by_its_placement(d):
    cfg = dataclasses.replace(get_arch("tiny-gemma3"), param_dtype="float32",
                              compute_dtype="float32")
    model = Model(cfg)
    mesh = make_mesh((d, 1), ("data", "model"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(params, adamw_init(params))
    sspecs = state_specs(model, mesh, ShardingPolicy())
    held = sum(t.numel() * t.element_size() for t in tensor_leaves(
        placement(sspecs, mesh, Ranks(rank=d - 1, size=d)).shard(state)))
    parts = dryrun.memory_parts(model, TRAIN, mesh, ShardingPolicy(), 0.0)
    assert parts["state"] == pytest.approx(held)


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-mixtral", "tiny-hymba"])
def test_saved_activations_order_by_remat(name):
    got = {remat: dryrun.count_step(Model(_cfg(name, remat=remat)), TRAIN)
           for remat in ("nothing_saveable", "dots_saveable", "none")}
    acts = [got[r]["activations"] for r in ("nothing_saveable", "dots_saveable", "none")]
    assert 0 < acts[0] < acts[1] < acts[2], acts
    # remat recomputes the forward: more FLOPs, none without it
    assert got["nothing_saveable"]["flops"] > got["none"]["flops"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_sa_dryrun_is_the_ports_plan(multi_pod):
    r = dryrun.run_sa_dryrun(multi_pod)
    d = 512 if multi_pod else 256
    cfg = SAConfig(vocab_size=4, packing="base", samples_per_shard=1024, adaptive=False)
    info = plan((2048 * d, 200), cfg, d)
    assert r["rows_per_shard"] == info["rows_per_shard"] == 2048
    assert r["records_per_shard"] == info["n_local"] == 2048 * 201
    assert r["record_bytes_per_shard"] == info["n_local"] * 16
    assert r["shuffle_cap"] == info["shuffle_cap"]
    assert r["shuffle_bytes_per_shard"] == d * info["shuffle_cap"] * 16
    fcap = fetch_capacity(info["shuffle_cap"], cfg, d)
    assert r["fetch_round_bytes_per_shard"] == {"requests": d * fcap * 8,
                                               "responses": d * fcap * 12}
    assert r["mesh"] == ("512flat" if multi_pod else "256flat")
    assert r["shape"] == f"reads{2048 * d}x200"


def test_expert_counts_equal_bincount():
    rng = np.random.default_rng(3)
    for e in (1, 4, 8, 64):
        expert = torch.from_numpy(rng.integers(0, e, size=(1000,)))
        got = layers.expert_counts(expert, e)
        assert torch.equal(got, torch.bincount(expert, minlength=e))
    meta = layers.expert_counts(torch.empty(10, dtype=torch.int64, device="meta"), 8)
    assert meta.shape == (8,) and meta.device.type == "meta"


def test_run_cell_records(tmp_path):
    r = dryrun.run_cell("tiny-gemma3", "decode_32k", False)
    assert r["status"] == "ok" and r["chips"] == 256 and r["mesh"] == "16x16"
    assert r["peak_memory_bytes"] == pytest.approx(sum(r["memory"].values()))
    assert set(r["memory"]) == {"params", "cache", "logits"}
    assert r["collective"]["total"] == sum(v for k, v in r["collective"].items()
                                           if k != "total")
    assert "tensor-parallel" in r["collective_omits"]
    r = dryrun.run_cell("tiny-gemma3", "train_4k", True)
    assert r["mesh"] == "2x16x16" and r["chips"] == 512
    assert set(r["memory"]) == {"state", "grads", "activations", "logits"}
    assert r["collective"]["reduce-scatter"] > 0
    skipped = dryrun.run_cell("tiny-granite", "long_500k", False)
    assert skipped["status"] == "skipped"
    assert not ref_long_context(ref_arch("tiny-granite"))
    c = dryrun.run_cell_corrected("tiny-xlstm", "decode_32k")
    assert c["correction"] == "xlstm-analytic-flops" and c["hlo_flops_analytic"] > 0


def test_collective_bytes_from_the_spec_trees():
    """On (16, 16) every leaf with an embed dim of d_model % 16 == 0 is
    gathered in the compute dtype (twice under remat) and its grad
    reduce-scattered; the others' grads all-reduced."""
    cfg = get_arch("tiny-gemma3")
    model = Model(cfg)
    mesh = make_mesh((4, 1), ("data", "model"))
    got = dryrun.spec_collective_bytes(model, mesh, ShardingPolicy(), "train")
    whole = model.abstract()
    dims = placement(state_specs(model, mesh, ShardingPolicy()), mesh,
                     Ranks(rank=0, size=4)).dims
    cut = [t for t, dim in zip(tensor_leaves(whole), dims, strict=False) if dim is not None]
    rest = [t for t, dim in zip(tensor_leaves(whole), dims, strict=False) if dim is None]
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    assert got["all-gather"] == 2 * nb(cut) // 4
    assert got["reduce-scatter"] == nb(cut)
    assert got["all-reduce"] == nb(rest)
    none = dryrun.spec_collective_bytes(Model(_cfg("tiny-gemma3", remat="none")), mesh,
                                        ShardingPolicy(), "train")
    assert none["all-gather"] == nb(cut) // 4
    one = dryrun.spec_collective_bytes(model, make_mesh((1, 1), ("data", "model")),
                                       ShardingPolicy(), "train")
    assert one == {"total": 0}


def test_main_resumes_by_key(tmp_path, capsys):
    out = str(tmp_path / "d.json")
    dryrun.main(["--sa", "--mesh", "single", "--out", out])
    dryrun.main(["--arch", "tiny-gemma3", "--shape", "decode_32k", "--mesh", "both",
                 "--out", out])
    with open(out) as f:
        recs = json.load(f)
    assert [(r["arch"], r["mesh"]) for r in recs] == [
        ("suffix-array-pipeline", "256flat"), ("tiny-gemma3", "16x16"),
        ("tiny-gemma3", "2x16x16")]
    dryrun.main(["--arch", "tiny-gemma3", "--shape", "decode_32k", "--out", out])
    with open(out) as f:
        assert len(json.load(f)) == 3  # done cells are not counted again
    assert capsys.readouterr().out.count('"status": "ok"') == 3


def test_perf_runs_a_registry_entry(tmp_path, monkeypatch, capsys):
    assert set(perf.EXPERIMENTS) >= {"mixtral-train-base", "hymba-train-dots-remat",
                                     "gemma3-train-opt"}
    monkeypatch.setitem(perf.EXPERIMENTS, "tiny-decode",
                        ("tiny-mixtral", "decode_32k", perf._cfg(window_decode_cache=True),
                         perf._REPL))
    out = str(tmp_path / "p.json")
    perf.main(["--exp", "tiny-decode", "--out", out])
    with open(out) as f:
        (rec,) = json.load(f)
    assert rec["exp"] == "tiny-decode" and rec["status"] == "ok"
    assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_registry_is_repros(monkeypatch):
    # repro.launch.perf's first statements set XLA_FLAGS to 512 fake devices:
    # undo that after the import, or every jax subprocess this worker starts
    # later inherits it
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.perf import EXPERIMENTS as REF

    assert list(perf.EXPERIMENTS) == list(REF)
    for name, (arch, shape, cfg_ov, pol_ov) in REF.items():
        a, s, c, p = perf.EXPERIMENTS[name]
        assert (a, s) == (arch, shape)
        if cfg_ov is not None:
            assert dataclasses.asdict(c(get_arch(a))) == dataclasses.asdict(cfg_ov(ref_arch(a)))
        assert (p is None) == (pol_ov is None)
        if p is not None:
            assert dataclasses.asdict(p) == dataclasses.asdict(pol_ov)


def test_train_launcher_dry_run(capsys):
    lm_train.main(["--arch", "tiny-minicpm", "--shape", "prefill_32k", "--dry-run"])
    line = capsys.readouterr().out.strip()
    rec = eval(line, {})  # noqa: S307  (the launcher prints a dict's repr)
    assert set(rec) == {"arch", "shape", "status", "bottleneck", "roofline_fraction"}
    assert rec["status"] == "ok" and rec["shape"] == "prefill_32k"


def test_meshes():
    assert mesh_lib.make_production_mesh().shape == (16, 16)
    m = mesh_lib.make_production_mesh(multi_pod=True)
    assert m.shape == (2, 16, 16) and m.axis_names == ("pod", "data", "model")
    assert mesh_lib.make_sa_mesh(8).axis_names == ("sa",)
    assert mesh_lib.make_sa_mesh().size == 1
    assert mesh_lib.make_local_mesh().shape == (1, 1)
    with pytest.raises(ValueError):
        mesh_lib.make_local_mesh((2, 1))


def test_shapes_are_repros():
    from repro.config import LM_SHAPES as REF

    assert {k: dataclasses.asdict(v) for k, v in LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF.items()}
