"""The port's arch registry and its shape, mesh, sharding, training and
serving configs, full-width shapes, parameter init, engine
schedule, launcher and example against ``repro``'s, on the CPU: every
registered config field for field, and the ten full configs' parameter and
cache shapes on the ``meta`` device (nothing allocated); and the LM path on
the embeddings-mode archs (tiny-musicgen: GeLU; tiny-internvl2: GQA), cases
and tolerances in ``tests/_torch_lm_cases.py``."""
import dataclasses
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_cases import cases, check, one_torch_thread, ref_jit, ref_key  # noqa: F401
from repro import config as ref_config
from repro.configs import suffix_array as ref_sa
from repro.models.model import Model as RefModel
from repro_torch import config
from repro_torch.config import get_arch, list_archs
from repro_torch.configs import suffix_array
from repro_torch.models.model import Model, params_from_reference
from repro_torch.models.params import tree_leaves
from repro_torch.serve.engine import Request, ServeEngine, schedule_steps

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = ref_config.list_archs()
ALL = ref_config.list_archs(include_tiny=True)


@pytest.mark.parametrize("name,what", cases(("tiny-musicgen", "tiny-internvl2")),
                         ids=lambda v: str(v))
def test_port_matches_repro(name, what):
    check(name, what)


def test_registry_lists_the_same_archs():
    assert list_archs() == FULL and len(FULL) == 10
    assert list_archs(include_tiny=True) == ALL and len(ALL) == 19
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("cls", ["AttentionConfig", "MoEConfig", "SSMConfig", "ArchConfig",
                                 "ShapeConfig", "MeshConfig", "ShardingPolicy",
                                 "TrainConfig", "ServeConfig"])
def test_arch_dataclasses_have_repros_fields_and_defaults(cls):
    ref = [(f.name, f.default) for f in dataclasses.fields(getattr(ref_config, cls))]
    port = [(f.name, f.default) for f in dataclasses.fields(getattr(config, cls))]
    assert port == ref


def test_shapes_and_mesh_config_match_repro():
    assert {k: dataclasses.asdict(v) for k, v in config.LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_config.LM_SHAPES.items()}
    for shape, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                         ((8,), ("model",))):
        got, want = config.MeshConfig(shape, names), ref_config.MeshConfig(shape, names)
        assert (got.num_devices, got.data_axes, got.model_axes) == \
            (want.num_devices, want.data_axes, want.model_axes)


@pytest.mark.parametrize("name", ALL)
def test_config_matches_repro_field_for_field(name):
    ref, port = ref_config.get_arch(name), get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    a, ra = port.attention, ref.attention
    if a is not None:
        assert port.qkv_dims() == ref.qkv_dims()
        for seq in (8, 4096):
            assert [a.window_for_layer(i, seq) for i in range(port.num_layers)] == \
                [ra.window_for_layer(i, seq) for i in range(ref.num_layers)]
        assert [a.is_global_layer(i) for i in range(port.num_layers)] == \
            [ra.is_global_layer(i) for i in range(ref.num_layers)]


def test_suffix_array_workloads_match_repro():
    for fn in ("grouper_genome", "grouper_small", "grouper_out_of_core"):
        assert dataclasses.asdict(getattr(suffix_array, fn)()) == \
            dataclasses.asdict(getattr(ref_sa, fn)())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (tuple, list)) and tree and not isinstance(tree[0], (str, type(None))):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", FULL)
def test_full_width_parameters_and_caches_on_meta(name):
    """Parameter names, shapes, dtypes and logical axes, ``num_params`` and
    the cache shapes (full and windowed) equal ``repro``'s at full width,
    with every tensor on ``meta``."""
    ref, port = RefModel(ref_config.get_arch(name)), Model(get_arch(name))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(ref.abstract()).items()}
    got = {k: _shape_dtype(v) for k, v in _flat(port.abstract()).items()}
    assert got == want
    named = dict(port.named_parameters())
    assert {k: _shape_dtype(v) for k, v in named.items()} == want
    assert all(v.is_meta for v in named.values())
    assert port.num_params() == ref.num_params()
    assert _flat(port.axes()) == {k: tuple(v) for k, v in _flat(ref.axes()).items()}
    variants = [ref.cfg]
    if ref.cfg.attention is not None and ref.cfg.family != "ssm":
        variants.append(dataclasses.replace(ref.cfg, window_decode_cache=True))
    for cfg in variants:
        rc = RefModel(cfg).abstract_cache(2, 4096)
        pc = Model(get_arch(name) if cfg is ref.cfg else
                   dataclasses.replace(get_arch(name), window_decode_cache=True)
                   ).abstract_cache(2, 4096)
        assert {k: _shape_dtype(v) for k, v in _flat(pc).items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(rc).items()}
        assert all(v.is_meta for v in tree_leaves(pc))


def test_init_draws_repros_distributions():
    """normal x 0.02, ones, zeros and scaled = N(0,1)/sqrt(shape[0]): a
    stacked weight's fan_in is the layer count, in both packages; drawn
    directly in the target dtype."""
    cfg = dataclasses.replace(get_arch("tiny-hymba"), num_layers=4)
    port = Model(cfg)
    p = port.init(torch.Generator().manual_seed(0), device="cpu")
    ref_cfg = dataclasses.replace(ref_config.get_arch("tiny-hymba"), num_layers=4)
    ref = ref_jit(RefModel(ref_cfg).init)(ref_key(0))
    assert p["embed"].dtype == torch.bfloat16
    for path, want in (("embed", 0.02), ("blocks.attn.wq", 0.5),
                       ("blocks.mamba.w_out", 0.5)):
        got = _flat(p)[path].float().std().item()
        assert abs(got - want) < 0.1 * want, path
        rstd = float(jnp.std(_flat(ref)[path].astype(jnp.float32)))
        assert abs(rstd - want) < 0.1 * want, path
    assert bool((p["blocks"]["ln_attn"]["scale"] == 1).all())
    assert bool((p["blocks"]["mamba"]["a_log"] == 0).all())


def test_engine_retires_each_request_when_its_lengths_say():
    """Eight requests of 1-6 prompt tokens over three slots: each request
    retires at the step ``schedule_steps`` computes from the lengths."""
    model = Model(get_arch("tiny-gemma3"))
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    lens, new = [3, 1, 6, 2, 5, 4, 1, 2], [2, 4, 1, 3, 2, 1, 5, 2]
    eng = ServeEngine(model, params, batch_slots=3, max_seq=32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, 256, n).tolist(), max_new=m)
            for i, (n, m) in enumerate(zip(lens, new, strict=True))]
    for r in reqs:
        eng.submit(r)
    retired = {}
    while eng.step() or eng.queue:
        retired.update((r.rid, eng.steps) for r in reqs if r.done and r.rid not in retired)
    retired.update((r.rid, eng.steps) for r in reqs if r.done and r.rid not in retired)
    assert [retired[i] for i in range(8)] == schedule_steps(lens, new, 3)
    assert eng.steps == max(schedule_steps(lens, new, 3))
    assert [len(r.generated) for r in reqs] == new


def test_lm_entry_points_without_cuda_raise():
    from repro_torch.launch import lm_serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = Model(get_arch("tiny-gemma3"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, model.params(), batch_slots=2, max_seq=8)
    zeros = {k: np.zeros(v.shape, np.float32) for k, v in _flat(model.abstract()).items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(model, _nest(zeros))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_serve.main(["--arch", "tiny-gemma3"])


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.mark.parametrize("name", ["tiny-granite", "tiny-xlstm"])
def test_lm_serve_prints_repros_lines(capsys, name):
    """The ``arch=... params=...M`` line is the one ``repro.launch.lm_serve``
    prints (``src/repro/launch/lm_serve.py:40``, from ``repro``'s model);
    the other lines have its form (walls and samples differ)."""
    from repro_torch.launch import lm_serve

    lm_serve.main(["--arch", name, "--batch", "2", "--prompt-len", "5", "--gen", "3",
                   "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    cfg = ref_config.get_arch(name)
    assert lines[0] == f"arch={cfg.name} params={RefModel(cfg).num_params() / 1e6:.1f}M"
    forms = [r"prefill: [0-9.]+s \(2x5 tokens\)",
             r"decode: 3 steps in [0-9.]+s \([0-9.]+ tok/s batched\)",
             r"sample: \[\d+, \d+, \d+\]"]
    assert len(lines) == 4
    for form, line in zip(forms, lines[1:], strict=True):
        assert re.fullmatch(form, line), line


def test_serve_lm_example_decodes_as_the_forward(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["torch_serve_lm.py", "--device", "cpu"])
    runpy.run_path(os.path.join(REPO, "examples", "torch_serve_lm.py"), run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    want = RefModel(ref_config.get_arch("tiny-gemma3")).num_params()
    assert lines[0] == f"serving tiny-gemma3: {want / 1e3:.0f}K params"
    assert [ln.split(" generated=")[0] for ln in lines[1:4]] == [
        "seq0: prompt_len=5", "seq1: prompt_len=9", "seq2: prompt_len=3"]
    assert lines[-1] == "decode == teacher-forced forward: True"
