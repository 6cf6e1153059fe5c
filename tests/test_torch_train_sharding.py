"""The port's sharding rules and input specs against ``repro``'s, entry for
entry, on the CPU: ``param_specs``, ``batch_specs`` (train, prefill and
decode, batches that divide the data axes and ones that do not),
``cache_specs`` over each arch's abstract cache (stacked, windowed and
recurrent layouts, with and without ``long_context``) and ``state_specs``,
for every registered config on (1, 1), (16, 16) and (2, 16, 16) meshes under
the perf launcher's policies (``src/repro/launch/perf.py:30-32``) and
``ShardingPolicy(embed_fsdp=False)``; ``input_specs``,
``train_state_specs`` and ``long_context_supported`` for every config and
shape.

``repro``'s rules read only ``mesh.axis_names`` and ``mesh.devices.shape``,
so ``repro`` gets a stand-in with those two attributes (no 256 XLA devices);
the port gets its ``sharding.Mesh``.  Specs compare as tuples:
``PartitionSpec`` and the port's ``P`` both hold a one-name tuple as the
name."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_map_with_path

from repro import config as ref_config
from repro.launch import specs as ref_specs
from repro.models.model import Model as RefModel
from repro.sharding import rules as ref_rules
from repro.train.step import state_specs as ref_state_specs
from repro_torch import config
from repro_torch.launch import specs
from repro_torch.models.model import Model
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, make_mesh
from repro_torch.train.step import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
    state_specs,
)

ALL = ref_config.list_archs(include_tiny=True)
MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
POLICIES = {"fsdp": {}, "replicated": {"fsdp_axes": ()}, "ep": {"moe_ep": True},
            "no-embed-fsdp": {"embed_fsdp": False}}
BATCHES = (1, 2, 7, 32, 128, 256, 512)


def _stand_in(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))


def _flat(tree, prefix=""):
    """{path: spec as a tuple} of a tree of dicts, tuples and specs."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}.{k}"))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, P) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree, strict=True):
            out.update(_flat(v, f"{prefix}.{f}"))
        return out
    return {prefix: tuple(tree)}


def _ref_cache_specs(model, cspec, batch, max_seq):
    out = []
    tree_map_with_path(lambda p, x: out.append(tuple(cspec(keystr(p), x))),
                       model.abstract_cache(batch, max_seq))
    return out


def _port_cache_specs(model, cspec, batch, max_seq):
    out = rules.keystr_map(cspec, model.abstract_cache(batch, max_seq))
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, P):
            leaves.append(tuple(t))
        else:
            for x in t:
                walk(x)

    walk(out)
    return leaves


@pytest.mark.parametrize("name", ALL)
def test_specs_match_repro_on_every_mesh_and_policy(name):
    ref_model, model = RefModel(ref_config.get_arch(name)), Model(config.get_arch(name))
    cfg, rcfg = model.cfg, ref_model.cfg
    for shape, names in MESHES:
        ref_mesh, mesh = _stand_in(shape, names), make_mesh(shape, names)
        for kw in POLICIES.values():
            rpol, pol = ref_config.ShardingPolicy(**kw), config.ShardingPolicy(**kw)
            assert _flat(rules.param_specs(model, mesh, pol)) == \
                _flat(jax.tree.map(tuple, ref_rules.param_specs(ref_model, ref_mesh, rpol)))
            assert _flat(state_specs(model, mesh, pol)) == _flat(jax.tree.map(
                tuple, ref_state_specs(ref_model, ref_mesh, rpol)))
            for b in BATCHES:
                for kind in ("train", "prefill", "decode"):
                    assert _flat(rules.batch_specs(cfg, mesh, pol, b, kind)) == \
                        _flat(jax.tree.map(tuple, ref_rules.batch_specs(
                            rcfg, ref_mesh, rpol, b, kind)))
            for b, max_seq, long in ((128, 4096, False), (7, 100, False), (1, 4096, True)):
                got = _port_cache_specs(model, rules.cache_specs(cfg, mesh, pol, b, long),
                                        b, max_seq)
                want = _ref_cache_specs(ref_model, ref_rules.cache_specs(
                    rcfg, ref_mesh, rpol, b, long), b, max_seq)
                assert got == want and got


def test_resolve_axes_falls_back_as_repro_does():
    mesh, ref_mesh = make_mesh((1, 1), ("data", "model")), _stand_in((1, 1), ("data", "model"))
    assert rules.resolve_axes(("embed", "mlp"), (64, 256), mesh,
                              config.ShardingPolicy()) == P(None, None)
    big, ref_big = make_mesh((16, 16), ("data", "model")), _stand_in((16, 16), ("data", "model"))
    for axes, shape in ((("embed", "q_proj"), (1600, 1600)), (("embed", "q_proj"), (1600, 25)),
                        (("experts", "embed", "expert_mlp"), (8, 4096, 14336)),
                        (("vocab", "embed"), (32000, 4096)), (("layers", "embed"), (4, 48))):
        for pol in (config.ShardingPolicy(), config.ShardingPolicy(moe_ep=True)):
            rp = ref_config.ShardingPolicy(**dataclasses.asdict(pol))
            assert tuple(rules.resolve_axes(axes, shape, big, pol)) == \
                tuple(ref_rules.resolve_axes(axes, shape, ref_big, rp))
    assert ref_mesh.devices.shape == mesh.shape
    assert repr(P(("data",), None, ("pod", "data"))) == "P('data', None, ('pod', 'data'))"
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",))


def test_step_factories_return_repros_specs():
    """make_train_step / make_prefill_step / make_decode_step's spec trees on
    a (1, 1) mesh are repro's shardings' specs; a larger mesh needs as many
    ranks of a process group, so one process is refused by the train step."""
    name = "tiny-hymba"
    model, ref_model = Model(config.get_arch(name)), RefModel(ref_config.get_arch(name))
    mesh, ref_mesh = make_mesh((1, 1), ("data", "model")), _stand_in((1, 1), ("data", "model"))
    pol, rpol = config.ShardingPolicy(), ref_config.ShardingPolicy()
    _, ssh, bsh = make_train_step(model, mesh, pol, config.TrainConfig(), 4, 16,
                                  with_mask=True)
    assert _flat(ssh) == _flat(jax.tree.map(tuple, ref_state_specs(ref_model, ref_mesh, rpol)))
    want_b = dict(ref_rules.batch_specs(ref_model.cfg, ref_mesh, rpol, 4, "train"))
    want_b["mask"] = want_b["labels"]
    assert _flat(bsh) == _flat(jax.tree.map(tuple, want_b))
    _, psh, ibsh = make_prefill_step(model, mesh, pol, 4, 16)
    want_p = ref_rules.batch_specs(ref_model.cfg, ref_mesh, rpol, 4, "prefill")
    assert _flat(ibsh) == {".tokens": tuple(want_p["tokens"])} == {".tokens": ("data", None)}
    _, psh2, csh, (tsh, possh) = make_decode_step(model, mesh, pol, 4, 32)
    assert _flat(psh) == _flat(psh2) == _flat(rules.param_specs(model, mesh, pol))
    want_d = ref_rules.batch_specs(ref_model.cfg, ref_mesh, rpol, 4, "decode")
    assert (tuple(tsh), tuple(possh)) == (tuple(want_d["tokens"]), tuple(want_d["pos"]))
    assert sorted(csh) == ["conv", "k", "ssm", "v"]
    assert [tuple(csh[k]) for k in sorted(csh)] == _ref_cache_specs(
        ref_model, ref_rules.cache_specs(ref_model.cfg, ref_mesh, rpol, 4), 4, 32)
    # the prefill and decode steps are the model's methods, without autograd
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    pre = make_prefill_step(model, mesh, pol, 2, 8, max_seq=12)[0]
    toks = torch.arange(16, dtype=torch.int32).reshape(2, 8) % model.cfg.vocab_size
    logits, cache = pre(params, {"tokens": toks})
    want_l, want_c = model.prefill(params, tokens=toks, max_seq=12)
    assert torch.equal(logits, want_l) and not logits.requires_grad
    dec = make_decode_step(model, mesh, pol, 2, 12)[0]
    pos = torch.full((2,), 8, dtype=torch.int32)
    got_d, _ = dec(params, cache, toks[:, :1], pos)
    assert torch.equal(got_d, model.decode_step(params, want_c, toks[:, :1], pos)[0])
    with pytest.raises(ValueError, match="over 1 rank"):
        make_train_step(model, make_mesh((2, 1), ("data", "model")), pol,
                        config.TrainConfig(), 4, 16)


def _meta(t):
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."))


def _ref_meta(s):
    return (tuple(s.shape), str(s.dtype))


@pytest.mark.parametrize("name", ALL)
def test_input_and_state_specs_match_repro(name):
    cfg, rcfg = config.get_arch(name), ref_config.get_arch(name)
    assert config.LM_SHAPES.keys() == ref_config.LM_SHAPES.keys()
    for key, shape in config.LM_SHAPES.items():
        got = specs.input_specs(cfg, shape)
        want = ref_specs.input_specs(rcfg, ref_config.LM_SHAPES[key])
        assert all(t.is_meta for t in got.values())
        assert {k: _meta(t) for k, t in got.items()} == {k: _ref_meta(s) for k, s in want.items()}
    assert specs.long_context_supported(cfg) == ref_specs.long_context_supported(rcfg)
    st = specs.train_state_specs(Model(cfg))
    rst = ref_specs.train_state_specs(RefModel(rcfg))
    got = [_meta(t) for t in jax.tree.leaves(st)]
    assert got == [_ref_meta(s) for s in jax.tree.leaves(rst)]
    assert all(t.is_meta for t in jax.tree.leaves(st))
    assert torch.int32 in {t.dtype for t in jax.tree.leaves(st.opt)}
