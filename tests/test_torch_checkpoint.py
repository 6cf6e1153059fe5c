"""The port's checkpoints against ``repro``'s on the CPU: the same files,
byte for byte, in both directions.  ``repro`` writes a ``TrainState``
(bfloat16 params, float32 master and moments, an int32 step) and the port
reads every leaf bit for bit, ``extra`` included; the port writes the same
state and every ``arr_<i>.bin`` and ``meta.msgpack`` equals ``repro``'s
bytes, and ``repro`` reads it back bit for bit.  The port's MessagePack
codec gives ``msgpack.packb``'s bytes and ``msgpack.unpackb``'s values, and
the port checkpoints in a process where ``msgpack`` and ``ml_dtypes`` cannot
be imported.  Also: pruning, the ``.tmp`` publish, restore errors, restore
onto a device from ``meta`` targets, a snapshot taken before later in-place
writes, and the NamedTuple-aware tree map."""
import os
import subprocess
import sys
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.train.step import TrainState as RefTrainState
from repro_torch.checkpoint import msgpack_codec
from repro_torch.checkpoint.manager import CheckpointManager, treedef_repr
from repro_torch.models.params import tensor_leaves, tensor_map, tree_map
from repro_torch.train.step import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -1.5, 1e300, float("inf"), True, False, None,
    "", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 40000, "ünïcode",
    [], list(range(15)), list(range(16)), list(range(70000)), (1, "t"),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {f"k{i}": [i] for i in range(70000)},
    {"step": 12, "treedef": '"PyTreeDef({})"', "shapes": [[3, 4], []],
     "dtypes": ["bfloat16", "int32"], "extra": {"step": 12, "lr": 3e-4, "ok": True}},
]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_codec_matches_msgpack(i):
    v = VALUES[i]
    packed = msgpack_codec.packb(v)
    assert packed == msgpack.packb(v)
    want = msgpack.unpackb(packed)
    got = msgpack_codec.unpackb(packed)
    assert got == want and type(got) is type(want)


def test_codec_refuses_what_msgpack_refuses():
    for bad in (np.int64(3), np.float32(1.0), {1: 2}.keys(), object()):
        with pytest.raises(TypeError):
            msgpack.packb(bad)
        with pytest.raises(TypeError):
            msgpack_codec.packb(bad)
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack.packb({1: 2}))  # strict map keys, as unpackb
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack.packb([1, 2])[:-1])
    for bad in (msgpack.packb(b"raw"), msgpack.packb(1.5, use_single_float=True)):
        with pytest.raises(ValueError, match="unsupported"):  # types meta never holds
            msgpack_codec.unpackb(bad)


def _ref_state(seed=0):
    """A repro TrainState: bfloat16 params (two levels), float32 opt, int32
    step."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    master = {"blocks": {"w": f32(2, 3, 4), "b": f32(2, 4)}, "embed": f32(6, 4)}
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), master)
    opt = {"step": jnp.int32(41), "master": jax.tree.map(jnp.asarray, master),
           "m": jax.tree.map(lambda a: jnp.asarray(0.1 * a), master),
           "v": jax.tree.map(lambda a: jnp.asarray(a * a), master)}
    return RefTrainState(params, opt)


def _port_like(ref):
    """The port's TrainState with ``ref``'s values (bf16 as its bits)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return TrainState(*jax.tree.map(conv, tuple(ref)))


def _zeros_like(state):
    return tensor_map(torch.zeros_like, state)


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().tobytes()
    a = np.asarray(t)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _files(path):
    return {n: _read(os.path.join(path, n)) for n in sorted(os.listdir(path))}


def test_repro_checkpoint_reads_in_the_port_bit_for_bit(tmp_path):
    ref = _ref_state()
    RefManager(str(tmp_path)).save(41, ref, extra={"step": 41, "note": "x"}, blocking=True)
    got, extra = CheckpointManager(str(tmp_path)).restore(_zeros_like(_port_like(ref)))
    assert isinstance(got, TrainState) and extra == {"step": 41, "note": "x"}
    assert [t.dtype for t in tensor_leaves(got.params)] == [torch.bfloat16] * 3
    assert got.opt["step"].dtype == torch.int32 and got.opt["step"].shape == ()
    want = jax.tree.leaves(ref)
    assert len(tensor_leaves(got)) == len(want) == 13
    for g, w in zip(tensor_leaves(got), want, strict=True):
        assert tuple(g.shape) == w.shape and _bits(g) == _bits(w)


def test_port_checkpoint_is_repros_bytes_and_reads_in_repro(tmp_path):
    ref = _ref_state(1)
    RefManager(str(tmp_path / "repro")).save(7, ref, extra={"step": 7}, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(7, _port_like(ref), extra={"step": 7},
                                                   blocking=True)
    want = _files(tmp_path / "repro" / "step_00000007")
    got = _files(tmp_path / "port" / "step_00000007")
    assert sorted(got) == sorted(want) == sorted(
        [f"arr_{i}.bin" for i in range(13)] + ["meta.msgpack"])
    assert got == want  # every leaf's bytes and the metadata, treedef included
    meta = msgpack.unpackb(got["meta.msgpack"])
    assert meta["dtypes"][:3] == ["bfloat16"] * 3 and meta["shapes"][:3] == [[2, 4], [2, 3, 4],
                                                                           [6, 4]]
    assert meta["dtypes"][9] == "int32" and meta["shapes"][9] == [] and len(got["arr_9.bin"]) == 4
    back, extra = RefManager(str(tmp_path / "port")).restore(ref)
    assert extra == {"step": 7}
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(ref), strict=True):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


@pytest.mark.parametrize("tree", [
    {"b": {"x": 0, "a": 0}, "a": 0},
    {"a": (0,), "b": (0, 0), "c": (), "d": {}},
    {"layer_00": (0, 0, 0), "layer_01": (0, 0, 0, 0)},
    RefTrainState({"w": 0, "b": {"c": 0}}, {"step": 0, "m": {"w": 0}}),
    0,
], ids=["dict", "containers", "lstm-state", "train-state", "leaf"])
def test_treedef_repr_is_jaxs(tree):
    class TrainState(NamedTuple):  # the port's name, a type of its own
        params: Any
        opt: Any

    port_tree = TrainState(*tree) if isinstance(tree, RefTrainState) else tree
    assert treedef_repr(port_tree) == repr(jax.tree.structure(tree))


def test_checkpoints_without_msgpack_or_ml_dtypes(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint.manager import CheckpointManager\n"
        "from repro_torch.checkpoint.msgpack_codec import unpackb\n"
        "t = {'a': torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16),\n"
        "     'b': {'s': torch.tensor(5, dtype=torch.int32)}}\n"
        f"m = CheckpointManager({str(tmp_path)!r})\n"
        "m.save(3, t, extra={'step': 3}, blocking=True)\n"
        "z = {'a': torch.empty(2, 3, dtype=torch.bfloat16, device='meta'),\n"
        "     'b': {'s': torch.empty((), dtype=torch.int32, device='meta')}}\n"
        "out, extra = m.restore(z, device='cpu')\n"
        "assert extra == {'step': 3} and torch.equal(out['a'], t['a'])\n"
        "assert out['b']['s'].dtype == torch.int32 and int(out['b']['s']) == 5\n"
        "for name in ('msgpack', 'ml_dtypes', 'jax', 'repro'):\n"
        "    assert sys.modules.get(name) is None, name\n"
        "try:\n"
        "    import msgpack\n"
        "except ImportError:\n"
        "    print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
    meta = msgpack.unpackb(_read(tmp_path / "step_00000003" / "meta.msgpack"))
    assert meta["dtypes"] == ["bfloat16", "int32"] and meta["shapes"] == [[2, 3], []]


def test_prune_publish_and_restore_errors(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(tree)
    for s in (10, 20, 30):
        mgr.save(s, tree, extra={"step": s}, blocking=True)
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    (tmp_path / "step_00000099.tmp").mkdir()
    assert mgr.all_steps() == [20, 30]
    out, extra = mgr.restore(tree, step=20)
    assert extra == {"step": 20} and torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="structure"):
        mgr.restore({"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(4, 3), "b": tree["b"]})
    meta_tree = tensor_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    with pytest.raises(ValueError, match="device"):
        mgr.restore(meta_tree)
    out, _ = mgr.restore(meta_tree, device="cpu")
    assert out["a"].device.type == "cpu" and torch.equal(out["a"], tree["a"])


def test_save_snapshots_before_later_in_place_writes(tmp_path):
    t = {"w": torch.zeros(1000)}
    mgr = CheckpointManager(str(tmp_path))
    fut = mgr.save(1, t)
    t["w"].fill_(7.0)  # the caller goes on (a donated step writes in place)
    fut.result()
    out, _ = mgr.restore({"w": torch.empty(1000)})
    assert torch.equal(out["w"], torch.zeros(1000))


def test_tree_map_keeps_namedtuples():
    st = TrainState({"b": torch.ones(2), "a": torch.zeros(1)},
                    {"step": torch.tensor(0), "m": {"b": torch.ones(2), "a": torch.zeros(1)}})
    out = tree_map(lambda x: x + 1, st, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert type(out) is TrainState and torch.equal(out.params["a"], torch.ones(1))
    ref = RefTrainState({"b": 1, "a": 0}, {"step": 2, "m": {"b": 3, "a": 4}})
    assert [float(t) if t.ndim == 0 else float(t[0]) for t in tensor_leaves(TrainState(
        {"b": torch.tensor(1.0), "a": torch.tensor(0.0)},
        {"step": torch.tensor(2.0), "m": {"b": torch.tensor(3.0), "a": torch.tensor(4.0)}}))] == \
        [float(x) for x in jax.tree.leaves(ref)]
