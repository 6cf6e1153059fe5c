"""Checkpointing with restore onto any device (``repro.checkpoint.manager``'s
counterpart, its on-disk format byte for byte).

Layout per step:
    <dir>/step_<N>/
        meta.msgpack          tree structure, shapes, dtypes, step metadata
        arr_<i>.bin           one file per leaf (raw bytes, global view)

Leaves are numbered in ``jax.tree`` order: a dict's sorted keys, a tuple's
fields, so a ``TrainState`` is its params, then opt's ``m``, ``master``,
``step`` (an int32 scalar: 4 bytes, shape ``[]``) and ``v``.  Dtype names
are numpy's (``bfloat16``, ``float32``, ``int32``); bfloat16 is written as
its raw 2-byte words.  ``meta.msgpack`` holds ``step``, ``treedef``,
``shapes``, ``dtypes`` and ``extra``, packed by the port's own codec
(``checkpoint/msgpack_codec.py``: the machine with the card has neither
``msgpack`` nor ``ml_dtypes``).  ``treedef`` is ``json.dumps`` of the repr
``jax.tree.structure`` gives for trees of dicts, tuples and NamedTuples;
``restore`` never reads it.

  * save is **async** (background writer) — the loop only blocks on the
    device -> host copy, not the filesystem;
  * every array is written as its global view, so a restart may place it
    anywhere: ``restore`` puts each leaf on the device of the target tree's
    leaf, or on ``device``;
  * atomic publish: writes go to ``.tmp``, then ``core.integrity.publish_dir``
    renames and fsyncs; partial checkpoints are never visible;
  * ``keep`` newest checkpoints are retained, older ones pruned.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_codec import packb, unpackb
from repro_torch.core.integrity import publish_dir
from repro_torch.core.pipeline_exec import PipelineExecutor, PipelineTask
from repro_torch.models.params import tensor_leaves, tree_unflatten

# torch dtypes numpy lacks: written as integer words of their width
_RAW_WORDS = {torch.bfloat16: torch.int16}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of ``dtype`` (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    return dtype


def treedef_repr(tree) -> str:
    """The repr of ``jax.tree.structure(tree)`` for dicts, tuples and
    NamedTuples (a leaf is ``*``)."""

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            kids = ", ".join(walk(x) for x in t)
            return f"CustomNode(namedtuple[{type(t).__name__}], [{kids}])"
        if isinstance(t, tuple):
            kids = ", ".join(walk(x) for x in t)
            return f"({kids},)" if len(t) == 1 else f"({kids})"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _host(t: torch.Tensor) -> np.ndarray:
    """A leaf's bytes on the host, as numpy (raw words where numpy has no
    such dtype)."""
    t = t.detach()
    if t.dtype in _RAW_WORDS:
        t = t.view(_RAW_WORDS[t.dtype])
    # a copy even on the CPU: the writer runs while the caller goes on
    # updating its tensors in place
    return t.to("cpu", copy=True).contiguous().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # background writes share the repo's one sanctioned executor shape
        # (bounded queue, original-exception propagation, deterministic join)
        self._pool = PipelineExecutor(depth=1, name="ckpt-writer")
        self._last: Optional[PipelineTask] = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot to host, then write in the background."""
        leaves = tensor_leaves(tree)
        host = [_host(t) for t in leaves]  # device -> host (the blocking part)
        meta = {
            "step": int(step),
            "treedef": json.dumps(treedef_repr(tree)),
            "shapes": [list(t.shape) for t in leaves],
            "dtypes": [dtype_name(t.dtype) for t in leaves],
            "extra": extra or {},
        }
        fut = self._pool.submit(self._write, step, host, meta)
        self._last = fut
        if blocking:
            fut.result()
        return fut

    def _write(self, step, host, meta):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, h in enumerate(host):
            with open(os.path.join(tmp, f"arr_{i}.bin"), "wb") as f:
                f.write(h.reshape(-1).data)
        host.clear()  # the snapshot's host memory goes now, not with the task
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(packb(meta))
        if os.path.exists(final):
            shutil.rmtree(final)
        publish_dir(tmp, final)  # rename + parent-dir fsync: the publish
        # itself is durable, not just the payload files
        self._prune()
        return final

    def wait(self):
        if self._last is not None:
            self._last.result()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None, device=None):
        """Load into the structure of ``target_tree`` (tensors; ``meta``
        ones need a ``device``).  Each leaf goes to ``device`` when given,
        else to its target leaf's device (``repro``'s ``shardings`` place
        leaves on a mesh; one process holds every leaf whole).
        Returns (tree, extra_metadata).
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.msgpack"), "rb") as f:
            meta = unpackb(f.read())
        leaves = tensor_leaves(target_tree)
        if len(leaves) != len(meta["shapes"]):
            raise ValueError(f"checkpoint has {len(meta['shapes'])} leaves, target has "
                             f"{len(leaves)} — structure mismatch")
        out = []
        for i, ref in enumerate(leaves):
            shape, dtype = tuple(meta["shapes"][i]), _torch_dtype(meta["dtypes"][i])
            if shape != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {shape} != target "
                                 f"{tuple(ref.shape)}")
            word = _RAW_WORDS.get(dtype, dtype)
            buf = bytearray(os.path.getsize(os.path.join(path, f"arr_{i}.bin")))
            with open(os.path.join(path, f"arr_{i}.bin"), "rb") as f:
                f.readinto(buf)
            t = torch.frombuffer(buf, dtype=word) if buf else torch.empty(0, dtype=word)
            t = t.view(dtype).reshape(shape)
            dev = torch.device(device) if device is not None else ref.device
            if dev.type == "meta":
                raise ValueError("restoring into meta tensors needs a device")
            out.append(t.to(dev))
        return tree_unflatten(target_tree, out), meta["extra"]
