"""Build the port's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` exports one ``extern "C"`` launcher and is compiled
on its own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/`` at
the root of the checkout, then loaded with ``ctypes``.  The library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and a fresh checkout builds at first use.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("prefix_pack", "window_gather", "pattern_cmp", "merge_path")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library not built yet: one ``nvcc`` per source, all
    started together.  Returns each compiled source's ``-Xptxas -v`` log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
    return logs


def launcher(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The ``extern "C"`` function ``symbol`` of library ``name``, built on
    first use, with its ``argtypes`` set and an ``int`` (cudaError_t) result."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
