"""The PyTorch port stands alone: no jax and no ``repro`` at run time, and it
never carries on on the CPU unless asked to."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
SLICE_MODULES = [
    "repro_torch",
    "repro_torch.config",
    "repro_torch.device",
    "repro_torch.core.types",
    "repro_torch.core.encoding",
    "repro_torch.core.distributed",
    "repro_torch.core.store",
    "repro_torch.core.lcp",
    "repro_torch.core.search",
    "repro_torch.core.pipeline",
    "repro_torch.core.superblock",
    "repro_torch.core.pipeline_exec",
    "repro_torch.core.oracle",
    "repro_torch.core.integrity",
    "repro_torch.core.index_io",
    "repro_torch.core.journal",
    "repro_torch.core.sanitize",
    "repro_torch.core.terasort",
    "repro_torch.core.prefix_doubling",
    "repro_torch.data.corpus",
    "repro_torch.data.chunk_store",
    "repro_torch.data.dedup",
    "repro_torch.data.loader",
    "repro_torch.kernels",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.cases",
    "repro_torch.kernels.ops",
    "repro_torch.kernels._build",
    "repro_torch.kernels.prefix_pack",
    "repro_torch.kernels.window_gather",
    "repro_torch.kernels.pattern_cmp",
    "repro_torch.kernels.merge_path",
    "repro_torch.kernels.bucket_hist",
    "repro_torch.kernels.bitonic_sort",
    "repro_torch.launch.sa_build",
    "repro_torch.launch.serve",
    "repro_torch.launch.lm_serve",
    "repro_torch.serve",
    "repro_torch.serve.sa_engine",
    "repro_torch.serve.engine",
    "repro_torch.configs",
    "repro_torch.configs.suffix_array",
    "repro_torch.models",
    "repro_torch.models.params",
    "repro_torch.models.layers",
    "repro_torch.models.ssm",
    "repro_torch.models.transformer",
    "repro_torch.models.xlstm",
    "repro_torch.models.model",
    "repro_torch.train",
    "repro_torch.train.optimizer",
    "repro_torch.train.step",
    "repro_torch.train.loop",
    "repro_torch.train.compression",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.manager",
    "repro_torch.checkpoint.msgpack_codec",
    "repro_torch.runtime",
    "repro_torch.runtime.fault",
    "repro_torch.runtime.monitor",
    "repro_torch.runtime.elastic",
    "repro_torch.sharding",
    "repro_torch.sharding.rules",
    "repro_torch.launch.specs",
    "repro_torch.launch.train",
    "repro_torch.launch.mesh",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.perf",
    "repro_torch.sharding.placement",
    "repro_torch.analysis",
    "repro_torch.analysis.hlo",
    "repro_torch.analysis.corrected",
    "repro_torch.analysis.roofline",
    "repro_torch.analysis.report",
]
EXAMPLES = ["torch_quickstart", "torch_sa_build", "torch_dedup_corpus", "torch_serve_lm",
            "torch_train_lm"]


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    examples = os.path.join(REPO, "examples")
    out.extend(os.path.join(examples, f) for f in os.listdir(examples)
               if f.startswith("torch_") and f.endswith(".py"))
    for dirpath, _dirs, files in os.walk(PORT):
        out.extend(os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    return sorted(out)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES + EXAMPLES!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch\n"
        "repro_torch.SAConfig, repro_torch.build_suffix_array_auto\n"
        "repro_torch.SuperblockConfig, repro_torch.SuffixArrayIndex\n"
        "repro_torch.ShardedSAEngine\n"
        "repro_torch.config.get_arch('gemma3-1b')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "examples")]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, node.lineno, name)


def test_resolve_device_defaults_to_the_card():
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_point_without_cuda_raises_instead_of_running_on_cpu():
    import numpy as np

    from repro_torch import build_suffix_array_auto

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_suffix_array_auto(np.ones((2, 3), np.int32))
