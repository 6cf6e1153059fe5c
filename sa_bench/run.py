"""Run one cell of the benchmark once and print its result line.

    python3 sa_bench/run.py --workload reads-build --seed 7 --seconds 30 --trace 0

From the root of a checkout: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and chips; the program under test is the
checkout's ``src/repro_torch``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each number
compared with its limit, also the last lines of standard error).  Exits
with another code than 0, printing no result, without enough CUDA devices,
if the run loaded JAX or the JAX package (``repro``) or read anything under
``benchmarks/``, or if the program is missing.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs(root: Path) -> None:
    """Every compile cache at a fixed path inside the checkout (the port's
    kernels already build into ``build/repro_torch_kernels``)."""
    cache = root / "build" / "sa_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def _terminated(signum, frame):
    """SIGTERM as an exit, so the spawned ranks are stopped on the way out."""
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    args = parse_args(argv)
    signal.signal(signal.SIGTERM, _terminated)
    set_cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from sa_bench.harness import guard as guard_mod

    guard = guard_mod.ReadGuard(ROOT)
    from sa_bench.harness import cell, spec

    chips = int(spec.cell(spec.load(ROOT), args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sa_bench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = cell.gathered_run(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T0, guard)
    return finish(ROOT, args.workload, bool(args.trace), run,
                  torch.cuda.get_device_name(0), guard)


def finish(root: Path, workload: str, traced: bool, run: dict, device_kind: str,
           guard) -> int:
    """Print the result line of ``run`` and return 0, or return 3 and print
    nothing on standard output where a rank loaded or read what it may not.
    The metric readers run first, so that what they load counts too."""
    from sa_bench.harness import cell
    from sa_bench.harness import guard as guard_mod

    out = cell.result(root, workload, traced, run, device_kind)
    found = [f"rank {i}: {f}" for i, r in enumerate(run["ranks"]) for f in r["findings"]]
    found += [f"rank 0: {f}" for f in guard_mod.findings(guard)]
    if found:
        print("sa_bench: the run loaded or read what it may not:", file=sys.stderr)
        for f in sorted(set(found)):
            print(f"  {f}", file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
