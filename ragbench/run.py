"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 ragbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (exits 2 without one, or with fewer than the cell asks
for) and the port (``src/repro_torch``) beside this folder. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``: each number the comparison with the plain reference read,
beside its limit; those are also the last lines of standard error. Exits 3,
printing no result, if JAX, flax or the JAX package were loaded.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the package by its name, not this folder's modules as top-level ones
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "ragbench"]
# CUDA's JIT cache stays inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "ragbench" / "cuda-cache"))
# one process with few threads: the host loop is the step's bottleneck, and
# idle worker pools spinning beside it make its time vary
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared as a whole word."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from ragbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ragbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from ragbench.bench import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                      process_start=START)
    bad = forbidden_modules()
    if bad:
        print(f"ragbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
