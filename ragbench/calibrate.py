"""Readings that the limit of ``correct`` is set from, on the card.

    python3 ragbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1,2,3]
        [--seconds 10] [--warmup 15]

For each seed, one run of the cell as ``run.py`` makes it (with the window
and warm-up given here), in one process: the program's widest logit gap and
retrieval mismatches as the run's check reads them (the lower reading),
and, for the seeds in ``--control``, the widest gap of the fp8 control over
the same prompts and served tokens (the upper reading). One JSON line a
seed to standard output.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the package by its name, not this folder's modules as top-level ones
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "ragbench"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--warmup", type=float, default=None)
    args = ap.parse_args()

    import torch

    from ragbench import spec
    from ragbench.bench import run_cell
    from ragbench.reference.control import control_gap

    cell = spec.cell(args.workload)
    if args.warmup is not None:
        cell.traffic = dict(copy.deepcopy(cell.traffic), warmup_s=args.warmup)
    control = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        keep = {}
        res = run_cell(cell, seed, args.seconds, False, device="cuda", keep=keep)
        rec = {"seed": seed, "correct": res["correct"], "check": res["check"],
               "served": [len(s.answer) for s in keep["served"]],
               "prompts": [s.prompt_len for s in keep["served"]], "metrics": res["metrics"]}
        if seed in control:
            rec["control_gap"] = control_gap(cell.model, keep["params"], keep["served"], "cuda")
        rec["seconds"] = time.perf_counter() - t
        keep.clear()
        torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
