"""On the card: one short run of the first cell through the command, whose
last line is the result (skips without a CUDA device)."""
import json
import subprocess
import sys

import pytest
import torch

from ragbench import spec


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's CUDA kernels")
    cell = spec.load()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "ragbench/run.py", "--workload", cell, "--seed", "3",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
