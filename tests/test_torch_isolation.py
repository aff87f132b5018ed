"""The port stands alone: it imports with JAX and ``repro`` blocked, no file
of it (nor ``chip_smoke.py``) imports either, and its entry points refuse to
run on a GPU that is not there instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")


def test_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.serving.engine, repro_torch.launch.serve\n"
        "import repro_torch.kernels.decode_attention, repro_torch.kernels._build\n"
        "import repro_torch.apps, repro_torch.serving.retrieval\n"
        "import repro_torch.kernels.topk_retrieval, repro_torch.data.workload\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), root) for f in files
           for root in _imported_roots(f) if root in BANNED]
    assert bad == []


def test_cuda_path_raises_without_a_gpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import GenerationEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(smoke_variant(get_arch("smollm-135m")))
    from repro_torch.serving.retrieval import VectorIndex

    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorIndex.build(torch.ones(4, 8), n_clusters=2)
    assert resolve_device("cpu").type == "cpu"


def test_later_slices_raise_not_implemented():
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving.engine import GenerationEngine

    cfg = smoke_variant(get_arch("smollm-135m"))
    for kw in ({"preempt": "swap"}, {"kv_dtype": "int8"}, {"host_blocks": 8},
               {"interleave": False}, {"ragged": False}, {"backend": "dense"},
               {"sanitize": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            GenerationEngine(cfg, device="cpu", **kw)


def test_pipelines_with_a_host_tier_raise_not_implemented():
    from repro_torch.launch.serve import serve_pipelines

    with pytest.raises(NotImplementedError):
        serve_pipelines(host_blocks=8, device="cpu")
