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
        "import repro_torch.serving.host_tier, repro_torch.serving.paged_cache\n"
        "import repro_torch.kernels.decode_attention, repro_torch.kernels._build\n"
        "import repro_torch.apps, repro_torch.serving.retrieval\n"
        "import repro_torch.kernels.topk_retrieval, repro_torch.data.workload\n"
        "import repro_torch.kernels.flash_attention, repro_torch.models.attention\n"
        "import repro_torch.kernels.ssm_scan, repro_torch.models.ssm\n"
        "import repro_torch.core.telemetry, repro_torch.core.simcluster\n"
        "import repro_torch.core.router, repro_torch.core.allocation\n"
        "import repro_torch.core.profiling, repro_torch.core.controller\n"
        "import repro_torch.launch.deploy_config\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_controller_imports_without_scipy():
    """scipy is imported by ``solve_allocation``, not by the modules: the
    controller, the launchers and the allocation module import without it,
    and a monolithic deployment (no LP) runs with scipy blocked."""
    code = ("import sys\n"
            "import repro_torch.core.controller, repro_torch.core.allocation\n"
            "import repro_torch.launch.serve, repro_torch.launch.deploy_config\n"
            "assert 'scipy' not in sys.modules, sorted(m for m in sys.modules if 'scipy' in m)\n"
            "sys.modules['scipy'] = None\n"
            "from repro_torch.apps import make_app\n"
            "from repro_torch.core.controller import PatchworkRuntime, MONOLITHIC\n"
            "rt = PatchworkRuntime(make_app('vrag'), {'GPU': 4, 'CPU': 32, 'RAM': 256},\n"
            "                      engine=MONOLITHIC)\n"
            "print(rt.metrics.instance_counts)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'__pipeline__': 2}"


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
    for kw in ({"backend": "paged", "interleave": False}, {"ragged": False},
               {"sanitize": True}, {"mesh": object()}, {"pool_layout": object()},
               {"kv": object()}):
        with pytest.raises(NotImplementedError):
            GenerationEngine(cfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError):      # the int8 dense cache
        GenerationEngine(cfg.replace(kv_cache_quant=True), device="cpu", backend="dense")
    assert GenerationEngine(cfg, device="cpu", backend="dense").backend == "dense"
    # int8 pools, the host tier and swap/cost preemption are ported
    for kw in ({"preempt": "swap"}, {"preempt": "cost"}, {"kv_dtype": "int8"},
               {"host_blocks": 8}):
        eng = GenerationEngine(cfg, device="cpu", **kw)
        assert (eng.host_store is not None) == ("kv_dtype" not in kw)
    assert GenerationEngine(cfg.replace(kv_cache_quant=True), device="cpu").kv.quantized


def test_pipelines_with_a_host_tier_raise_not_implemented():
    """The pipelines launcher used to refuse a host tier; it now attaches
    one of the size asked for (the reference's 128 blocks by default)."""
    from repro_torch.launch.serve import serve_pipelines

    drv = serve_pipelines(host_blocks=8, device="cpu", smoke=True, rate=10.0, duration=0.5)
    assert drv.engine.host_store.n_blocks == 8
    assert drv.engine.host_store.n_swapped == 0
