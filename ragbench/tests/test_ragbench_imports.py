"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module name (``repro_torch`` begins with ``repro`` and is
allowed); the plain reference loads nothing of the port."""
import subprocess
import sys

from ragbench import spec

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code):
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = loaded_after(
        "import ragbench.bench, ragbench.sweep, ragbench.calibrate, ragbench.reference.control\n"
        "from repro_torch.serving.engine import GenerationEngine\n"
        "from repro_torch.serving.retrieval import VectorIndex\n"
        "from ragbench import spec\n"
        "[spec.reader(m['name']) for m in spec.load()['end_to_end'] + spec.load()['per_layer']]")
    assert not mods & FORBIDDEN
    assert "repro_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = loaded_after("import ragbench.reference.decoder, ragbench.reference.control")
    assert "repro_torch" not in mods and not mods & FORBIDDEN


def test_the_command_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "ragbench/run.py", "--workload",
                          spec.load()["workloads"][0]["name"], "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
