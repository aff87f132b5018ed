"""Build and load the port's CUDA kernels.

``csrc/paged_attention.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, on first use, under
``<checkout>/build/repro_torch/`` (git-ignored), and loaded with ``ctypes``.
The library's file name carries a hash of the source, so an edit rebuilds.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "paged_attention.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


class KernelLibrary:
    """The loaded shared library, with its C entry points declared, plus how
    it was obtained (build seconds and the compiler's resource report)."""

    def __init__(self, path: Path, build_s: float, ptxas: str):
        self.path = path
        self.build_s = build_s
        self.ptxas = ptxas
        lib = ctypes.CDLL(str(path))
        lib.pa_smem_bytes.argtypes = [_I, _I]
        lib.pa_smem_bytes.restype = _I
        lib.pa_paged_decode_attention.argtypes = (
            [_I, _I] + [_P] * 8 + [_I] * 6 + [_F, _P])
        lib.pa_paged_decode_attention.restype = _I
        lib.pa_paged_chunk_attention.argtypes = (
            [_I, _I] + [_P] * 11 + [_I] * 6 + [_F, _P])
        lib.pa_paged_chunk_attention.restype = _I
        self.lib = lib


@functools.cache
def load_library() -> KernelLibrary:
    """Compile the kernels if this source has not been built yet, then load
    them (once per process)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libpaged_attention_{digest}.so"
    log = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_s = time.perf_counter() - t0
    return KernelLibrary(out, build_s, log.read_text() if log.exists() else "")
