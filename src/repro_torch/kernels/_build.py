"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, on first use, under
``<checkout>/build/repro_torch/`` (git-ignored), and loaded with ``ctypes``.
A library's file name carries a hash of its source, of every header in
``csrc/`` and of the compiler flags (``source_digest``), so an edit rebuilds
what it touches. ``build_all`` starts one ``nvcc`` per source at once.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# the C entry points of each library: name -> (argtypes, restype)
ENTRY_POINTS = {
    "paged_attention": {
        "pa_smem_bytes": ([_I, _I], _I),
        "pa_paged_decode_attention": ([_I, _I] + [_P] * 10 + [_I] * 8 + [_F, _P], _I),
        "pa_paged_chunk_attention": ([_I, _I] + [_P] * 14 + [_I] * 8 + [_F, _P], _I),
        "pa_chunk_tc_smem_bytes": ([_I, _I], _I),
        "pa_chunk_tile_plan": ([_P, _I, _I, _P, _P], _I),
    },
    "topk_retrieval": {
        "tk_max_k": ([], _I),
        "tk_docs_per_tile": ([], _I),
        "tk_query_tile": ([], _I),
        "tk_smem_bytes": ([_I, _I, _I, _I], _I),
        "tk_merge_smem_bytes": ([_I, _I], _I),
        "tk_topk_retrieval": ([_I] + [_P] * 6 + [_I] * 7 + [_P], _I),
    },
    "dense_attention": {
        "da_flash_smem_bytes": ([_I, _I, _I], _I),
        "da_flash_attention": ([_I] + [_P] * 4 + [_I] * 10 + [_F, _P], _I),
        "da_decode_attention": ([_I] + [_P] * 7 + [_I] * 6 + [_F, _P], _I),
    },
    "flash_backward": {
        "fb_smem_bytes": ([_I, _I, _I], _I),
        "fb_tile_ranges": ([_I] * 5 + [_P, _P], _I),
        "fb_flash_backward": ([_I] + [_P] * 11 + [_I] * 10 + [_F, _P], _I),
    },
    "rwkv6_scan": {
        "wkv_rwkv6": ([_I] + [_P] * 10 + [_I] * 6 + [_P], _I),
        "wkv_output_blocks_per_sm": ([_I, _I], _I),
    },
    "ssm_scan": {
        "ssm_selective_scan": ([_I] + [_P] * 10 + [_I] * 6 + [_P], _I),
        "ssm_output_blocks_per_sm": ([_I, _I], _I),
    },
    "rwkv6_scan_backward": {
        "wkvb_rwkv6_backward": ([_I] + [_P] * 20 + [_I] * 6 + [_P], _I),
        "wkvb_output_blocks_per_sm": ([_I, _I], _I),
    },
    "ssm_scan_backward": {
        "ssmb_selective_scan_backward": ([_I] + [_P] * 21 + [_I] * 6 + [_P], _I),
        "ssmb_output_blocks_per_sm": ([_I, _I], _I),
    },
}
SOURCES = {name: CSRC / f"{name}.cu" for name in ENTRY_POINTS}


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
    """A loaded shared library, with its C entry points declared, plus how
    it was obtained (build seconds and the compiler's resource report)."""

    def __init__(self, name: str, path: Path, build_s: float, ptxas: str):
        self.source = SOURCES[name]
        self.path = path
        self.build_s = build_s
        self.ptxas = ptxas
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        self.lib = lib


def source_digest(source: Path) -> str:
    """Hash of what a build of ``source`` depends on: its bytes, those of
    every ``*.cuh`` header beside it (any source may include any of them)
    and the compiler flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.cache
def load_library(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` if this source (with the headers it may
    include) has not been built yet, then load it (once per process)."""
    source = SOURCES[name]
    digest = source_digest(source)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_s = time.perf_counter() - t0
    return KernelLibrary(name, out, build_s, log.read_text() if log.exists() else "")


def build_all() -> dict:
    """Build (in parallel, one ``nvcc`` per source) and load every library;
    returns {name: KernelLibrary}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(load_library, SOURCES)))
