"""Build and load the port's CUDA kernels (nvcc into a shared library,
bound with ctypes).

``load_cpm()`` compiles ``csrc/cpm.cu`` for ``sm_90a`` at first use into
``build/repro_torch/`` under the checkout root, keyed on a hash of the
source so an edit rebuilds it, and returns the loaded library with its
argument types set. Nothing is built at import time: this module is
imported on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CPM_SOURCE", "build_log", "load_cpm"]

CSRC = Path(__file__).resolve().parent / "csrc"
CPM_SOURCE = CSRC / "cpm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_log(source: Path = CPM_SOURCE) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory report) of
    the last build of ``source``, or "" if it was not built here."""
    log = _library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(source: Path) -> Path:
    lib = _library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial .so
    return lib


def load_cpm() -> ctypes.CDLL:
    """The cpm kernel library, built and loaded on first use; later calls
    return the loaded library without touching the disk (a source edit
    takes effect in the next process)."""
    lib = _libs.get(CPM_SOURCE)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(CPM_SOURCE)
        if lib is None:
            path = _build(CPM_SOURCE)
            lib = ctypes.CDLL(str(path))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cpm_combined_lb.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
            lib.cpm_combined_lb_masked.argtypes = [
                ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr,
            ]
            lib.cpm_critical_path.argtypes = [ptr, ptr, i32, i32, i32, ptr]
            for fn in (
                lib.cpm_combined_lb,
                lib.cpm_combined_lb_masked,
                lib.cpm_critical_path,
            ):
                fn.restype = ctypes.c_int
            _libs[CPM_SOURCE] = lib
        return lib
