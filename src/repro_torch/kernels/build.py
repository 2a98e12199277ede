"""Build and load the port's CUDA kernels (nvcc into a shared library,
bound with ctypes).

Each source under ``csrc/`` becomes its own library. ``load(name)``
compiles ``csrc/<name>.cu`` for ``sm_90a`` at first use into
``build/repro_torch/`` under the checkout root, keyed on a hash of the
source and of the shared headers (``csrc/*.cuh``) so an edit of either
rebuilds it, and returns the loaded library with its
argument types set. ``build_all()`` starts one ``nvcc`` per source at
once and waits for all of them. Nothing is built at import time: this
module is imported on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "BUILD_DIR",
    "CPM_SOURCE",
    "SOURCES",
    "build_all",
    "build_log",
    "load",
    "load_cpm",
]

CSRC = Path(__file__).resolve().parent / "csrc"
CPM_SOURCE = CSRC / "cpm.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_ptr, _i32, _i64p, _f32 = (
    ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
)

# Library name -> {C function: argtypes}. Every function returns the
# cudaError_t of its launch as an int.
SIGNATURES: dict[str, dict[str, list]] = {
    "cpm": {
        "cpm_combined_lb": [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _ptr],
        "cpm_combined_lb_masked": [
            _ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _ptr,
        ],
        "cpm_critical_path": [_ptr, _ptr, _i32, _i32, _i32, _ptr],
        # racks, inst_id, src, dst, p_src, c_local, c_net, net_work, p_task,
        # chan_div, [pair_ok, uplift,] out, B, n_pad, m_pad, M_pad, n_iters,
        # contention, stream
        "cpm_fleet_lb": [*[_ptr] * 11, *[_i32] * 6, _ptr],
        "cpm_fleet_lb_masked": [*[_ptr] * 13, *[_i32] * 6, _ptr],
    },
    "flash_attention": {
        # dtype, q, k, v, out, lse (or null), strides[12], B, S, T, H, KV, D,
        # causal, scale, stream
        "flash_attention_fwd": [
            _i32, _ptr, _ptr, _ptr, _ptr, _ptr, _i64p,
            _i32, _i32, _i32, _i32, _i32, _i32, _i32, _f32, _ptr,
        ],
        # dtype, D -> dynamic shared memory of one block in bytes
        "flash_attention_smem_bytes": [_i32, _i32],
    },
    "flash_attention_bwd": {
        # dtype, o, do, delta, strides[15], B, S, H, D, stream
        "flash_bwd_delta": [_i32, _ptr, _ptr, _ptr, _i64p, _i32, _i32, _i32, _i32, _ptr],
        # dtype, q, k, v, do, lse, delta, dk, dv, strides[15], B, S, T, H, KV,
        # D, causal, scale, stream
        "flash_bwd_dkdv": [
            _i32, *[_ptr] * 8, _i64p, *[_i32] * 7, _f32, _ptr,
        ],
        # dtype, q, k, v, do, lse, delta, dq, strides[15], B, S, T, H, KV, D,
        # causal, scale, stream
        "flash_bwd_dq": [
            _i32, *[_ptr] * 7, _i64p, *[_i32] * 7, _f32, _ptr,
        ],
        # kernel (1 = dkdv, 2 = dq), dtype, D -> dynamic shared memory of
        # one block in bytes
        "flash_bwd_smem_bytes": [_i32, _i32, _i32],
    },
    "decode_attention": {
        # dtype, q, k, v, kv_len (or null), kv_len_all, out, part,
        # strides[8], B, T, H, KV, D, n_splits, scale, stream
        "decode_attention_fwd": [
            _i32, _ptr, _ptr, _ptr, _ptr, _i32, _ptr, _ptr, _i64p,
            _i32, _i32, _i32, _i32, _i32, _i32, _f32, _ptr,
        ],
    },
}
SOURCES = {name: CSRC / f"{name}.cu" for name in SIGNATURES}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_log(source: Path = CPM_SOURCE) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory report) of
    the last build of ``source``, or "" if it was not built here."""
    log = _library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(source: Path):
    """Start nvcc for ``source`` unless its library exists; returns
    (library path, temp path, command, process or None)."""
    lib = _library_path(source)
    if lib.exists():
        return lib, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return lib, tmp, cmd, proc


def _finish(source: Path, lib: Path, tmp, cmd, proc) -> Path:
    if proc is None:
        return lib
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{' '.join(cmd)}\n{err}"
        )
    lib.with_suffix(".log").write_text(out + err)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial .so
    return lib


def _open(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (a key of :data:`SOURCES`), built and
    loaded on first use; later calls return the loaded library without
    touching the disk (a source edit takes effect in the next process)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            source = SOURCES[name]
            lib = _open(name, _finish(source, *_start(source)))
            _libs[name] = lib
        return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every library not yet loaded, one nvcc per source, all
    started together; returns the loaded libraries by name."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        started = [(n, _start(SOURCES[n])) for n in todo]
        errors = []
        for n, job in started:
            try:
                _libs[n] = _open(n, _finish(SOURCES[n], *job))
            except RuntimeError as e:  # wait for the other builds first
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(_libs)


def load_cpm() -> ctypes.CDLL:
    """The cpm kernel library (see :func:`load`)."""
    return load("cpm")
