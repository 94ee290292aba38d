"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, writes into ``warpconvnet_tpu_torch/_build/`` and is
reused while the sources and flags hash the same. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # int wct_kernel_map_probe(keys, in_nv, n, out_coords, out_nv, m,
    #                          offsets, k, sx, sy, sz, b, table, stream)
    "wct_kernel_map_probe": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    # int wct_igemm_fwd(x, w, table, out, b, n_in, n_out, k, c_in, c_out,
    #                   dtype, stream)
    "wct_igemm_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwct_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for their hash exists.
    Raises with nvcc's output on failure; writes nvcc's output (register and
    shared-memory counts from ``-Xptxas -v``) to ``_build/build.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wct_error_string.argtypes = [ctypes.c_int]
            lib.wct_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.wct_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
