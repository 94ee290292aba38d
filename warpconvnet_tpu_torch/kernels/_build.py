"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
writes into ``warpconvnet_tpu_torch/_build/`` and is reused while the
sources, the headers (``csrc/*.cuh``) and the flags hash the same. Nothing
here runs at import time.
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
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # int wct_kernel_map_probe(keys, in_nv, n, out_coords, out_nv, m, desc,
    #                          n_groups, k, sx, sy, sz, b, table, counts, stream)
    "wct_kernel_map_probe": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # int wct_igemm_fwd(x, w, table, order, out, img, b, n_in, n_out, k, c_in,
    #                   c_out, w_trans, dtype, work, stream)
    "wct_igemm_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # int wct_igemm_wgrad(x, g, table, dw, b, n_in, n_out, k, c_in, c_out,
    #                     dtype, count, plan, stream)
    "wct_igemm_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # int wct_igemm_bwd_fused(x, g, w, table, order, dx, dw, img, b, n, k,
    #                         c_in, c_out, dtype, counts, stream)
    "wct_igemm_bwd_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # int wct_depth_fwd(x, w, table, out, b, n_in, n_out, k, c, dtype, stream)
    "wct_depth_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # int wct_depth_wgrad(x, g, table, dw, b, n_in, n_out, k, c, dtype, count,
    #                     plan, stream)
    "wct_depth_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # int wct_depth_bwd_fused(x, g, w, table, dx, dw, b, n, k, c, dtype, count,
    #                         plan, stream)
    "wct_depth_bwd_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # int wct_segment_attention_fwd(q, k, v, seg_q, seg_kv, out, lse, b, sq, skv, h, d,
    #                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, dtype,
    #                               split, per_pass, staged, visit, visits, stream)
    "wct_segment_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _L, _L, _L, _L, _L, _L, ctypes.c_float, _I, _P, _I, _P,
                                  _P, _P, _P],
    # int wct_segment_attention_bwd_dkv(q, k, v, dout, lse, di, seg_q, seg_kv, dk, dv,
    #                                   b, sq, skv, h, d, strides[8], scale, dtype,
    #                                   split, per_pass, staged, visit, visits, stream)
    "wct_segment_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _P, ctypes.c_float, _I, _P, _I, _P,
                                      _P, _P, _P],
    # int wct_segment_attention_bwd_dq(q, k, v, dout, lse, di, seg_q, seg_kv, dq,
    #                                  b, sq, skv, h, d, strides[8], scale, dtype,
    #                                  split, per_pass, staged, visit, visits, stream)
    "wct_segment_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _P, ctypes.c_float, _I, _P, _I, _P,
                                     _P, _P, _P],
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
    """Path of the library for the current sources, headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwct_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, run in parallel, then one link. Raises with
    nvcc's output on failure; writes nvcc's output (register and
    shared-memory counts from ``-Xptxas -v``) to ``_build/build.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.path.basename(so)[:-3]}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{tag}.{os.path.basename(src)}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{out}")
    tmp = f"{so}.{os.getpid()}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"link (rc {proc.returncode}):\n{proc.stdout}")
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(log))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
            # int64 wct_igemm_image_bytes(k, c_in, c_out, n_out, b)
            lib.wct_igemm_image_bytes.argtypes = [_I, _I, _I, _I, _I]
            lib.wct_igemm_image_bytes.restype = _L
            # int64 wct_segment_attention_fwd_split_bytes(nb, skv, h, d)
            lib.wct_segment_attention_fwd_split_bytes.argtypes = [_I, _I, _I, _I]
            lib.wct_segment_attention_fwd_split_bytes.restype = _L
            # int64 wct_segment_attention_bwd_split_bytes(nh, rows, d, dkv)
            lib.wct_segment_attention_bwd_split_bytes.argtypes = [_I, _I, _I, _I]
            lib.wct_segment_attention_bwd_split_bytes.restype = _L
            # int64 wct_segment_attention_visit_ints(b, n_own)
            lib.wct_segment_attention_visit_ints.argtypes = [_I, _I]
            lib.wct_segment_attention_visit_ints.restype = _L
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.wct_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
