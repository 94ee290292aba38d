"""Kernel-map probe: K1, the port of ``warpconvnet_tpu/kernels/sorted_search.py``
``_probe_kernel_mz`` (:288) and its entry ``sorted_probe_batched_mz``.

Contract (the output of the JAX ``build_pair_tables_batched``, not the Pallas
kernel's internal layout): given per-scene lex-sorted int64 keys of the
input coords, return ``table [B, K, M]`` int32 holding, for each offset k and
output row o, the scene-local position ``i < in_num_valid[b]`` with
``keys[b, i] == key(stride * out_coords[b, o] + offsets[k])``, or -1. Pad
output rows, and queries with any coordinate outside ``±(PAD_COORD - 1)``,
give -1.

:func:`kernel_map_probe` runs the CUDA kernel (``csrc/sorted_search.cu``) on
CUDA tensors and :func:`kernel_map_probe_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from warpconvnet_tpu_torch.kernels import _build
from warpconvnet_tpu_torch.ops.keys import PAD_COORD, coord_keys


def _queries(out_coords, out_num_valid, offsets, stride):
    """[B, K, M] int64 query keys and their validity."""
    m = out_coords.shape[1]
    dev = out_coords.device
    st = torch.as_tensor(stride, dtype=torch.int64, device=dev)
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.int64, device=dev)
    q = out_coords.to(torch.int64)[:, None, :, :] * st + off[None, :, None, :]
    ov = torch.arange(m, device=dev)[None, :] < out_num_valid[:, None]
    ok = ov[:, None, :] & (q.abs() <= PAD_COORD - 1).all(-1)
    q = torch.where(ok[..., None], q, 0)
    return coord_keys(q), ok


def kernel_map_probe_plain(
    sorted_keys: torch.Tensor,  # [B, N] int64, lex-sorted valid prefix
    in_num_valid: torch.Tensor,  # [B]
    out_coords: torch.Tensor,  # [B, M, 3] int32
    out_num_valid: torch.Tensor,  # [B]
    offsets: np.ndarray,  # [K, 3]
    stride: Sequence[int],
) -> torch.Tensor:
    """The probe as ``torch.searchsorted`` on int64 keys."""
    b, n = sorted_keys.shape
    k, m = len(offsets), out_coords.shape[1]
    qk, ok = _queries(out_coords, out_num_valid, offsets, stride)
    pos = torch.searchsorted(sorted_keys, qk.reshape(b, k * m)).reshape(b, k, m)
    found = torch.gather(
        sorted_keys, 1, pos.clamp(max=n - 1).reshape(b, k * m)
    ).reshape(b, k, m)
    hit = ok & (pos < in_num_valid.to(torch.int64)[:, None, None]) & (found == qk)
    return torch.where(hit, pos, -1).to(torch.int32)


def kernel_map_probe(
    sorted_keys: torch.Tensor,
    in_num_valid: torch.Tensor,
    out_coords: torch.Tensor,
    out_num_valid: torch.Tensor,
    offsets: np.ndarray,
    stride: Sequence[int],
) -> torch.Tensor:
    """K1 on CUDA tensors, :func:`kernel_map_probe_plain` on CPU tensors."""
    if sorted_keys.device.type == "cpu":
        return kernel_map_probe_plain(
            sorted_keys, in_num_valid, out_coords, out_num_valid, offsets, stride
        )
    if sorted_keys.device.type != "cuda":
        raise ValueError(f"kernel_map_probe: unsupported device {sorted_keys.device}")
    b, n = sorted_keys.shape
    m = out_coords.shape[1]
    dev = sorted_keys.device
    checks = (
        (sorted_keys, torch.int64, (b, n)),
        (in_num_valid, torch.int32, (b,)),
        (out_coords, torch.int32, (b, m, 3)),
        (out_num_valid, torch.int32, (b,)),
    )
    for t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"kernel_map_probe: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("kernel_map_probe: inputs must be contiguous")
    st = [int(s) for s in stride]
    if len(st) != 3:
        raise ValueError(f"kernel_map_probe: stride must have 3 entries, got {st}")
    off = torch.as_tensor(np.asarray(offsets, np.int32), device=dev).contiguous()
    if off.ndim != 2 or off.shape[1] != 3:
        raise ValueError(f"kernel_map_probe: offsets must be [K, 3], got {tuple(off.shape)}")
    k = off.shape[0]
    table = torch.empty((b, k, m), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    rc = lib.wct_kernel_map_probe(
        sorted_keys.data_ptr(), in_num_valid.data_ptr(), n,
        out_coords.data_ptr(), out_num_valid.data_ptr(), m,
        off.data_ptr(), k, st[0], st[1], st[2], b, table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "kernel_map_probe")
    kernel_map_probe.launches += 1
    return table


kernel_map_probe.launches = 0
