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
CUDA tensors and :func:`kernel_map_probe_plain` on CPU tensors. The kernel
takes the offsets grouped by (dx, dy) (:func:`probe_groups`, the port's
counterpart of the JAX package's ``_yz_group`` for any offsets) and counts,
per device, its tiles and those whose window of keys did not fit in shared
memory and were walked in device memory (:func:`probe_tile_counts`).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

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


def probe_groups(offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Offsets grouped by (dx, dy), the kernel's walk order.

    Returns ``groups [G, 4]`` int32 rows (dx, dy, first, count) in
    lexicographic (dx, dy) order, and ``slots [K, 2]`` int32 rows (dz, k):
    group g's offsets are ``slots[first:first + count]``, dz ascending, each
    with its slot k in ``offsets``. Any offsets group, grid or not."""
    off = np.asarray(offsets, np.int64).reshape(-1, 3)
    order = np.lexsort((off[:, 2], off[:, 1], off[:, 0]))
    s = off[order]
    new = np.ones(len(s), bool)
    new[1:] = (s[1:, :2] != s[:-1, :2]).any(axis=1)
    first = np.flatnonzero(new)
    count = np.diff(np.append(first, len(s)))
    groups = np.stack([s[first, 0], s[first, 1], first, count], axis=1).astype(np.int32)
    slots = np.stack([s[:, 2], order], axis=1).astype(np.int32)
    return groups.reshape(-1, 4), slots.reshape(-1, 2)


@functools.lru_cache(maxsize=64)
def _group_descriptor(off_bytes: bytes, device: torch.device) -> Tuple[torch.Tensor, int]:
    """(the kernel's descriptor as one int32 tensor on ``device``, G), once
    per offsets and device: the offsets' extent (dx, dy min and max; dz min
    and max, two zeros), then the groups and the slots of
    :func:`probe_groups`."""
    off = np.frombuffer(off_bytes, np.int32).reshape(-1, 3)
    groups, slots = probe_groups(off)
    lo, hi = (off.min(axis=0), off.max(axis=0)) if len(off) else (np.zeros(3),) * 2
    extent = np.array([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], 0, 0], np.int32)
    buf = np.concatenate([extent, groups.ravel(), slots.ravel()])
    return torch.as_tensor(buf, device=device), len(groups)


_tile_counts: Dict[torch.device, torch.Tensor] = {}


def _counts(device: torch.device) -> torch.Tensor:
    if device not in _tile_counts:
        _tile_counts[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _tile_counts[device]


def probe_tile_counts(device) -> Tuple[int, int]:
    """(tiles with a valid query, tiles walked in device memory because their
    window held more keys than shared memory) over K1's launches on
    ``device`` since :func:`reset_probe_tile_counts`. Synchronises."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    tiles, wide = _counts(device).tolist()
    return tiles, wide


def reset_probe_tile_counts() -> None:
    for c in _tile_counts.values():
        c.zero_()


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
    off = np.ascontiguousarray(np.asarray(offsets), np.int32)
    if off.ndim != 2 or off.shape[1] != 3:
        raise ValueError(f"kernel_map_probe: offsets must be [K, 3], got {off.shape}")
    k = off.shape[0]
    desc, n_groups = _group_descriptor(off.tobytes(), dev)
    table = torch.empty((b, k, m), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    rc = lib.wct_kernel_map_probe(
        sorted_keys.data_ptr(), in_num_valid.data_ptr(), n,
        out_coords.data_ptr(), out_num_valid.data_ptr(), m,
        desc.data_ptr(), n_groups, k, st[0], st[1], st[2], b, table.data_ptr(),
        _counts(dev).data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "kernel_map_probe")
    kernel_map_probe.launches += 1
    return table


kernel_map_probe.launches = 0
