"""Sparse pooling and unpooling (counterpart of
``warpconvnet_tpu/nn/functional/sparse_pool.py``).

Pooling strides the coordinates and reduces each output over its kernel-map
neighbours; unpooling reads the pooling map's reverse table. The maps are
those of :func:`generate_output_coords_and_kernel_map`: submanifold for
stride 1, the parity partition for an even power-of-two kernel equal to the
stride (Volt's K^3 patch tokenizer). Other strided maps are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from warpconvnet_tpu_torch.geometry.voxels import Voxels, _as3
from warpconvnet_tpu_torch.kernels.implicit_gemm import _gather_rows
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    BatchedPairTable,
    generate_output_coords_and_kernel_map,
)


def sparse_reduce(
    voxels: Voxels,
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int,
    reduction: str = "max",
    out_capacity: Optional[int] = None,
) -> Tuple[Voxels, BatchedPairTable]:
    """Reduce features over each output's kernel-map neighbours (JAX
    ``sparse_reduce``): "max" and "min" in the features' dtype, "sum" and
    "mean" in fp32 in offset order, cast back. Outputs with no covered input
    and pad rows are zero. Returns (pooled voxels, map)."""
    if reduction not in ("max", "min", "sum", "mean"):
        raise ValueError(f"unsupported reduction {reduction!r}")
    oc, onv, table, out_ts = generate_output_coords_and_kernel_map(
        voxels, kernel_size, stride, out_capacity=out_capacity
    )
    t = table.table  # [B, K, M]
    feats = voxels.features
    b, _, c = feats.shape
    m = oc.shape[1]
    count = (t >= 0).sum(dim=1)  # [B, M]
    if reduction in ("max", "min"):
        neutral = float("-inf") if reduction == "max" else float("inf")
        op = torch.maximum if reduction == "max" else torch.minimum
        acc = torch.full((b, m, c), neutral, dtype=feats.dtype, device=feats.device)
        for k in range(t.shape[1]):
            tk = t[:, k]
            acc = op(acc, torch.where((tk >= 0)[..., None], _gather_rows(feats, tk), neutral))
        out = torch.where(count[..., None] > 0, acc, 0)
    else:
        acc = torch.zeros((b, m, c), dtype=torch.float32, device=feats.device)
        for k in range(t.shape[1]):
            acc += _gather_rows(feats, t[:, k]).float()
        if reduction == "mean":
            acc = acc / count.clamp(min=1)[..., None]
        out = acc.to(feats.dtype)
    row_valid = torch.arange(m, device=oc.device)[None, :] < onv[:, None]
    out = torch.where(row_valid[..., None], out, 0)
    # Strided outputs come out lex-sorted; stride 1 keeps the input's order.
    pooled_sorted = True if any(s != 1 for s in _as3(stride)) else voxels.lex_sorted
    pooled = Voxels(
        coords=oc, features=out, num_valid=onv, voxel_size=voxels.voxel_size,
        tensor_stride=tuple(out_ts), lex_sorted=pooled_sorted,
    )
    return pooled, table


def sparse_max_pool(voxels, kernel_size, stride=None, out_capacity=None):
    stride = stride if stride is not None else kernel_size
    return sparse_reduce(voxels, kernel_size, stride, "max", out_capacity)


def sparse_avg_pool(voxels, kernel_size, stride=None, out_capacity=None):
    stride = stride if stride is not None else kernel_size
    return sparse_reduce(voxels, kernel_size, stride, "mean", out_capacity)


def sparse_unpool(
    coarse: Voxels,
    fine_coords_voxels: Voxels,
    table: BatchedPairTable,
    concat_features: Optional[torch.Tensor] = None,
) -> Voxels:
    """Give each fine row its coarse parent's features through the pooling
    map's reverse table (JAX ``sparse_unpool``): where a fine row has
    several entries the last offset's wins, as in the JAX scan. With
    ``concat_features`` the result is ``[concat_features, unpooled]`` on the
    channel axis. Pad rows are zero."""
    rev = table.rev  # [B, K, N_fine]
    k_ids = torch.arange(rev.shape[1], device=rev.device)[None, :, None]
    k_last = torch.where(rev >= 0, k_ids, -1).amax(dim=1)  # [B, N_fine]
    parent = torch.gather(rev, 1, k_last.clamp(min=0)[:, None]).squeeze(1)
    out = _gather_rows(coarse.features, torch.where(k_last >= 0, parent, -1))
    if concat_features is not None:
        out = torch.cat([concat_features, out], dim=-1)
    out = torch.where(fine_coords_voxels.valid_mask()[..., None], out, 0)
    return fine_coords_voxels.replace(features=out)


def global_pool(geometry, reduction: str = "max") -> torch.Tensor:
    """Per-scene reduce over valid rows -> [B, C] (JAX ``global_pool``)."""
    feats = geometry.features
    mask = geometry.valid_mask()[..., None]
    if reduction == "max":
        out = torch.where(mask, feats, float("-inf")).amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0)
    if reduction == "sum":
        return torch.where(mask, feats, 0).sum(dim=1)
    if reduction == "mean":
        s = torch.where(mask, feats, 0).sum(dim=1)
        return s / geometry.num_valid.clamp(min=1).to(feats.dtype)[:, None]
    raise ValueError(f"unsupported reduction {reduction!r}")
