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

from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels, _as3
from warpconvnet_tpu_torch.kernels.implicit_gemm import gather_rows
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    BatchedPairTable,
    generate_output_coords_and_kernel_map,
    table_output,
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
    and pad rows are zero (:func:`~.sparse_conv.table_output`). Returns
    (pooled voxels, map)."""
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
            acc = op(acc, torch.where((tk >= 0)[..., None], gather_rows(feats, tk), neutral))
        out = torch.where(count[..., None] > 0, acc, 0)
    else:
        acc = torch.zeros((b, m, c), dtype=torch.float32, device=feats.device)
        for k in range(t.shape[1]):
            acc += gather_rows(feats, t[:, k]).float()
        if reduction == "mean":
            acc = acc / count.clamp(min=1)[..., None]
        out = acc.to(feats.dtype)
    return table_output(voxels, oc, onv, out_ts, out, _as3(stride)), table


def sparse_max_pool(voxels, kernel_size, stride=None, out_capacity=None):
    stride = stride if stride is not None else kernel_size
    return sparse_reduce(voxels, kernel_size, stride, "max", out_capacity)


def sparse_avg_pool(voxels, kernel_size, stride=None, out_capacity=None):
    stride = stride if stride is not None else kernel_size
    return sparse_reduce(voxels, kernel_size, stride, "mean", out_capacity)


@tracing.spanned("wcn.map.unpool_parents")
def unpool_parents(rev: torch.Tensor) -> torch.Tensor:
    """[B, K, N_fine] reverse table -> [B, N_fine]: each fine row's coarse
    parent, from its last offset with an entry (as the JAX scan lets the
    last write win), or -1."""
    k_ids = torch.arange(rev.shape[1], device=rev.device)[None, :, None]
    k_last = torch.where(rev >= 0, k_ids, -1).amax(dim=1)  # [B, N_fine]
    parent = torch.gather(rev, 1, k_last.clamp(min=0)[:, None]).squeeze(1)
    return torch.where(k_last >= 0, parent, -1)


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
    out = gather_rows(coarse.features, unpool_parents(table.rev))
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
