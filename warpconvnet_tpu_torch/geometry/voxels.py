"""Sparse voxel geometry (counterpart of ``warpconvnet_tpu/geometry/voxels.py``).

Batched-padded layout: coords int32 ``[B, N, 3]`` (``PAD_COORD`` on pad
rows, valid rows first), features ``[B, N, C]``, num_valid int32 ``[B]``.
``voxel_size``, ``tensor_stride`` and ``lex_sorted`` are metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.base import GeometryMixin
from warpconvnet_tpu_torch.ops.keys import PAD_COORD, argsort_keys, coord_keys


def _as3(v) -> Tuple:
    if isinstance(v, (int, float, np.integer, np.floating)):
        return (v,) * 3
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class Voxels(GeometryMixin):
    """Batch of sparse voxel grids.

    ``lex_sorted`` records that each scene's coords are in lexicographic
    (x, y, z) order, the coordinate engine's canonical order. It is set by
    :meth:`lex_sort` and by conv outputs, and lets kernel-map construction
    search the coords directly instead of sorting them first.
    """

    coords: torch.Tensor
    features: torch.Tensor
    num_valid: torch.Tensor
    voxel_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    tensor_stride: Tuple[int, int, int] = (1, 1, 1)
    lex_sorted: bool = False

    def __post_init__(self):
        if self.coords.ndim != 3 or self.coords.shape[-1] != 3:
            raise ValueError(f"coords must be [B, N, 3], got {tuple(self.coords.shape)}")
        if self.features.ndim != 3:
            raise ValueError(f"features must be [B, N, C], got {tuple(self.features.shape)}")

    @classmethod
    def create(
        cls,
        coords,
        features,
        num_valid,
        voxel_size=1.0,
        tensor_stride=1,
        device: constants.Device = constants.DEFAULT_DEVICE,
    ) -> "Voxels":
        """Build from arrays or tensors, placed on ``device`` (the card
        unless the caller asks for another; raises if there is none)."""
        device = constants.resolve_device(device)
        return cls(
            coords=torch.as_tensor(coords, device=device).to(torch.int32),
            features=torch.as_tensor(features, device=device),
            num_valid=torch.as_tensor(num_valid, device=device).to(torch.int32),
            voxel_size=_as3(float(voxel_size) if np.isscalar(voxel_size) else voxel_size),
            tensor_stride=tuple(int(s) for s in _as3(tensor_stride)),
        )

    def to(self, device) -> "Voxels":
        return self.replace(
            coords=self.coords.to(device),
            features=self.features.to(device),
            num_valid=self.num_valid.to(device),
        )

    @tracing.spanned("wcn.map.lex_sort")
    def lex_sort(self) -> "Voxels":
        """Sort each scene's rows lexicographically (x, y, z ascending); pad
        rows go last in their original order (a stable sort, like the JAX
        ``lax.sort``)."""
        valid = self.valid_mask()
        c = torch.where(valid[..., None], self.coords, PAD_COORD)
        _, perm = argsort_keys(coord_keys(c))
        coords = torch.gather(self.coords, 1, perm[..., None].expand(-1, -1, 3))
        feats = torch.gather(
            self.features, 1, perm[..., None].expand(-1, -1, self.num_channels)
        )
        return self.replace(coords=coords, features=feats, lex_sorted=True)
