"""Sparse convolution modules (counterpart of
``warpconvnet_tpu/nn/modules/sparse_conv.py``).

Weight layouts: [K, C_in, C_out] dense, [K, G, C_in/G, C_out/G] grouped,
[K, C] depthwise. Kaiming-uniform init with fan = K * C_in (per group; K *
C_out when transposed), drawn on the CPU from an explicit
``torch.Generator`` so that a seed gives the same weights on every device,
then placed on ``device`` (the card unless the caller asks for another).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.geometry.voxels import Voxels, _as3
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    BatchedPairTable,
    spatially_sparse_conv,
)
from warpconvnet_tpu_torch.nn.functional.sparse_conv_depth import (
    spatially_sparse_depthwise_conv,
)


def kaiming_uniform(
    shape: Tuple[int, ...], transposed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """CPU fp32 tensor U(-b, b), b = sqrt(6 / fan), fan = K * (C_out if
    transposed else C_in) for [K, C_in, C_out], [K, G, C_in/G, C_out/G]
    (per-group widths) and [K, C] (C_in = C_out = C), as the JAX
    ``_kaiming_uniform``."""
    if len(shape) == 4:
        k, _, cin, cout = shape
    elif len(shape) == 3:
        k, cin, cout = shape
    else:
        k, cin = shape
        cout = cin
    bound = math.sqrt(6.0 / (k * (cout if transposed else cin)))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class SparseConv3d(nn.Module):
    """3D spatially sparse convolution over :class:`Voxels`.

    ``forward(voxels, out_coords=None, pair_table=None, out_capacity=None)`` returns
    ``(out_voxels, pair_table)`` so callers can reuse kernel maps. With
    ``groups > 1`` the weight is [K, G, C_in/G, C_out/G].
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Sequence[int]] = 3,
        stride: Union[int, Sequence[int]] = 1,
        transposed: bool = False,
        use_bias: bool = False,
        groups: int = 1,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels}->{out_channels} not divisible by {groups} groups")
        device = constants.resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size: Tuple[int, int, int] = tuple(int(k) for k in _as3(kernel_size))
        self.stride = stride
        self.transposed = transposed
        self.groups = groups
        k = int(np.prod(self.kernel_size))
        shape = (k, in_channels, out_channels)
        if groups > 1:
            shape = (k, groups, in_channels // groups, out_channels // groups)
        self.weight = nn.Parameter(kaiming_uniform(shape, transposed, generator).to(device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias else None

    def forward(
        self,
        voxels: Voxels,
        out_coords: Optional[Voxels] = None,
        pair_table: Optional[BatchedPairTable] = None,
        out_capacity: Optional[int] = None,
    ) -> Tuple[Voxels, Optional[BatchedPairTable]]:
        """``out_capacity`` bounds the padded row count of a strided output
        (default: the input's)."""
        return spatially_sparse_conv(
            voxels,
            self.weight,
            kernel_size=self.kernel_size,
            stride=self.stride,
            bias=self.bias,
            transposed=self.transposed,
            out_coords=out_coords,
            pair_table=pair_table,
            out_capacity=out_capacity,
            groups=self.groups,
        )


class SparseDepthwiseConv3d(nn.Module):
    """Depthwise sparse conv (counterpart of the JAX
    ``SparseDepthwiseConv3d``, ``nn/modules/sparse_conv.py:135-177``).
    Weight [K, C]; ``forward`` returns ``(out_voxels, pair_table)``."""

    def __init__(
        self,
        channels: int,
        kernel_size: Union[int, Sequence[int]] = 3,
        stride: Union[int, Sequence[int]] = 1,
        use_bias: bool = False,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = constants.resolve_device(device)
        self.channels = channels
        self.kernel_size: Tuple[int, int, int] = tuple(int(k) for k in _as3(kernel_size))
        self.stride = stride
        k = int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(kaiming_uniform((k, channels), False, generator).to(device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device)) if use_bias else None

    def forward(
        self,
        voxels: Voxels,
        out_coords: Optional[Voxels] = None,
        pair_table: Optional[BatchedPairTable] = None,
        out_capacity: Optional[int] = None,
    ) -> Tuple[Voxels, Optional[BatchedPairTable]]:
        return spatially_sparse_depthwise_conv(
            voxels,
            self.weight,
            kernel_size=self.kernel_size,
            stride=self.stride,
            bias=self.bias,
            out_coords=out_coords,
            pair_table=pair_table,
            out_capacity=out_capacity,
        )
