"""Sparse convolution module (counterpart of
``warpconvnet_tpu/nn/modules/sparse_conv.py``).

Weight layout [K, C_in, C_out]; kaiming-uniform init with fan = K * C_in
(K * C_out when transposed), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from warpconvnet_tpu_torch.geometry.voxels import Voxels, _as3
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    BatchedPairTable,
    spatially_sparse_conv,
)


def kaiming_uniform_(
    weight: torch.Tensor, transposed: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """U(-b, b) with b = sqrt(6 / fan), fan = K * (C_out if transposed else C_in)."""
    k, cin, cout = weight.shape
    bound = math.sqrt(6.0 / (k * (cout if transposed else cin)))
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


class SparseConv3d(nn.Module):
    """3D spatially sparse convolution over :class:`Voxels`.

    ``forward(voxels, out_coords=None, pair_table=None, out_capacity=None)`` returns
    ``(out_voxels, pair_table)`` so callers can reuse kernel maps.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Sequence[int]] = 3,
        stride: Union[int, Sequence[int]] = 1,
        transposed: bool = False,
        use_bias: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size: Tuple[int, int, int] = tuple(int(k) for k in _as3(kernel_size))
        self.stride = stride
        self.transposed = transposed
        k = int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(torch.empty(k, in_channels, out_channels))
        kaiming_uniform_(self.weight, transposed, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

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
        )
