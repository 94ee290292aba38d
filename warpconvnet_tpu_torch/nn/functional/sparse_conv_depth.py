"""Spatially sparse depthwise convolution (counterpart of
``warpconvnet_tpu/nn/functional/sparse_conv_depth.py``).

The map is the dense conv's (``generate_output_coords_and_kernel_map``):
stride 1 (submanifold, or onto ``out_coords``) or a parity-partition strided
map. Every depthwise conv runs through the dense conv's route
(``sparse_conv.conv_over_map``, :class:`~.sparse_conv.TableConv`) with the
kernels of :data:`DEPTHWISE`: forward K6; backward K8 on a symmetric
self-map, otherwise K6 as dgrad through ``rev`` plus K7. The JAX package
picks between its explicit scan and the Pallas kernels per direction
because of the TPU's gather windows; a Hopper kernel gathers rows by index,
so the port has one rule and no knob.

Unlike the dense conv, features keep their dtype (no compute-dtype cast),
the weight is taken in the accumulation dtype, as the JAX scans multiply in
it (``sparse_conv_depth.py:66-78``), and the kernels take no row order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import depthwise_fma
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    BatchedPairTable,
    TableKernels,
    conv_over_map,
)

DEPTHWISE = TableKernels(depthwise_fma, "depthwise_fma", ordered=False, tag="dw-")


def spatially_sparse_depthwise_conv(
    voxels: Voxels,
    weight: torch.Tensor,  # [K, C]
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int = 1,
    bias: Optional[torch.Tensor] = None,
    out_coords: Optional[Voxels] = None,
    pair_table: Optional[BatchedPairTable] = None,
    out_capacity: Optional[int] = None,
) -> Tuple[Voxels, BatchedPairTable]:
    """Depthwise sparse conv over :class:`Voxels`, differentiable in the
    features, ``weight`` and ``bias``. Returns (output voxels, kernel map);
    the map can be fed back as ``pair_table`` with ``out_coords``.

    Strides other than 1 and the power-of-two kernel == stride parity
    partition raise ``NotImplementedError``, as in the dense conv."""
    return conv_over_map(voxels, voxels.features, weight.to(constants.accum_dtype()), DEPTHWISE,
                         kernel_size, stride, bias, out_coords, pair_table, out_capacity)
