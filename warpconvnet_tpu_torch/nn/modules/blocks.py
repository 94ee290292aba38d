"""Composite sparse blocks (counterpart of
``warpconvnet_tpu/nn/modules/blocks.py``): :class:`SparseConvNeXtBlock`."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseDepthwiseConv3d


def lecun_normal(
    shape, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """CPU fp32 tensor from flax's default ``Dense`` init: a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at +-2
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    return t


class SparseConvNeXtBlock(nn.Module):
    """Depthwise conv -> LayerNorm -> pointwise expand -> GELU -> project,
    with a layer-scale residual (JAX ``SparseConvNeXtBlock``,
    ``blocks.py:25-50``).

    Numerics follow flax: LayerNorm (eps 1e-6) and the Dense layers run in
    fp32 whatever the features' dtype, GELU is the tanh approximation, and
    ``x + layer_scale * f`` promotes to fp32, so bf16 features give an fp32
    output. Pad rows come out zero.
    """

    def __init__(
        self,
        channels: int,
        kernel_size: int = 7,
        expand_ratio: float = 4.0,
        layer_scale_init: float = 1e-6,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = constants.resolve_device(device)
        hidden = int(channels * expand_ratio)
        self.dwconv = SparseDepthwiseConv3d(
            channels, kernel_size, device=device, generator=generator
        )
        self.norm = nn.LayerNorm(channels, eps=1e-6, device=device)
        self.pwconv1 = nn.Linear(channels, hidden, device=device)
        self.pwconv2 = nn.Linear(hidden, channels, device=device)
        with torch.no_grad():
            for lin in (self.pwconv1, self.pwconv2):
                lin.weight.copy_(lecun_normal(lin.weight.shape, lin.in_features, generator))
                lin.bias.zero_()
        self.layer_scale = nn.Parameter(torch.full((channels,), layer_scale_init, device=device))

    def forward(self, x: Voxels) -> Voxels:
        h, _ = self.dwconv(x)
        f = self.norm(h.features.float())
        f = F.gelu(self.pwconv1(f), approximate="tanh")
        f = self.pwconv2(f)
        f = x.features + self.layer_scale * f
        f = torch.where(x.valid_mask()[..., None], f, 0)
        return x.replace(features=f)
