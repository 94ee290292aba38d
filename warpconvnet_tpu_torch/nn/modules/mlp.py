"""Linear layers on geometry features (counterpart of
``warpconvnet_tpu/nn/modules/mlp.py``): :func:`dense`, :class:`Linear` and
:class:`BatchedLinear`. Weights follow flax's ``Dense`` init (LeCun normal,
zero bias), drawn on the CPU from an explicit ``torch.Generator`` and
placed on ``device`` (the card unless the caller asks for another)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.nn.modules.blocks import lecun_normal


def dense(
    in_features: int,
    out_features: int,
    bias: bool = True,
    device: constants.Device = constants.DEFAULT_DEVICE,
    generator: Optional[torch.Generator] = None,
) -> nn.Linear:
    """``nn.Linear`` (weight [out, in]) with flax ``Dense``'s init."""
    lin = nn.Linear(in_features, out_features, bias=bias, device=constants.resolve_device(device))
    with torch.no_grad():
        lin.weight.copy_(lecun_normal(lin.weight.shape, in_features, generator))
        if bias:
            lin.bias.zero_()
    return lin


class Linear(nn.Module):
    """Dense layer on a geometry's features, pad rows zeroed (JAX
    ``Linear``, ``mlp.py:15-25``)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        use_bias: bool = True,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dense = dense(in_features, out_features, use_bias, device, generator)

    def forward(self, geometry):
        out = self.dense(geometry.features)
        out = torch.where(geometry.valid_mask()[..., None], out, 0)
        return geometry.replace_features(out)


class BatchedLinear(nn.Module):
    """S stacked linear maps with one [S, D_in, D_out] weight and an
    [S, D_out] bias (JAX ``BatchedLinear``, ``mlp.py:57-73``, the fused QKV
    projection): x [..., D_in] -> [..., S, D_out]."""

    def __init__(
        self,
        num_stacks: int,
        in_features: int,
        out_features: int,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = constants.resolve_device(device)
        shape = (num_stacks, in_features, out_features)
        self.weight = nn.Parameter(lecun_normal(shape, in_features, generator).to(device))
        self.bias = nn.Parameter(torch.zeros((num_stacks, out_features), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...c,scd->...sd", x, self.weight) + self.bias
