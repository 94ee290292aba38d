"""Masked batch norm over geometry features (counterpart of
``warpconvnet_tpu/nn/modules/norms.py`` ``BatchNorm``)."""

from __future__ import annotations

import torch
from torch import nn

from warpconvnet_tpu_torch.nn.functional import normalizations as F


class BatchNorm(nn.Module):
    """Batch norm over the valid rows of all scenes.

    Train mode normalises with the masked batch statistics (biased variance,
    pad rows excluded) and updates the running ``mean``/``var`` buffers with
    ``momentum`` as the weight of the old value; eval mode uses the running
    statistics. Parameters and statistics are cast to the feature dtype.
    """

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, geometry):
        x = geometry.features
        mask = geometry.valid_mask()
        if self.training:
            mean, var = F.masked_batch_stats(x.float(), mask)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        out = F.batch_norm(
            x, mask, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps,
            mean.to(x.dtype), var.to(x.dtype),
        )
        return geometry.replace_features(out)
