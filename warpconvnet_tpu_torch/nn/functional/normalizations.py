"""Masked normalization over batched-padded features (counterpart of
``warpconvnet_tpu/nn/functional/normalizations.py:36-64``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_batch_stats(
    x: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over the valid rows of
    [B, N, C] (mask [B, N])."""
    m = mask[..., None].to(x.dtype)
    count = torch.clamp(m.sum(), min=1)
    mean = (x * m).sum(dim=(0, 1)) / count
    var = ((x - mean).square() * m).sum(dim=(0, 1)) / count
    return mean, var


def batch_norm(
    x: torch.Tensor,
    mask: torch.Tensor,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked batch norm; pass (mean, var) for inference with running
    statistics. Pad rows come out zero."""
    if mean is None or var is None:
        mean, var = masked_batch_stats(x, mask)
    out = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return torch.where(mask[..., None], out, 0)
