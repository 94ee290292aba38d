"""Segmentation training step (counterpart of
``warpconvnet_tpu/parallel/train.py:37-68``), for any model that maps
:class:`Voxels` to per-voxel logits: MinkUNet (train-mode BatchNorm, K1-K4)
and Volt (the segment-attention backward K9-dkv / K9-dq as well).

One step is a train-mode forward (batch statistics, running statistics
updated), masked softmax cross-entropy in fp32, backward and an optimizer
step. The JAX package's sharding (``shard_train_state``, ``mesh.py``) is not
ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from warpconvnet_tpu_torch.geometry.voxels import Voxels


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean softmax cross-entropy, accuracy) over the rows where ``mask``
    is set; logits [B, N, C] are taken in fp32, labels [B, N] int."""
    logits = logits.float()
    ce = nn.functional.cross_entropy(
        logits.flatten(0, 1), labels.flatten().long(), reduction="none"
    ).view(labels.shape)
    m = mask.to(logits.dtype)
    count = torch.clamp(m.sum(), min=1)
    loss = (ce * m).sum() / count
    acc = ((logits.argmax(-1) == labels).to(logits.dtype) * m).sum() / count
    return loss, acc


def make_segmentation_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, num_classes: int
) -> Callable[[Voxels, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns ``step(voxels, labels) -> {"loss", "acc"}`` (0-d tensors on
    the model's device). Labels are [B, N]; pad rows are ignored through the
    validity mask. ``optimizer`` holds ``model``'s parameters, e.g.
    ``torch.optim.Adam(model.parameters(), lr=1e-3)``, which applies the
    ``optax.adam(1e-3)`` update."""

    def step(voxels: Voxels, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(voxels).features
        if logits.shape[-1] != num_classes:
            raise ValueError(f"model gives {logits.shape[-1]} classes, want {num_classes}")
        loss, acc = masked_cross_entropy(logits, labels, voxels.valid_mask())
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "acc": acc.detach()}

    return step
