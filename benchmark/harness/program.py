"""The system under test, ``warpconvnet_tpu_torch``: the one module of the
benchmark that imports it. It builds the configuration's model through
its entry point, sets the conv compute dtype, turns a traffic item into
the program's ``Voxels`` as a data loader would, and gives the two timed
entries: the segmentation train step and the forward."""

from __future__ import annotations

import importlib

import torch


def build(cfg: dict, device) -> torch.nn.Module:
    """``cfg["entry"]``: ``{"callable": "module:name", "args": [...],
    "kwargs": {...}}``, called with ``device``. The program's own
    initialisation is overwritten by the benchmark's weights."""
    entry = cfg["entry"]
    mod, name = entry["callable"].split(":")
    fn = getattr(importlib.import_module(mod), name)
    return fn(*entry.get("args", []), **entry.get("kwargs", {}), device=device,
              generator=torch.Generator().manual_seed(0))


def set_compute_dtype(cfg: dict) -> None:
    from warpconvnet_tpu_torch import constants

    constants.set_compute_dtype(cfg["conv_dtype"])


def voxels(item, device):
    """The item as the program's sorted ``Voxels`` (pad rows at the
    program's pad coordinate)."""
    from warpconvnet_tpu_torch.geometry.voxels import Voxels
    from warpconvnet_tpu_torch.ops.keys import PAD_COORD

    n = item.coords.shape[1]
    valid = torch.arange(n, device=item.coords.device)[None, :] < item.num_valid[:, None]
    coords = torch.where(valid[..., None], item.coords, PAD_COORD)
    return Voxels.create(coords, item.features, item.num_valid, device=device).lex_sort()


def train_step(model: torch.nn.Module, cfg: dict):
    """(``step(voxels, labels) -> {"loss", "acc"}``, its optimizer)."""
    from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

    opt = cfg["optimizer"]
    optimizer = torch.optim.Adam(model.parameters(), lr=opt["lr"])
    return make_segmentation_train_step(model, optimizer, cfg["num_classes"]), optimizer


def forward(model: torch.nn.Module, vox) -> torch.Tensor:
    """Per-voxel logits [B, N, classes]."""
    return model(vox).features
