"""Carry JAX MinkUNet variables over to the port's modules.

The JAX package's flax tree ``{"params": ..., "batch_stats": ...}`` names a
layer by scope and creation order (``block1_0/SparseConv3d_2/kernel``);
the port names it by role (``block1.0.proj.weight``). Kernels share the
``[K, C_in, C_out]`` layout, so values copy as they are.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# Per flax scope kind: creation-order module name -> port attribute.
_CONV_BLOCK = {"SparseConv3d_0": "conv", "BatchNorm_0": "norm"}
_BASIC_BLOCK = {
    "SparseConv3d_0": "conv1", "BatchNorm_0": "norm1",
    "SparseConv3d_1": "conv2", "BatchNorm_1": "norm2",
    "SparseConv3d_2": "proj", "BatchNorm_2": "proj_norm",
}
_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "mean",
    ("batch_stats", "var"): "var",
}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _port_name(path) -> str:
    collection, *scopes, leaf = path
    attr = _LEAF.get((collection, leaf))
    if attr is None:
        raise KeyError(f"unmapped variable {'/'.join(path)}")
    if scopes == ["final"]:
        return f"final.{attr}"
    if len(scopes) == 2:
        scope, module = scopes
        if re.fullmatch(r"conv\d+|convtr\d+", scope) and module in _CONV_BLOCK:
            return f"{scope}.{_CONV_BLOCK[module]}.{attr}"
        block = re.fullmatch(r"(block\d+)_(\d+)", scope)
        if block and module in _BASIC_BLOCK:
            return f"{block[1]}.{block[2]}.{_BASIC_BLOCK[module]}.{attr}"
    raise KeyError(f"unmapped variable {'/'.join(path)}")


def variables_to_state_dict(
    variables: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Map a JAX MinkUNet variable tree (numpy leaves) onto port names.

    Raises on a JAX variable with no port counterpart; given ``model``, also
    on any of its state-dict entries left without a value, and on shape
    mismatches."""
    out = {}
    for path, value in _flatten(variables):
        out[_port_name(path)] = torch.from_numpy(np.array(value, np.float32))
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(out))
        extra = sorted(set(out) - set(want))
        if missing or extra:
            raise KeyError(f"state dict mismatch: missing {missing}, unexpected {extra}")
        for name, value in out.items():
            if tuple(value.shape) != tuple(want[name].shape):
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} != {tuple(want[name].shape)}"
                )
    return out
