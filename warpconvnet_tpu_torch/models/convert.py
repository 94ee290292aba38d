"""Carry JAX variables over to the port's modules: a MinkUNet, a Volt, a
Point Transformer V3, a ``SparseConvNeXtBlock``, and a single sparse conv
(dense, grouped or depthwise).

The JAX package's flax tree ``{"params": ..., "batch_stats": ...}`` names a
layer by scope and creation order (``block1_0/SparseConv3d_2/kernel``);
the port names it by role (``block1.0.proj.weight``). Sparse-conv kernels
share their layout ([K, C_in, C_out], [K, G, C_in/G, C_out/G], [K, C]), so
values copy as they are; a flax ``Dense`` kernel [in, out] becomes a
``Linear`` weight [out, in]. Leaves are numpy (or anything ``np.array``
takes).
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


def _checked(out: Dict[str, torch.Tensor], model: Optional[nn.Module]):
    """Raise on any of ``model``'s state-dict entries left without a value,
    on values it has no entry for, and on shape mismatches."""
    if model is None:
        return out
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {extra}")
    for name, value in out.items():
        if tuple(value.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(want[name].shape)}")
    return out


def _leaf(value, transpose: bool = False) -> torch.Tensor:
    a = np.array(value, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T) if transpose else a)


# JAX SparseConvNeXtBlock path -> (port name, flax Dense kernel to transpose).
_CONVNEXT = {
    ("params", "dwconv", "kernel"): ("dwconv.weight", False),
    ("params", "dwconv", "bias"): ("dwconv.bias", False),
    ("params", "LayerNorm_0", "scale"): ("norm.weight", False),
    ("params", "LayerNorm_0", "bias"): ("norm.bias", False),
    ("params", "Dense_0", "kernel"): ("pwconv1.weight", True),
    ("params", "Dense_0", "bias"): ("pwconv1.bias", False),
    ("params", "Dense_1", "kernel"): ("pwconv2.weight", True),
    ("params", "Dense_1", "bias"): ("pwconv2.bias", False),
    ("params", "layer_scale"): ("layer_scale", False),
}
# A single SparseConv3d or SparseDepthwiseConv3d.
_CONV = {("params", "kernel"): ("weight", False), ("params", "bias"): ("bias", False)}


def _map_tree(variables: Mapping, names) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in _flatten(variables):
        if path not in names:
            raise KeyError(f"unmapped variable {'/'.join(path)}")
        name, transpose = names[path]
        out[name] = _leaf(value, transpose)
    return out


def convnext_block_variables_to_state_dict(
    variables: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Map a JAX ``SparseConvNeXtBlock`` variable tree (``{"params": ...}``,
    or its gradients in the same layout) onto the port's
    :class:`SparseConvNeXtBlock` names. Raises on an unmapped JAX variable;
    given ``model``, also on missing entries and shape mismatches."""
    return _checked(_map_tree(variables, _CONVNEXT), model)


def conv_variables_to_state_dict(
    variables: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Map the variables of one JAX ``SparseConv3d`` (dense or grouped) or
    ``SparseDepthwiseConv3d`` onto the port module's ``weight``/``bias``.
    Raises as :func:`convnext_block_variables_to_state_dict` does."""
    return _checked(_map_tree(variables, _CONV), model)


# Inside a JAX VoltBlock scope (block{i}): path below the scope -> (port
# name below blocks.{i}, flax Dense kernel to transpose).
_VOLT_BLOCK = {
    ("LayerNorm_0", "scale"): ("norm1.weight", False),
    ("LayerNorm_0", "bias"): ("norm1.bias", False),
    ("LayerNorm_1", "scale"): ("norm2.weight", False),
    ("LayerNorm_1", "bias"): ("norm2.bias", False),
    ("attn", "qkv", "kernel"): ("attn.qkv.weight", False),  # [3, C, C] as it is
    ("attn", "qkv", "bias"): ("attn.qkv.bias", False),
    ("attn", "proj", "kernel"): ("attn.proj.weight", True),
    ("attn", "proj", "bias"): ("attn.proj.bias", False),
    ("mlp", "Dense_0", "kernel"): ("mlp.fc1.weight", True),
    ("mlp", "Dense_0", "bias"): ("mlp.fc1.bias", False),
    ("mlp", "Dense_1", "kernel"): ("mlp.fc2.weight", True),
    ("mlp", "Dense_1", "bias"): ("mlp.fc2.bias", False),
    ("ls1", "gamma"): ("ls1.gamma", False),
    ("ls2", "gamma"): ("ls2.gamma", False),
    ("token_conv", "conv", "kernel"): ("token_conv.conv.weight", False),
    ("token_conv", "LayerNorm_0", "scale"): ("token_conv.norm.weight", False),
    ("token_conv", "LayerNorm_0", "bias"): ("token_conv.norm.bias", False),
}
_VOLT_TOP = {
    ("stem1", "kernel"): ("stem1.weight", False),
    ("stem2", "kernel"): ("stem2.weight", False),
    ("tok_conv1", "kernel"): ("tok_conv1.weight", False),
    ("tok_conv2", "kernel"): ("tok_conv2.weight", False),
    ("tok_proj", "kernel"): ("tok_proj.weight", True),
    ("tok_proj", "bias"): ("tok_proj.bias", False),
    ("fuse", "kernel"): ("fuse.weight", True),
    ("fuse", "bias"): ("fuse.bias", False),
    ("head", "kernel"): ("head.weight", False),
    ("head", "bias"): ("head.bias", False),
}


def _volt_name(path, top_norms):
    collection, *scopes, leaf = path
    if collection == "params" and scopes:
        key = (*scopes, leaf)
        if key in _VOLT_TOP:
            return _VOLT_TOP[key]
        if len(scopes) == 1 and scopes[0] in top_norms and leaf in ("scale", "bias"):
            return f"{top_norms[scopes[0]]}.{'weight' if leaf == 'scale' else 'bias'}", False
        block = re.fullmatch(r"block(\d+)", scopes[0])
        if block and key[1:] in _VOLT_BLOCK:
            name, transpose = _VOLT_BLOCK[key[1:]]
            return f"blocks.{block[1]}.{name}", transpose
        conv = re.fullmatch(r"conv(\d+)", scopes[0])
        if conv and ("params", *key[1:]) in _CONVNEXT:
            name, transpose = _CONVNEXT[("params", *key[1:])]
            return f"conv_blocks.{conv[1]}.{name}", transpose
    raise KeyError(f"unmapped variable {'/'.join(path)}")


def volt_variables_to_state_dict(
    variables: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Map a JAX ``Volt`` variable tree (``{"params": ...}``, its gradients
    in the same layout, or a JAX ``TrainState`` after a step, whose
    ``params`` are taken: Volt has no batch statistics, and the optimizer
    state is left out) onto the port's :class:`Volt` names.

    flax names the unnamed top-level LayerNorms by creation order: the two
    stem norms, then the convblock tokenizer's two (when ``tok_conv1`` is
    present), then the trunk's final norm. Raises on an unmapped variable;
    given ``model``, also on missing entries and shape mismatches."""
    if hasattr(variables, "params") and hasattr(variables, "batch_stats"):
        variables = {"params": variables.params, "batch_stats": variables.batch_stats}
    convblock = "tok_conv1" in variables.get("params", {})
    norms = ["stem1_norm", "stem2_norm"] + (["tok_norm1", "tok_norm"] if convblock else [])
    top_norms = {f"LayerNorm_{i}": name for i, name in enumerate(norms + ["norm"])}
    out = {}
    for path, value in _flatten(variables):
        name, transpose = _volt_name(path, top_norms)
        out[name] = _leaf(value, transpose)
    return _checked(out, model)


# Inside a JAX PatchAttentionBlock scope (enc{i}_blk{d}, dec{i}_blk{d}):
# path below the scope -> (port name below enc.{i}.{d} / dec.{i}.{d}, flax
# Dense kernel to transpose).
_PTV3_BLOCK = {
    ("cpe_conv", "kernel"): ("cpe_conv.weight", False),
    ("cpe_conv", "bias"): ("cpe_conv.bias", False),
    ("cpe_proj", "kernel"): ("cpe_proj.weight", True),
    ("cpe_proj", "bias"): ("cpe_proj.bias", False),
    ("cpe_norm", "scale"): ("cpe_norm.weight", False),
    ("cpe_norm", "bias"): ("cpe_norm.bias", False),
    ("LayerNorm_0", "scale"): ("norm1.weight", False),
    ("LayerNorm_0", "bias"): ("norm1.bias", False),
    ("attn", "attn", "qkv", "kernel"): ("attn.attn.qkv.weight", False),  # [3, C, C] as it is
    ("attn", "attn", "qkv", "bias"): ("attn.attn.qkv.bias", False),
    ("attn", "attn", "proj", "kernel"): ("attn.attn.proj.weight", True),
    ("attn", "attn", "proj", "bias"): ("attn.attn.proj.bias", False),
    ("LayerNorm_1", "scale"): ("norm2.weight", False),
    ("LayerNorm_1", "bias"): ("norm2.bias", False),
    ("Dense_0", "kernel"): ("fc1.weight", True),
    ("Dense_0", "bias"): ("fc1.bias", False),
    ("Dense_1", "kernel"): ("fc2.weight", True),
    ("Dense_1", "bias"): ("fc2.bias", False),
}
# Norms and dense layers by scope: JAX scope pattern -> port prefix.
_PTV3_SCOPES = (
    (r"stem", "stem"),
    (r"stem_norm", "stem_norm"),
    (r"down(\d+)_proj", "down.{0}.proj"),
    (r"down(\d+)_norm", "down.{0}.norm"),
    (r"up(\d+)/(proj|proj_norm|proj_skip|skip_norm)", "up.{0}.{1}"),
    (r"final", "final"),
)


def _ptv3_name(path):
    collection, *scopes, leaf = path
    block = re.fullmatch(r"(enc|dec)(\d+)_blk(\d+)", scopes[0]) if scopes else None
    if collection == "params" and block and (*scopes[1:], leaf) in _PTV3_BLOCK:
        name, transpose = _PTV3_BLOCK[(*scopes[1:], leaf)]
        return f"{block[1]}.{block[2]}.{block[3]}.{name}", transpose
    attr = _LEAF.get((collection, leaf))
    for pattern, prefix in _PTV3_SCOPES:
        m = re.fullmatch(pattern, "/".join(scopes))
        if m and attr is not None:
            dense_kernel = leaf == "kernel" and not prefix.startswith("stem")
            return f"{prefix.format(*m.groups())}.{attr}", dense_kernel
    raise KeyError(f"unmapped variable {'/'.join(path)}")


def ptv3_variables_to_state_dict(
    variables: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Map a JAX ``PointTransformerV3`` variable tree (``{"params": ...,
    "batch_stats": ...}``, a tree of one collection such as gradients, or a
    JAX ``TrainState`` after a step, whose ``params`` and ``batch_stats``
    are taken) onto the port's :class:`PointTransformerV3` names. Raises on
    an unmapped variable; given ``model``, also on missing entries and
    shape mismatches."""
    if hasattr(variables, "params") and hasattr(variables, "batch_stats"):
        variables = {"params": variables.params, "batch_stats": variables.batch_stats}
    out = {}
    for path, value in _flatten(variables):
        name, transpose = _ptv3_name(path)
        out[name] = _leaf(value, transpose)
    return _checked(out, model)


def variables_to_state_dict(
    variables: Mapping, model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Map a JAX MinkUNet variable tree (numpy or jax leaves) onto port names.

    ``variables`` is ``{"params": ..., "batch_stats": ...}``, a tree of one
    collection (such as gradients, ``{"params": grads}``), or a JAX
    ``TrainState`` after a step, whose ``params`` and ``batch_stats`` are
    taken (its optimizer state is not).

    Raises on a JAX variable with no port counterpart; given ``model``, also
    on any of its state-dict entries left without a value, and on shape
    mismatches."""
    if hasattr(variables, "params") and hasattr(variables, "batch_stats"):
        variables = {"params": variables.params, "batch_stats": variables.batch_stats}
    return _checked({_port_name(path): _leaf(value) for path, value in _flatten(variables)}, model)
