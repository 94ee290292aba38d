"""Seeded weights, made by the benchmark on the device: one uniform draw
for every parameter of the configuration's reference spec, with a CUDA
``torch.Generator`` where the device is the card, then scaled leaf by leaf.
The program and the reference receive the same tensors; neither makes its
own."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness.traffic import torch_generator

_BOUND = {"kaiming": 6.0, "lecun": 3.0}  # uniform bound sqrt(c / fan)


def make(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} for ``spec`` [(name, shape, init, fan)]."""
    total = sum(math.prod(shape) for _, shape, init, _ in spec if init in _BOUND)
    g = torch_generator(seed, 4, device)
    draw = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=g)
    out, at = {}, 0
    for name, shape, init, fan in spec:
        if init in _BOUND:
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape) * math.sqrt(_BOUND[init] / fan)
            at += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters; the names and shapes
    must be exactly the model's."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"parameters differ from the spec: model only {sorted(set(params) - set(weights))[:5]}, "
            f"spec only {sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: model {tuple(p.shape)}, spec {tuple(weights[name].shape)}")
            p.copy_(weights[name])
