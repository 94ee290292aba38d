"""Plain PyTorch reference of MinkUNet with BasicBlock stages (Choy et al.,
CVPR 2019; the layout of WarpConvNet's ``models/mink_unet.py``), for the
benchmark's ``correct``.

Stem: 1x1 conv, BN, ReLU. Encoder stage s (s = 0..3): a 2^3 stride-2 conv,
BN, ReLU, then ``layers[s]`` BasicBlocks (two 3^3 submanifold convs with
BN, ReLU and a residual; a 1x1 conv and BN on the residual where the width
changes). Decoder stage s: a 2^3 transposed conv onto the level above,
BN, ReLU, the skip of that level concatenated after it, and
``layers[4 + s]`` BasicBlocks. Head: a 1x1 conv with bias.

fp32 throughout (TF32 off), written from that description; it imports
nothing of the measured program. In training each BasicBlock keeps only
its input and is recomputed in the backward (activation checkpointing),
so that a step over eight scenes of 262144 rows fits on one card. The
control (``precision="control"``) holds in fp8 every tensor the measured
model holds in bf16 under its bf16 compute dtype: the conv operands and
outputs, the BN outputs and the residual sums, forward and backward.
Parameters are a dict keyed by the measured model's parameter names.
Levels follow the padded layout of the measured model: level i keeps the
first ``max(n_cap >> i, floor)`` cells in lexicographic order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.models import sparse


def _block_names(cfg) -> List[Tuple[str, int, int]]:
    """(prefix, C_in, C_out) of every BasicBlock, stage by stage."""
    p, layers, init = cfg["planes"], cfg["layers"], cfg["init_dim"]
    enc_in = (init, p[0], p[1], p[2])
    skip = (p[2], p[1], p[0], init)
    out = []
    for s in range(4):
        for i in range(layers[s]):
            out.append((f"block{s + 1}.{i}", enc_in[s] if i == 0 else p[s], p[s]))
    for s in range(4):
        for i in range(layers[4 + s]):
            cin = p[4 + s] + skip[s] if i == 0 else p[4 + s]
            out.append((f"block{5 + s}.{i}", cin, p[4 + s]))
    return out


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan) of every parameter: ``kaiming`` uniform with
    bound sqrt(6 / fan), ``ones`` or ``zeros``."""
    p, init, cin0 = cfg["planes"], cfg["init_dim"], cfg["in_channels"]
    spec = []

    def conv(name, k, ci, co, transposed=False):
        spec.append((name, (k, ci, co), "kaiming", k * (co if transposed else ci)))

    def norm(name, c):
        spec.append((f"{name}.weight", (c,), "ones", 0))
        spec.append((f"{name}.bias", (c,), "zeros", 0))

    conv("conv0.conv.weight", 1, cin0, init)
    norm("conv0.norm", init)
    enc_in = (init, p[0], p[1], p[2])
    for s in range(4):
        conv(f"conv{s + 1}.conv.weight", 8, enc_in[s], enc_in[s])
        norm(f"conv{s + 1}.norm", enc_in[s])
    dec_in = p[3]
    for s in range(4):
        conv(f"convtr{4 + s}.conv.weight", 8, dec_in, p[4 + s], transposed=True)
        norm(f"convtr{4 + s}.norm", p[4 + s])
        dec_in = p[4 + s]
    for name, ci, co in _block_names(cfg):
        conv(f"{name}.conv1.weight", 27, ci, co)
        norm(f"{name}.norm1", co)
        conv(f"{name}.conv2.weight", 27, co, co)
        norm(f"{name}.norm2", co)
        if ci != co:
            conv(f"{name}.proj.weight", 1, ci, co)
            norm(f"{name}.proj_norm", co)
    conv("final.weight", 1, dec_in, cfg["num_classes"])
    spec.append(("final.bias", (cfg["num_classes"],), "zeros", 0))
    return spec


def _bn(x, w, b, train: bool, eps: float = 1e-5):
    """Batch norm over all rows of the batch (biased variance) in training;
    in eval the running statistics of a model that has not trained yet,
    mean 0 and variance 1."""
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = torch.zeros_like(w), torch.ones_like(w)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def forward(params: Dict[str, torch.Tensor], scenes: List[Tuple[torch.Tensor, torch.Tensor]],
            cfg, n_cap: int, train: bool, precision: str = "reference") -> List[torch.Tensor]:
    """Logits [n_b, classes] of each scene (coords [n_b, 3] in lexicographic
    order, features [n_b, C_in] fp32), rows in that order."""
    conv_mm = sparse.matmul_for(precision)
    q = sparse.rounding_for(precision)  # every tensor the program holds in bf16

    def mm(a, b):
        return q(conv_mm(a, b))

    P = params
    caps = sparse.level_caps(n_cap, 5, cfg["level_cap_floor"])
    batch = sparse.make_batch([c for c, _ in scenes], caps)
    subs = {}

    def sub(lv):
        if lv not in subs:
            subs[lv] = sparse.submanifold_map(batch, lv)
        return subs[lv]

    pars = [sparse.parity_map(batch, lv) for lv in range(4)]
    relu = torch.relu

    def bn(x, name):
        return q(_bn(x, P[f"{name}.weight"], P[f"{name}.bias"], train))

    def block(x, name, lv):
        out = relu(bn(q(sparse.conv_sub(x, P[f"{name}.conv1.weight"], sub(lv), conv_mm)),
                      f"{name}.norm1"))
        out = bn(q(sparse.conv_sub(out, P[f"{name}.conv2.weight"], sub(lv), conv_mm)),
                 f"{name}.norm2")
        res = x
        if f"{name}.proj.weight" in P:
            res = bn(mm(x, P[f"{name}.proj.weight"][0]), f"{name}.proj_norm")
        return relu(q(out + res))

    def stage(x, idx, lv):
        i = 0
        while f"block{idx}.{i}.conv1.weight" in P:
            if x.requires_grad:
                x = checkpoint(block, x, f"block{idx}.{i}", lv, use_reentrant=False)
            else:
                x = block(x, f"block{idx}.{i}", lv)
            i += 1
        return x

    x = torch.cat([f for _, f in scenes])
    x = relu(bn(mm(x, P["conv0.conv.weight"][0]), "conv0.norm"))
    skips = [x]
    for s in range(4):
        x = relu(bn(q(sparse.conv_down(x, P[f"conv{s + 1}.conv.weight"], pars[s], conv_mm)),
                    f"conv{s + 1}.norm"))
        x = stage(x, s + 1, s + 1)
        skips.append(x)
    for s in range(4):
        lv = 3 - s
        x = relu(bn(q(sparse.conv_up(x, P[f"convtr{4 + s}.conv.weight"], pars[lv], conv_mm)),
                    f"convtr{4 + s}.norm"))
        x = torch.cat([x, skips[lv]], dim=1)
        x = stage(x, 5 + s, lv)
    logits = mm(x, P["final.weight"][0]) + P["final.bias"]
    return sparse.split_rows(logits, batch.rows[0])
