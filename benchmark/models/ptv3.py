"""Plain PyTorch reference of Point Transformer V3 (Wu et al., "Point
Transformer V3: Simpler, Faster, Stronger", CVPR 2024; the layout of
WarpConvNet's ``models/point_transformer_v3.py``), for the benchmark's
``correct``.

Stem: a 5^3 submanifold conv (no bias), BN, GELU. Encoder level i: blocks
of [xCPE: x + LN(dense(conv3(x) + bias)); x + proj(attention(LN(x)));
x + fc2(gelu(fc1(LN(x))))], then (below the last level) stride-2 grid max
pooling: a dense layer, the max over each 2^3 cell's rows, BN, GELU.
Decoder level i: unpooling, gelu(BN(dense(coarse))) given to each finer
row of its cell plus gelu(BN(dense(skip))), then its blocks. Head: a dense
layer. Q/K/V come from one [3, C, C] weight with a [3, C] bias, in heads
of C / heads channels. Attention: block i (encoder then decoder, from 0)
orders each scene's cells of its level by a Morton code, the interleave of
the 16 bits of the coordinates less their minimum with axis ``order[0]``
most significant, ``order`` the (i mod 6)-th permutation of (0, 1, 2) in
lexicographic order; a patch is ``patch`` consecutive cells of that order
(the last one the rest), and each cell attends to its patch.

Departures from Pointcept's ``semseg-pt-v3m1-0-base``, as in the measured
model: Morton orders only, cycled block by block, with no Hilbert curve and
no shuffle; LayerNorm eps 1e-6 and BN (eps 1e-5, biased batch variance in
training, statistics at mean 0 and variance 1 for inference) as in the JAX
package; no drop path (Pointcept trains with 0.3); cross-entropy only
(Pointcept adds a Lovasz loss); Adam(1e-3), the train step of every cell,
where Pointcept uses AdamW with a OneCycle schedule.

fp32 throughout (TF32 off unless the control asks for it), written from
that description; it imports nothing of the measured program. A scene is
its valid cells in lexicographic order, with ``sparse.py``'s levels and
maps. Attention runs patch by patch in chunks of patches, recomputed in the
backward, and in training each block keeps only its input and is
recomputed in the backward, so that three steps of two 115k-cell scenes
fit. The control (``precision="control"``) holds in fp8 what the measured
model holds in bf16: the stem's and the positional convs' operands and
outputs, and the stem's BN and GELU outputs; the caller runs it with TF32
on for the trunk's products (fp32 in the measured model).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.models import sparse

ORDERS = list(itertools.permutations(range(3)))  # (0, 1, 2), (0, 2, 1), ..., (2, 1, 0)
CHUNK_SCORES = 1 << 26  # score elements of one chunk of patches


def _dec_channels(cfg) -> List[int]:
    return list(cfg["dec_channels"]) + [cfg["enc_channels"][-1]]


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan): convs ``kaiming`` uniform (bound sqrt(6 /
    fan)), dense weights ``lecun`` uniform (bound sqrt(3 / fan)), norms
    ``ones``/``zeros``, biases ``zeros``."""
    enc, dec = cfg["enc_channels"], _dec_channels(cfg)
    spec = []

    def norm(name, c):
        spec.extend([(f"{name}.weight", (c,), "ones", 0), (f"{name}.bias", (c,), "zeros", 0)])

    def dense(name, ci, co):
        spec.append((f"{name}.weight", (co, ci), "lecun", ci))
        spec.append((f"{name}.bias", (co,), "zeros", 0))

    def block(name, c):
        spec.append((f"{name}.cpe_conv.weight", (27, c, c), "kaiming", 27 * c))
        spec.append((f"{name}.cpe_conv.bias", (c,), "zeros", 0))
        dense(f"{name}.cpe_proj", c, c)
        norm(f"{name}.cpe_norm", c)
        norm(f"{name}.norm1", c)
        spec.append((f"{name}.attn.attn.qkv.weight", (3, c, c), "lecun", c))
        spec.append((f"{name}.attn.attn.qkv.bias", (3, c), "zeros", 0))
        dense(f"{name}.attn.attn.proj", c, c)
        norm(f"{name}.norm2", c)
        hidden = int(c * cfg["mlp_ratio"])
        dense(f"{name}.fc1", c, hidden)
        dense(f"{name}.fc2", hidden, c)

    spec.append(("stem.weight", (125, cfg["in_channels"], enc[0]), "kaiming",
                 125 * cfg["in_channels"]))
    norm("stem_norm", enc[0])
    for i, depth in enumerate(cfg["enc_depths"]):
        for d in range(depth):
            block(f"enc.{i}.{d}", enc[i])
    for i in range(len(enc) - 1):
        dense(f"down.{i}.proj", enc[i], enc[i + 1])
        norm(f"down.{i}.norm", enc[i + 1])
        dense(f"up.{i}.proj", dec[i + 1], dec[i])
        norm(f"up.{i}.proj_norm", dec[i])
        dense(f"up.{i}.proj_skip", enc[i], dec[i])
        norm(f"up.{i}.skip_norm", dec[i])
    for i, depth in enumerate(cfg["dec_depths"]):
        for d in range(depth):
            block(f"dec.{i}.{d}", dec[i])
    dense("final", dec[0], cfg["num_classes"])
    return spec


def morton_rank(coords: torch.Tensor, order) -> torch.Tensor:
    """Permutation putting the cells [n, 3] in Morton order: the bits of
    ``coords - min`` interleaved, bit b of axis ``order[j]`` at 3b + 2 - j."""
    c = (coords - coords.amin(dim=0)).to(torch.int64)
    key = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for b in range(16):
        for j, axis in enumerate(order):
            key |= ((c[:, axis] >> b) & 1) << (3 * b + 2 - j)
    return torch.argsort(key)


def _attend(q, k, v):
    """q, k, v [n_patches, H, P, D] -> softmax(q k^T / sqrt(D)) v."""
    p = torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
    return p @ v


def patch_attention(q, k, v, patch: int, train: bool):
    """Attention within consecutive ``patch``-row patches of q, k, v [n, H,
    D] (the last patch the rest), in chunks of patches (recomputed in the
    backward when training)."""
    n, heads, d = q.shape
    out = []
    full = n // patch
    per = max(CHUNK_SCORES // (heads * patch * patch), 1)
    spans = [(a, min(a + per, full)) for a in range(0, full, per)]
    spans += [(full, full + 1)] if n % patch else []
    for a, b in spans:
        rows = slice(a * patch, min(b * patch, n))
        m = b - a
        parts = [t[rows].reshape(m, -1, heads, d).transpose(1, 2) for t in (q, k, v)]
        if train:
            o = checkpoint(_attend, *parts, use_reentrant=False)
        else:
            o = _attend(*parts)
        out.append(o.transpose(1, 2).reshape(-1, heads, d))
    return torch.cat(out)


def _bn(x, w, b, train: bool, eps: float = 1e-5):
    """Batch norm over all rows of the batch (biased variance) in training;
    in eval the statistics of a model that has not trained yet, mean 0 and
    variance 1."""
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
    hold = sparse.rounding_for(precision)  # what the program holds in bf16
    P = params
    enc, dec = cfg["enc_channels"], _dec_channels(cfg)
    levels, patch = len(enc), cfg["patch"]
    caps = sparse.level_caps(n_cap, levels, cfg["level_cap_floor"])
    batch = sparse.make_batch([c for c, _ in scenes], caps)
    subs = {}
    ranks = {}

    def sub(lv):
        if lv not in subs:
            subs[lv] = sparse.submanifold_map(batch, lv)
        return subs[lv]

    def rank(lv, o):
        """Per scene, the permutation of the level's rows into order o."""
        if (lv, o) not in ranks:
            ranks[lv, o] = [morton_rank(s[lv].coords, ORDERS[o]) for s in batch.levels]
        return ranks[lv, o]

    def ln(x, name):
        return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], 1e-6)

    def lin(x, name):
        return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])

    def bn(x, name):
        return _bn(x, P[f"{name}.weight"], P[f"{name}.bias"], train)

    def block(x, name, lv, heads, o):
        h = hold(sparse.conv_sub(x, P[f"{name}.cpe_conv.weight"], sub(lv), conv_mm))
        x = x + ln(lin(h + P[f"{name}.cpe_conv.bias"], f"{name}.cpe_proj"), f"{name}.cpe_norm")
        a = ln(x, f"{name}.norm1")
        qkv = torch.einsum("sc,kcd->skd", a, P[f"{name}.attn.attn.qkv.weight"])
        qkv = qkv + P[f"{name}.attn.attn.qkv.bias"]
        c = x.shape[1]
        att = torch.empty_like(x)
        rows = batch.rows[lv]
        for b, perm in enumerate(rank(lv, o)):
            idx = perm + rows[b]
            q, k, v = (qkv[idx, j].reshape(-1, heads, c // heads) for j in range(3))
            att = att.index_copy(0, idx, patch_attention(q, k, v, patch, train).reshape(-1, c))
        x = x + lin(att, f"{name}.attn.attn.proj")
        return x + lin(F.gelu(lin(ln(x, f"{name}.norm2"), f"{name}.fc1")), f"{name}.fc2")

    count = [0]

    def stage(x, side, lv, heads):
        d = 0
        while f"{side}.{lv}.{d}.fc1.weight" in P:
            o = count[0] % len(ORDERS)
            count[0] += 1
            args = (x, f"{side}.{lv}.{d}", lv, heads, o)
            x = checkpoint(block, *args, use_reentrant=False) if x.requires_grad else block(*args)
            d += 1
        return x

    x = torch.cat([f for _, f in scenes])
    m5 = sparse.submanifold_map(batch, 0, size=5)
    h = hold(sparse.conv_sub(x, P["stem.weight"], m5, conv_mm))
    x = hold(F.gelu(hold(bn(h, "stem_norm"))))
    skips = []
    for lv in range(levels):
        x = stage(x, "enc", lv, cfg["enc_num_head"][lv])
        if lv < levels - 1:
            skips.append(x)
            pm = sparse.parity_map(batch, lv)
            f = lin(x, f"down.{lv}.proj")
            pooled = f.new_zeros((pm.n_coarse, f.shape[1])).scatter_reduce(
                0, pm.coarse[:, None].expand(-1, f.shape[1]), f[pm.fine], "amax",
                include_self=False)
            x = F.gelu(bn(pooled, f"down.{lv}.norm"))
    for lv in reversed(range(levels - 1)):
        up = F.gelu(bn(lin(x, f"up.{lv}.proj"), f"up.{lv}.proj_norm"))
        parent = torch.cat([s[lv + 1].parent + batch.rows[lv + 1][b]
                            for b, s in enumerate(batch.levels)])
        skip = F.gelu(bn(lin(skips[lv], f"up.{lv}.proj_skip"), f"up.{lv}.skip_norm"))
        x = up[parent] + skip
        x = stage(x, "dec", lv, cfg["dec_num_head"][lv])
    return sparse.split_rows(lin(x, "final"), batch.rows[0])
