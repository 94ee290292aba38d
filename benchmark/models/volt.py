"""Plain PyTorch reference of Volt (WarpConvNet's ``models/volt``: a sparse
conv stem, K^3 patch tokens, a ViT trunk with global per-scene attention
and 3D RoPE, token-to-voxel unpooling and a 1x1 head), for the
benchmark's ``correct``.

Stem: two 3^3 submanifold convs (no bias), each followed by LayerNorm (eps
1e-6), the first also by tanh-GELU. Tokens: the mean of the stem features
over each occupied ``patch``^3 cell, the first ``token_capacity`` cells in
lexicographic order, projected to ``dim``. Each of ``depth`` pre-norm
blocks: x + proj(attention(LN(x))), then x + fc2(gelu(fc1(LN(x)))), the
attention over all tokens of the scene, Q/K/V from one [3, dim, dim]
weight with a [3, dim] bias, RoPE on Q and K from the token coordinates
(the D/2 rotation pairs split over x, y, z, the first ``(D/2) % 3`` axes one
pair longer, phases ``coord * base ** (-i / n)``). Then LayerNorm, each
voxel takes its token's features (0 where its token was dropped),
``[stem, token]`` goes through a dense layer and GELU, and a 1x1 conv with
bias gives the logits.

fp32 throughout (TF32 off unless the control asks for it); it imports
nothing of the measured program. Attention runs in blocks of queries,
recomputed in the backward, so that 40k tokens fit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.models import sparse

QUERY_BLOCK = 2048


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan): convs ``kaiming`` uniform (bound sqrt(6 /
    fan)), dense weights ``lecun`` uniform (bound sqrt(3 / fan)), norms
    ``ones``/``zeros``, biases ``zeros``."""
    c_in, stem, dim = cfg["in_channels"], cfg["stem_dim"], cfg["dim"]
    hidden = int(dim * cfg["mlp_ratio"])
    spec = []

    def norm(name, c):
        spec.extend([(f"{name}.weight", (c,), "ones", 0), (f"{name}.bias", (c,), "zeros", 0)])

    def dense(name, ci, co):
        spec.append((f"{name}.weight", (co, ci), "lecun", ci))
        spec.append((f"{name}.bias", (co,), "zeros", 0))

    spec.append(("stem1.weight", (27, c_in, stem), "kaiming", 27 * c_in))
    norm("stem1_norm", stem)
    spec.append(("stem2.weight", (27, stem, stem), "kaiming", 27 * stem))
    norm("stem2_norm", stem)
    dense("tok_proj", stem, dim)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        norm(f"{b}.norm1", dim)
        spec.append((f"{b}.attn.qkv.weight", (3, dim, dim), "lecun", dim))
        spec.append((f"{b}.attn.qkv.bias", (3, dim), "zeros", 0))
        dense(f"{b}.attn.proj", dim, dim)
        norm(f"{b}.norm2", dim)
        dense(f"{b}.mlp.fc1", dim, hidden)
        dense(f"{b}.mlp.fc2", hidden, dim)
    norm("norm", dim)
    dense("fuse", stem + dim, stem)
    spec.append(("head.weight", (1, stem, cfg["num_classes"]), "kaiming", stem))
    spec.append(("head.bias", (cfg["num_classes"],), "zeros", 0))
    return spec


def _ln(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], 1e-6)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def rope_phases(coords: torch.Tensor, head_dim: int, base: float):
    """(cos, sin) [S, D/2] of the token coordinates."""
    half = head_dim // 2
    per, rem = divmod(half, 3)
    parts = []
    for ax in range(3):
        n = per + (1 if ax < rem else 0)
        i = torch.arange(n, dtype=torch.float32, device=coords.device)
        parts.append(coords[:, ax:ax + 1].float() * (1.0 / base ** (i / n)))
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """Rotate the (even, odd) pairs of x [S, H, D]; cos, sin [S, D/2]."""
    c, s = cos[:, None], sin[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def _attend_block(q, k, v, scale):
    """q [H, m, D] against all of k, v [H, S, D]."""
    p = torch.softmax((q @ k.transpose(1, 2)) * scale, dim=-1)
    return p @ v


def attention(q, k, v, train: bool):
    """Global attention of one scene, q, k, v [S, H, D] -> [S, H, D], in
    blocks of ``QUERY_BLOCK`` queries (recomputed in the backward)."""
    scale = q.shape[-1] ** -0.5
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))
    outs = []
    for a in range(0, q.shape[1], QUERY_BLOCK):
        qb = q[:, a:a + QUERY_BLOCK]
        if train:
            outs.append(checkpoint(_attend_block, qb, k, v, scale, use_reentrant=False))
        else:
            outs.append(_attend_block(qb, k, v, scale))
    return torch.cat(outs, dim=1).transpose(0, 1)


def forward(params: Dict[str, torch.Tensor], scenes: List[Tuple[torch.Tensor, torch.Tensor]],
            cfg, n_cap: int, train: bool, precision: str = "reference") -> List[torch.Tensor]:
    """Logits [n_b, classes] of each scene (coords [n_b, 3] in lexicographic
    order, features [n_b, C_in] fp32). The control holds the conv operands
    and outputs (bf16 in the measured model) in fp8; the caller runs it
    with TF32 on (``control_tf32`` in the configuration), forward and
    backward, for the trunk's products (fp32 in the measured model)."""
    del n_cap  # Volt keeps every voxel: its only capacity is the tokens'
    conv_mm = sparse.matmul_for(precision)
    hold = sparse.rounding_for(precision)  # the conv outputs the program holds in bf16

    def mm(a, b):
        return hold(conv_mm(a, b))

    P = params
    dim, heads = cfg["dim"], cfg["num_heads"]
    d = dim // heads
    batch = sparse.make_batch([c for c, _ in scenes], [1 << 30])
    m0 = sparse.submanifold_map(batch, 0)
    x = torch.cat([f for _, f in scenes])
    h = _gelu(_ln(hold(sparse.conv_sub(x, P["stem1.weight"], m0, conv_mm)), P, "stem1_norm"))
    h = _ln(hold(sparse.conv_sub(h, P["stem2.weight"], m0, conv_mm)), P, "stem2_norm")

    outs = []
    rows = batch.rows[0]
    for b, (coords, _) in enumerate(scenes):
        hb = h[rows[b]:rows[b + 1]]
        tok = sparse.coarsen(coords, cfg["patch_size"], cfg["token_capacity"])
        keep = tok.parent >= 0
        n_tok = tok.coords.shape[0]
        members = torch.zeros(n_tok, device=h.device).index_add_(
            0, tok.parent[keep], torch.ones_like(tok.parent[keep], dtype=torch.float32))
        t = h.new_zeros((n_tok, hb.shape[1])).index_add_(0, tok.parent[keep], hb[keep])
        t = F.linear(t / members[:, None], P["tok_proj.weight"], P["tok_proj.bias"])
        cos, sin = rope_phases(tok.coords, d, cfg["rope_base"])
        for i in range(cfg["depth"]):
            pre = f"blocks.{i}"
            a = _ln(t, P, f"{pre}.norm1")
            qkv = torch.einsum("sc,kcd->skd", a, P[f"{pre}.attn.qkv.weight"])
            qkv = qkv + P[f"{pre}.attn.qkv.bias"]
            q, k, v = (qkv[:, j].reshape(n_tok, heads, d) for j in range(3))
            o = attention(_rope(q, cos, sin), _rope(k, cos, sin), v, train)
            t = t + F.linear(o.reshape(n_tok, dim), P[f"{pre}.attn.proj.weight"],
                             P[f"{pre}.attn.proj.bias"])
            f = _gelu(F.linear(_ln(t, P, f"{pre}.norm2"), P[f"{pre}.mlp.fc1.weight"],
                               P[f"{pre}.mlp.fc1.bias"]))
            t = t + F.linear(f, P[f"{pre}.mlp.fc2.weight"], P[f"{pre}.mlp.fc2.bias"])
        t = _ln(t, P, "norm")
        up = torch.where(keep[:, None], t[tok.parent.clamp(min=0)], 0)
        f = _gelu(F.linear(torch.cat([hb, up], dim=1), P["fuse.weight"], P["fuse.bias"]))
        outs.append(mm(f, P["head.weight"][0]) + P["head.bias"])
    return outs
