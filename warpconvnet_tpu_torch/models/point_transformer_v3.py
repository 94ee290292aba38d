"""Point Transformer V3 (counterpart of
``warpconvnet_tpu/models/point_transformer_v3.py``; Wu et al., CVPR 2024).

A U-Net of serialized patch attention over sparse voxels: a 5^3 conv stem,
encoder levels of :class:`PatchAttentionBlock` joined by stride-2 grid max
pooling, a decoder of :class:`SerializedUnpooling` and more blocks, and a
dense head.

Each block orders its level's cells along a Morton curve, the axis order
changing from block to block (``ORDER_PERMS[i % 6]`` for block i), and
attends within consecutive patches of that order. A forward computes each (level, order) serialization once, in the
span ``wcn.serialize[B N level order]``, counts it in the host counter
``serialize.sorts``, and shares it among the blocks that ask for it; each
level's 3^3 map is built once and shared by its encoder and decoder blocks.

Numerics follow the JAX package: the stem and positional convs run in the
conv compute dtype; the positional conv's bias, every dense layer,
LayerNorm (eps 1e-6) and the trunk run in fp32; BatchNorm in its input's
dtype; GELU is exact. Constructors take ``device`` (the card unless the
caller asks for another) and a ``generator`` for the weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.functional.sparse_conv import BatchedPairTable
from warpconvnet_tpu_torch.nn.functional.sparse_pool import sparse_max_pool, sparse_unpool
from warpconvnet_tpu_torch.nn.modules.attention import PatchAttention, serialize_patches
from warpconvnet_tpu_torch.nn.modules.mlp import dense
from warpconvnet_tpu_torch.nn.modules.norms import BatchNorm, LayerNorm
from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseConv3d
from warpconvnet_tpu_torch.ops.morton import MORTON_ORDERINGS, ORDER_PERMS

Serialization = Tuple[torch.Tensor, torch.Tensor]


def _gelu(v: Voxels) -> Voxels:
    return v.replace_features(F.gelu(v.features))


class PatchAttentionBlock(nn.Module):
    """xCPE (3^3 conv with bias, dense, LayerNorm, added to x), then
    x + PatchAttention(LN(x)), then x + fc2(gelu(fc1(LN(x)))); pad rows
    zero (JAX ``PatchAttentionBlock``).

    ``forward(x, serialization, pair_table=None)`` returns ``(x, map)``:
    the positional conv's 3^3 map, built where ``pair_table`` is None, for
    the level's other blocks."""

    def __init__(
        self,
        dim: int,
        patch_size: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.cpe_conv = SparseConv3d(dim, dim, 3, use_bias=True, device=device,
                                     generator=generator)
        self.cpe_proj = dense(dim, dim, True, device, generator)
        self.cpe_norm = LayerNorm(dim, device)
        self.norm1 = LayerNorm(dim, device)
        self.attn = PatchAttention(dim, patch_size, num_heads, device, generator)
        self.norm2 = LayerNorm(dim, device)
        self.fc1 = dense(dim, hidden, True, device, generator)
        self.fc2 = dense(hidden, dim, True, device, generator)

    def forward(self, x: Voxels, serialization: Serialization,
                pair_table: Optional[BatchedPairTable] = None):
        h, table = self.cpe_conv(x, pair_table=pair_table,
                                 out_coords=x if pair_table is not None else None)
        valid = x.valid_mask()[..., None]
        feats = torch.where(valid, x.features + self.cpe_norm(self.cpe_proj(h.features)), 0)
        a = self.attn(x.replace(features=self.norm1(feats)), serialization)
        feats = feats + a.features
        feats = feats + self.fc2(F.gelu(self.fc1(self.norm2(feats))))
        return x.replace(features=torch.where(valid, feats, 0)), table


class SerializedPooling(nn.Module):
    """Stride-2 grid max pooling: dense, 2^3 max, BatchNorm, GELU (the JAX
    model's ``down{i}_proj`` and ``down{i}_norm``). Returns (pooled, map)."""

    def __init__(self, in_channels: int, out_channels: int,
                 device: constants.Device = constants.DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = dense(in_channels, out_channels, True, device, generator)
        self.norm = BatchNorm(out_channels, device=device)

    def forward(self, x: Voxels, out_capacity: int):
        pooled, table = sparse_max_pool(x.replace_features(self.proj(x.features)), 2, 2,
                                        out_capacity=out_capacity)
        return _gelu(self.norm(pooled)), table


class SerializedUnpooling(nn.Module):
    """GELU(BN(dense(coarse))) taken to each fine row through the pooling
    map, plus GELU(BN(dense(skip))); pad rows zero (JAX
    ``SerializedUnpooling``)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 device: constants.Device = constants.DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = dense(in_channels, out_channels, True, device, generator)
        self.proj_norm = BatchNorm(out_channels, device=device)
        self.proj_skip = dense(skip_channels, out_channels, True, device, generator)
        self.skip_norm = BatchNorm(out_channels, device=device)

    def forward(self, x: Voxels, skip: Voxels, table: BatchedPairTable) -> Voxels:
        xp = _gelu(self.proj_norm(x.replace_features(self.proj(x.features))))
        sp = _gelu(self.skip_norm(skip.replace_features(self.proj_skip(skip.features))))
        up = sparse_unpool(xp, skip, table)
        return up.replace_features(torch.where(skip.valid_mask()[..., None],
                                                up.features + sp.features, 0))


class Head(nn.Module):
    """Dense layer on the features, pad rows zero (JAX ``final``). Returns
    ``(voxels, None)``, as a 1x1 :class:`SparseConv3d` does."""

    def __init__(self, in_channels: int, out_channels: int,
                 device: constants.Device = constants.DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        lin = dense(in_channels, out_channels, True, device, generator)
        self.weight, self.bias = lin.weight, lin.bias

    def forward(self, x: Voxels):
        out = F.linear(x.features, self.weight, self.bias)
        return x.replace_features(torch.where(x.valid_mask()[..., None], out, 0)), None


class PointTransformerV3(nn.Module):
    """Per-voxel logits (or features, with ``out_channels`` None) from
    :class:`Voxels` (JAX ``PointTransformerV3``), at Pointcept's ScanNet
    widths by default.

    Level i holds ``n`` rows at level 0 and ``max(n // 2**i, min(n, 128))``
    below, rounded down to a multiple of its patch (at least one patch),
    the JAX model's capacities. Block i takes the axis order
    ``ORDER_PERMS[i % 6]``, as the JAX model does without ``order_rng``.
    """

    def __init__(
        self,
        in_channels: int = 6,
        out_channels: Optional[int] = None,
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
        enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
        enc_patch_size: Sequence[int] = (1024, 1024, 1024, 1024, 1024),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        dec_channels: Sequence[int] = (64, 64, 128, 256),
        dec_num_head: Sequence[int] = (4, 4, 8, 16),
        dec_patch_size: Sequence[int] = (1024, 1024, 1024, 1024),
        mlp_ratio: float = 4.0,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = dict(device=constants.resolve_device(device), generator=generator)
        self.enc_depths, self.dec_depths = tuple(enc_depths), tuple(dec_depths)
        self.enc_patch_size, self.dec_patch_size = tuple(enc_patch_size), tuple(dec_patch_size)
        levels = len(enc_depths)
        self.stem = SparseConv3d(in_channels, enc_channels[0], 5, **kw)
        self.stem_norm = BatchNorm(enc_channels[0], device=kw["device"])
        self.enc = nn.ModuleList(
            nn.ModuleList(PatchAttentionBlock(enc_channels[i], enc_patch_size[i],
                                              enc_num_head[i], mlp_ratio, **kw)
                          for _ in range(enc_depths[i]))
            for i in range(levels))
        self.down = nn.ModuleList(SerializedPooling(enc_channels[i], enc_channels[i + 1], **kw)
                                  for i in range(levels - 1))
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        self.up = nn.ModuleList(SerializedUnpooling(dec_ch[i + 1], enc_channels[i], dec_ch[i], **kw)
                                for i in range(levels - 1))
        self.dec = nn.ModuleList(
            nn.ModuleList(PatchAttentionBlock(dec_ch[i], dec_patch_size[i], dec_num_head[i],
                                              mlp_ratio, **kw)
                          for _ in range(dec_depths[i]))
            for i in range(levels - 1))
        self.final = Head(dec_ch[0], out_channels, **kw) if out_channels is not None else None

    def _caps(self, n: int) -> Tuple[int, ...]:
        out = [n]
        for i in range(1, len(self.enc_depths)):
            c = max(n // (2 ** i), min(n, 128))
            p = min(self.enc_patch_size[i], c)
            out.append(max((c // p) * p, p))
        return tuple(out)

    @tracing.spanned("wcn.model.ptv3")
    def forward(self, x: Voxels) -> Voxels:
        levels = len(self.enc_depths)
        caps = self._caps(x.max_num_points)
        serialized: Dict[Tuple[int, int], Serialization] = {}
        maps: Dict[int, BatchedPairTable] = {}
        count = [0]

        def run(blocks, h, level):
            for blk in blocks:
                o = count[0] % len(ORDER_PERMS)
                count[0] += 1
                if (level, o) not in serialized:
                    with tracing.span("wcn.serialize", lambda: (
                            f"{h.batch_size} {h.max_num_points} {level} {MORTON_ORDERINGS[o]}")):
                        serialized[level, o] = serialize_patches(h.coords, h.num_valid,
                                                                 ORDER_PERMS[o])
                    tracing.add("serialize.sorts")
                h, maps[level] = blk(h, serialized[level, o], maps.get(level))
            return h

        h, _ = self.stem(x)
        h = _gelu(self.stem_norm(h))
        skips, tables = [], []
        for i in range(levels):
            h = run(self.enc[i], h, i)
            if i < levels - 1:
                skips.append(h)
                h, t = self.down[i](h, caps[i + 1])
                tables.append(t)
        for i in reversed(range(levels - 1)):
            h = run(self.dec[i], self.up[i](h, skips[i], tables[i]), i)
        if self.final is not None:
            h, _ = self.final(h)
        return h


def build_ptv3(in_channels: int = 6, out_channels: int = 20, patch_size: Optional[int] = None,
               **overrides) -> PointTransformerV3:
    """PTv3 at Pointcept's ScanNet widths (``semseg-pt-v3m1-0-base``);
    ``patch_size`` sets every level's patch, ``overrides`` (``device``,
    ``generator``, depths, widths) replace the defaults."""
    if patch_size is not None:
        overrides.setdefault("enc_patch_size", (patch_size,) * len(
            overrides.get("enc_depths", (2, 2, 2, 6, 2))))
        overrides.setdefault("dec_patch_size", (patch_size,) * len(
            overrides.get("dec_depths", (2, 2, 2, 2))))
    return PointTransformerV3(in_channels, out_channels, **overrides)
