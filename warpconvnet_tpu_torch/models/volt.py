"""Volt, a voxel transformer with K^3 patch tokens (counterpart of
``warpconvnet_tpu/models/volt.py``).

Sparse-conv stem -> K^3 patch tokenizer (a stride-K mean ``sparse_reduce``:
one token per occupied K^3 cell) -> ViT trunk with global per-scene
attention (``segment_attention``, K9 on the card) and 3D RoPE on the token
coordinates -> token-to-voxel unpooling, a skip fuse and a 1x1 head.

Numerics follow flax: every LayerNorm (eps 1e-6) computes and returns fp32,
so under a bf16 conv compute dtype the trunk after the first LayerNorm runs
in fp32; GELU is the tanh approximation. Constructors take ``device`` (the
card unless the caller asks for another) and a ``generator`` for the
weights; ``dropout_generator`` drives DropPath in training.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.functional.sparse_pool import sparse_reduce, sparse_unpool
from warpconvnet_tpu_torch.nn.modules.attention import Attention, FeedForward
from warpconvnet_tpu_torch.nn.modules.blocks import SparseConvNeXtBlock
from warpconvnet_tpu_torch.nn.modules.mlp import dense
from warpconvnet_tpu_torch.nn.modules.norms import LayerNorm
from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseConv3d


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class DropPath(nn.Module):
    """Per-sample stochastic depth (JAX ``DropPath``): the identity unless
    training with a positive rate; then each sample is kept with
    probability ``1 - rate`` (drawn from ``generator``) and rescaled."""

    def __init__(self, rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        dev = self.generator.device if self.generator is not None else x.device
        keep = torch.rand(shape, generator=self.generator, device=dev).to(x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class LayerScale(nn.Module):
    """Learned per-channel residual scale (JAX ``LayerScale``)."""

    def __init__(self, dim: int, init: float = 1e-5,
                 device: constants.Device = constants.DEFAULT_DEVICE):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, device=constants.resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class TokenConv(nn.Module):
    """Stride-1 3^3 sparse conv residual on the token grid (JAX
    ``TokenConv``, the ``conv_before_attn`` path)."""

    def __init__(self, dim: int, device: constants.Device = constants.DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = SparseConv3d(dim, dim, 3, device=device, generator=generator)
        self.norm = LayerNorm(dim, device)

    def forward(self, tokens: Voxels) -> Voxels:
        h, _ = self.conv(tokens)
        f = tokens.features + gelu(self.norm(h.features))
        return tokens.replace(features=torch.where(tokens.valid_mask()[..., None], f, 0))


class VoltBlock(nn.Module):
    """Pre-norm global-attention transformer block with 3D RoPE on token
    coordinates; optional token conv, LayerScale and DropPath (JAX
    ``VoltBlock``, ``volt.py:81-111``). Pad rows come out zero."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        rope_base: Optional[float] = 100.0,
        hidden_ratio: float = 4.0,
        conv_before_attn: bool = False,
        drop_path: float = 0.0,
        layer_scale: Optional[float] = None,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.token_conv = TokenConv(dim, device, generator) if conv_before_attn else None
        self.norm1 = LayerNorm(dim, device)
        self.attn = Attention(dim, num_heads, rope_base=rope_base, device=device,
                              generator=generator)
        self.norm2 = LayerNorm(dim, device)
        self.mlp = FeedForward(dim, hidden_ratio, device, generator)
        scaled = layer_scale is not None
        self.ls1 = LayerScale(dim, layer_scale, device) if scaled else nn.Identity()
        self.ls2 = LayerScale(dim, layer_scale, device) if scaled else nn.Identity()
        self.dp1 = DropPath(drop_path, dropout_generator)
        self.dp2 = DropPath(drop_path, dropout_generator)

    def forward(self, tokens: Voxels) -> Voxels:
        if self.token_conv is not None:
            tokens = self.token_conv(tokens)
        x = tokens.features
        mask = tokens.valid_mask()
        x = x + self.dp1(self.ls1(self.attn(self.norm1(x), mask, tokens.coords)))
        x = x + self.dp2(self.ls2(self.mlp(self.norm2(x))))
        return tokens.replace(features=torch.where(mask[..., None], x, 0))


class Volt(nn.Module):
    """Per-voxel logits from :class:`Voxels` (JAX ``Volt``, ``volt.py:114-186``).

    ``token_capacity`` bounds the padded token rows of a scene (default: the
    input's row count); tokens past it are dropped, as in the JAX package.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        patch_size: int = 4,
        dim: int = 192,
        depth: int = 12,
        num_heads: int = 6,
        stem_dim: int = 64,
        tokenizer_type: str = "linear",
        conv_before_attn: bool = False,
        use_conv_blocks: bool = False,
        conv_every: int = 4,
        drop_path: float = 0.0,
        layer_scale: Optional[float] = None,
        token_capacity: Optional[int] = None,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if tokenizer_type not in ("linear", "convblock"):
            raise ValueError(f"unknown tokenizer_type {tokenizer_type!r}")
        device = constants.resolve_device(device)
        self.patch_size = patch_size
        self.token_capacity = token_capacity
        self.stem1 = SparseConv3d(in_channels, stem_dim, 3, device=device, generator=generator)
        self.stem1_norm = LayerNorm(stem_dim, device)
        self.stem2 = SparseConv3d(stem_dim, stem_dim, 3, device=device, generator=generator)
        self.stem2_norm = LayerNorm(stem_dim, device)
        self.convblock_tokenizer = tokenizer_type == "convblock"
        if self.convblock_tokenizer:
            self.tok_conv1 = SparseConv3d(stem_dim, stem_dim, 3, device=device, generator=generator)
            self.tok_norm1 = LayerNorm(stem_dim, device)
            self.tok_conv2 = SparseConv3d(stem_dim, stem_dim, 3, device=device, generator=generator)
            self.tok_norm = LayerNorm(stem_dim, device)
        self.tok_proj = dense(stem_dim, dim, True, device, generator)
        self.blocks = nn.ModuleList(
            VoltBlock(dim, num_heads, conv_before_attn=conv_before_attn,
                      drop_path=drop_path * i / max(depth - 1, 1), layer_scale=layer_scale,
                      device=device, generator=generator, dropout_generator=dropout_generator)
            for i in range(depth)
        )
        self.conv_blocks = nn.ModuleDict({
            str(i): SparseConvNeXtBlock(dim, kernel_size=3, device=device, generator=generator)
            for i in range(depth) if use_conv_blocks and (i + 1) % conv_every == 0
        })
        self.norm = LayerNorm(dim, device)
        self.fuse = dense(stem_dim + dim, stem_dim, True, device, generator)
        self.head = SparseConv3d(stem_dim, out_channels, 1, use_bias=True, device=device,
                                 generator=generator)

    @tracing.spanned("wcn.model.volt")
    def forward(self, vox: Voxels) -> Voxels:
        h, t0 = self.stem1(vox)
        h = h.replace_features(gelu(self.stem1_norm(h.features)))
        h, _ = self.stem2(h, pair_table=t0, out_coords=h)
        h = h.replace_features(self.stem2_norm(h.features))
        if self.convblock_tokenizer:
            r, _ = self.tok_conv1(h, pair_table=t0, out_coords=h)
            r = r.replace_features(gelu(self.tok_norm1(r.features)))
            r, _ = self.tok_conv2(r, pair_table=t0, out_coords=r)
            h = h.replace_features(self.tok_norm(h.features + r.features))

        p = self.patch_size
        tokens, pool_table = sparse_reduce(h, p, p, "mean", out_capacity=self.token_capacity)
        tokens = tokens.replace_features(self.tok_proj(tokens.features))
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if str(i) in self.conv_blocks:
                tokens = self.conv_blocks[str(i)](tokens)
        tokens = tokens.replace_features(self.norm(tokens.features))

        up = sparse_unpool(tokens, h, pool_table, concat_features=h.features)
        f = gelu(self.fuse(up.features))
        out, _ = self.head(up.replace_features(f))
        return out


# The reference's variant table (ScanNet v2 val mIoU with TTA): volt-s 76.06,
# volt-convattn 76.41, volt-b 76.53, volt-convblock 77.01, volt-all3 77.93,
# volt-blockattn 78.00, volt-b-convblock 78.23. "volt-blockattn" is the
# convblock tokenizer with conv_before_attn at base width, not a windowed
# attention scheme, as in the JAX package.
VOLT_VARIANTS = {
    "volt-s": dict(dim=384, num_heads=6),
    "volt-convattn": dict(dim=384, num_heads=6, conv_before_attn=True),
    "volt-b": dict(dim=768, num_heads=12),
    "volt-convblock": dict(dim=384, num_heads=6, tokenizer_type="convblock"),
    "volt-all3": dict(dim=768, num_heads=12, tokenizer_type="convblock", conv_before_attn=True),
    "volt-blockattn": dict(dim=384, num_heads=6, tokenizer_type="convblock",
                           conv_before_attn=True),
    "volt-b-convblock": dict(dim=768, num_heads=12, tokenizer_type="convblock"),
}


def build_volt(
    variant: str = "volt-s", in_channels: int = 3, out_channels: int = 20, **overrides
) -> Volt:
    """A Volt variant by name; ``overrides`` (``device``, ``generator``,
    ``token_capacity``, widths) replace the variant's settings."""
    cfg = dict(VOLT_VARIANTS[variant])
    cfg.update(overrides)
    return Volt(in_channels=in_channels, out_channels=out_channels, **cfg)
