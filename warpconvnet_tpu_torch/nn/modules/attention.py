"""Attention modules (counterpart of ``warpconvnet_tpu/nn/modules/attention.py``):
:class:`Attention` (fused QKV through :class:`BatchedLinear`, optional 3D
RoPE), :class:`FeedForward` and :class:`TransformerBlock`. Numerics follow
flax: LayerNorm eps 1e-6 in fp32, tanh GELU (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.nn.functional.attention import apply_rope, masked_sdpa, rope_3d_phases
from warpconvnet_tpu_torch.nn.functional.flash_attention import (
    segment_attention,
    segment_ids_from_groups,
    segment_ids_from_valid,
)
from warpconvnet_tpu_torch.nn.modules.mlp import BatchedLinear, dense
from warpconvnet_tpu_torch.nn.modules.norms import LayerNorm


class Attention(nn.Module):
    """Multi-head attention over [..., S, C] with row-validity masking (JAX
    ``Attention``, ``attention.py:34-95``), Q/K/V from one [3, C, C]
    :class:`BatchedLinear` (JAX's default and its only use).

    ``forward(x, row_valid, coords, pair_mask, segment_ids)``: with
    ``pair_mask`` the score-matrix path :func:`masked_sdpa`; otherwise
    :func:`segment_attention` over the segments from ``segment_ids`` or
    ``row_valid`` (K9 on the card), with pad outputs zeroed. RoPE on
    ``coords`` when ``rope_base`` is set.
    """

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        rope_base: Optional[float] = None,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.qkv = BatchedLinear(3, dim, dim, device=device, generator=generator)
        self.proj = dense(dim, dim, True, device, generator)

    def forward(
        self,
        x: torch.Tensor,
        row_valid: Optional[torch.Tensor] = None,
        coords: Optional[torch.Tensor] = None,
        pair_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = self.num_heads
        d = self.dim // h
        qkv = self.qkv(x)  # [..., 3, C]
        q, k, v = (qkv[..., i, :] for i in range(3))
        shape = x.shape[:-1] + (h, d)
        q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
        if self.rope_base is not None and coords is not None:
            cos, sin = rope_3d_phases(coords, d, self.rope_base, torch.float32)
            cos, sin = cos[..., None, :], sin[..., None, :]
            q = apply_rope(q, cos, sin).to(x.dtype)
            k = apply_rope(k, cos, sin).to(x.dtype)
        if pair_mask is not None:
            out = masked_sdpa(q, k, v, row_valid, row_valid, pair_mask)
        else:
            if segment_ids is not None:
                seg = segment_ids_from_groups(segment_ids, row_valid)
            elif row_valid is not None:
                seg = segment_ids_from_valid(row_valid)
            else:
                seg = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
            bs, s = math.prod(x.shape[:-2]), x.shape[-2]
            out = segment_attention(
                q.reshape(bs, s, h, d), k.reshape(bs, s, h, d), v.reshape(bs, s, h, d),
                seg.reshape(bs, s),
            ).reshape(q.shape)
            if row_valid is not None:
                out = torch.where(row_valid[..., None, None], out, 0)
        return self.proj(out.reshape(x.shape[:-1] + (self.dim,)))


class FeedForward(nn.Module):
    """Dense -> tanh GELU -> Dense (JAX ``FeedForward``, ``attention.py:98-108``)."""

    def __init__(
        self,
        dim: int,
        hidden_ratio: float = 4.0,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        hidden = int(dim * hidden_ratio)
        self.fc1 = dense(dim, hidden, True, device, generator)
        self.fc2 = dense(hidden, dim, True, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    """Pre-norm attention + MLP block (JAX ``TransformerBlock``,
    ``attention.py:111-127``); pad rows come out zero."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        hidden_ratio: float = 4.0,
        rope_base: Optional[float] = None,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.norm1 = LayerNorm(dim, device)
        self.attn = Attention(dim, num_heads, rope_base=rope_base, device=device,
                              generator=generator)
        self.norm2 = LayerNorm(dim, device)
        self.mlp = FeedForward(dim, hidden_ratio, device, generator)

    def forward(self, x, row_valid=None, coords=None, pair_mask=None):
        x = x + self.attn(self.norm1(x), row_valid, coords, pair_mask)
        x = x + self.mlp(self.norm2(x))
        if row_valid is not None:
            x = torch.where(row_valid[..., None], x, 0)
        return x
