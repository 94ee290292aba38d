"""Attention modules (counterpart of ``warpconvnet_tpu/nn/modules/attention.py``):
:class:`Attention` (fused QKV through :class:`BatchedLinear`, optional 3D
RoPE), :class:`FeedForward`, :class:`TransformerBlock`, and
:func:`serialize_patches` with :class:`PatchAttention` (Morton-serialized
patch attention, PTv3's). Numerics follow flax: LayerNorm eps 1e-6 in
fp32, tanh GELU (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.functional.attention import apply_rope, masked_sdpa, rope_3d_phases
from warpconvnet_tpu_torch.nn.functional.flash_attention import (
    patch_segment_ids,
    segment_attention,
    segment_ids_from_groups,
    segment_ids_from_valid,
)
from warpconvnet_tpu_torch.nn.modules.mlp import BatchedLinear, dense
from warpconvnet_tpu_torch.nn.modules.norms import LayerNorm
from warpconvnet_tpu_torch.ops.morton import morton_argsort


class Attention(nn.Module):
    """Multi-head attention over [..., S, C] with row-validity masking (JAX
    ``Attention``, ``attention.py:34-95``), Q/K/V from one [3, C, C]
    :class:`BatchedLinear` (JAX's default and its only use).

    ``forward(x, row_valid, coords, pair_mask, segment_ids,
    kv_segment_ids)``: with ``pair_mask`` the score-matrix path
    :func:`masked_sdpa`; otherwise :func:`segment_attention` over the
    segments from ``segment_ids`` or ``row_valid`` (K9 on the card), with
    pad outputs zeroed; ``kv_segment_ids`` gives the keys ids of their own
    (the queries keep ``segment_ids``). RoPE on ``coords`` when
    ``rope_base`` is set.
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
        kv_segment_ids: Optional[torch.Tensor] = None,
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
            seg_kv = None if kv_segment_ids is None else kv_segment_ids.reshape(bs, s)
            out = segment_attention(
                q.reshape(bs, s, h, d), k.reshape(bs, s, h, d), v.reshape(bs, s, h, d),
                seg.reshape(bs, s), seg_kv,
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


def serialize_patches(
    coords: torch.Tensor, num_valid: torch.Tensor, order: Sequence[int] = (0, 1, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scene Morton permutation and its inverse (JAX
    ``serialize_patches``, the coordinate columns taken in ``order``) of
    coords [B, N, 3] whose first ``num_valid[b]`` rows are valid: each
    scene's valid coords shifted by their per-axis minimum, valid rows
    first in Morton order, pad rows last. int64 [B, N] each."""
    valid = torch.arange(coords.shape[1], device=coords.device)[None, :] < num_valid[:, None]
    big = torch.iinfo(coords.dtype).max
    cmin = torch.where(valid[..., None], coords, big).amin(dim=1, keepdim=True)
    return morton_argsort(coords - cmin, valid, order)


class PatchAttention(nn.Module):
    """Serialized patch attention (JAX ``PatchAttention``,
    ``attention.py:178-212``; PTv3's core op): each scene's rows in a
    Morton order, attention within consecutive ``patch_size``-row patches
    of its valid rows (the last one partial), rows put back, pad rows zero.

    One :func:`segment_attention` call over [B, N, H, D] whose segment is
    the serialized rank // ``patch_size`` (:func:`patch_segment_ids`), where
    the JAX package reshapes into [B, N/P, P] patches.
    ``forward(geometry, serialization)`` takes the ``(perm, inverse)`` of
    :func:`serialize_patches`, which a model shares among the blocks that
    use the same order on the same coordinates.
    """

    def __init__(
        self,
        dim: int,
        patch_size: int = 1024,
        num_heads: int = 8,
        device: constants.Device = constants.DEFAULT_DEVICE,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.attn = Attention(dim, num_heads, device=device, generator=generator)

    def forward(self, geometry: Voxels, serialization: Tuple[torch.Tensor, torch.Tensor]) -> Voxels:
        perm, inverse = serialization
        c = geometry.features.shape[-1]
        # Indices broadcast by expand: the backward keeps a [B, N] index,
        # where take_along_dim would keep it copied out to [B, N, C].
        x = torch.gather(geometry.features, 1, perm[..., None].expand(-1, -1, c))
        seg_q, seg_kv = patch_segment_ids(geometry.num_valid, x.shape[1], self.patch_size)
        out = self.attn(x, segment_ids=seg_q, kv_segment_ids=seg_kv)
        out = torch.gather(out, 1, inverse[..., None].expand(-1, -1, c))
        return geometry.replace(features=torch.where(geometry.valid_mask()[..., None], out, 0))
