"""Attention primitives over padded batches (counterpart of
``warpconvnet_tpu/nn/functional/attention.py``): masked scaled dot-product
attention, the plain reference behind ``segment_attention``, and 3D RoPE.

Layouts follow the JAX package: q [..., Sq, H, D], k and v [..., Skv, H, D].
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    row_valid_q: Optional[torch.Tensor] = None,
    row_valid_kv: Optional[torch.Tensor] = None,
    pair_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention with row-validity and pair masks (JAX
    ``masked_sdpa``, ``attention.py:18-60``).

    Logits are fp32 (bf16 inputs multiply exactly in fp32; float64 inputs
    stay float64), masked entries are filled with -1e30, a query row with
    no valid key gives 0, and the probabilities are cast to v's dtype before
    the product with v, which sums in fp32 and rounds once. Returns
    [..., Sq, H, D] in v's dtype.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.transpose(-2, -3).to(acc)  # [..., H, Sq, D]
    kf = k.transpose(-2, -3).to(acc)
    logits = (qf @ kf.transpose(-1, -2)) * scale  # [..., H, Sq, Skv]
    mask = None
    if row_valid_kv is not None:
        mask = row_valid_kv[..., None, None, :]
    if pair_mask is not None:
        pm = pair_mask[..., None, :, :]
        mask = pm if mask is None else (mask & pm)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0)
    out = probs.to(v.dtype).to(acc) @ v.transpose(-2, -3).to(acc)
    out = out.to(v.dtype).transpose(-2, -3)
    if row_valid_q is not None:
        out = torch.where(row_valid_q[..., None, None], out, 0)
    return out


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the (even, odd) pairs of the last dim by per-position phases
    (JAX ``apply_rope``). x [..., D]; cos, sin [..., D/2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def rope_3d_phases(
    coords: torch.Tensor, head_dim: int, base: float = 100.0, dtype=torch.float32
):
    """3D coordinate-phase RoPE (JAX ``rope_3d_phases``): the D/2 rotation
    pairs split into three axis groups (the first ``(D/2) % 3`` groups one
    longer), each with phases ``coord * base ** (-i / n)``. coords [..., 3];
    returns (cos, sin), each [..., D/2] in ``dtype``."""
    if head_dim % 2:
        raise ValueError(f"head_dim {head_dim} must be even")
    half = head_dim // 2
    per_axis, rem = divmod(half, 3)
    parts = []
    for ax in range(3):
        n = per_axis + (1 if ax < rem else 0)
        if n == 0:
            continue
        i = torch.arange(n, dtype=dtype, device=coords.device)
        freqs = 1.0 / (base ** (i / max(n, 1)))
        parts.append(coords[..., ax:ax + 1].to(dtype) * freqs)
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)
