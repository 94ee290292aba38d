"""Integer-coordinate sort keys (counterpart of ``warpconvnet_tpu/ops/keys.py``).

The JAX package packs a coordinate into an (hi, lo) int32 pair because the
TPU has no 64-bit integer path. The port keeps that pair (``pack_coords``)
and joins it into one int64 whose order is the lexicographic order of
(hi, lo), so sorting and searching are plain ``torch.sort`` and
``torch.searchsorted``.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Sentinel coordinate on pad rows; packs to the largest key, so pad rows sort
# last and never match a query (``warpconvnet_tpu/ops/keys.py:37``).
PAD_COORD = (1 << 15) - 1


def pack_coords(coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [..., 3] -> (hi, lo) int32 with ``hi = x*65536 + y + 32768``,
    ``lo = z`` (the JAX default two-key packing, |x|, |y|, |z| < 32768)."""
    c = coords.to(torch.int32)
    hi = c[..., 0] * 65536 + (c[..., 1] + 32768)
    return hi, c[..., 2]


def join_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 -> one int64 ordered as (hi, lo) lexicographically."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def coord_keys(coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] -> int64 lexicographic keys."""
    return join_keys(*pack_coords(coords))


def argsort_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort along the last axis: (sorted_keys, perm int64)."""
    return torch.sort(keys, dim=-1, stable=True)


def searchsorted_keys(
    sorted_keys: torch.Tensor, query_keys: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """Insertion position of each query along the last axis, in [0, N]."""
    return torch.searchsorted(sorted_keys, query_keys, side=side)


def lookup_in_sorted(
    sorted_keys: torch.Tensor, query_keys: torch.Tensor
) -> torch.Tensor:
    """Exact-match position of each query in the sorted keys, or -1 (int32)."""
    n = sorted_keys.shape[-1]
    pos = searchsorted_keys(sorted_keys, query_keys)
    found = torch.gather(sorted_keys, -1, pos.clamp(max=n - 1))
    hit = (pos < n) & (found == query_keys)
    return torch.where(hit, pos, -1).to(torch.int32)
