"""Morton (Z-order) serialization (counterpart of ``warpconvnet_tpu/ops/morton.py``).

The JAX package keeps a 48-bit code of 16-bit coordinates as an (hi, lo)
int32 pair, hi interleaving the upper 8 bits of each axis and lo the lower
8; the port joins them into one int64, ``hi << 24 | lo``, which is the
same 48-bit interleave and sorts in the same order. Everything runs on the
coordinates' device with no host synchronisation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from warpconvnet_tpu_torch.ops.keys import argsort_keys

# The six axis orders (JAX ``MORTON_ORDERINGS``; the reference's
# ``POINT_ORDERING``), and each as a permutation of the coordinate columns.
MORTON_ORDERINGS = ("xyz", "xzy", "yxz", "yzx", "zxy", "zyx")
ORDER_PERMS = tuple(tuple("xyz".index(a) for a in o) for o in MORTON_ORDERINGS)
_PAD_KEY = 1 << 62  # above every 48-bit code: pad rows sort last


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of int64 ``v`` so that two zero bits sit
    between each."""
    v = v & 0xFFFF
    v = (v | (v << 16)) & 0x0000FF0000FF
    v = (v | (v << 8)) & 0x00F00F00F00F
    v = (v | (v << 4)) & 0x0C30C30C30C3
    v = (v | (v << 2)) & 0x249249249249
    return v


def morton_code(coords: torch.Tensor, order: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    """48-bit Morton code (int64) of coords [..., 3] in [0, 2**16) per
    axis, the axis ``order[0]`` most significant."""
    c = coords.to(torch.int64)
    a, b, d = (c[..., i] for i in order)
    return (_part1by2(a) << 2) | (_part1by2(b) << 1) | _part1by2(d)


def morton_argsort(
    coords: torch.Tensor, valid: torch.Tensor, order: Sequence[int] = (0, 1, 2)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row Morton permutation of coords [B, N, 3] (in [0, 2**16) per
    axis where ``valid``, JAX ``morton_argsort``): the valid rows of each
    batch row in Morton order first, the others after them in their own
    order (a stable sort). Returns (perm, inverse) int64 [B, N]: position
    ``r`` holds row ``perm[r]``, and row ``i`` sits at ``inverse[i]``."""
    _, perm = argsort_keys(torch.where(valid, morton_code(coords, order), _PAD_KEY))
    rows = torch.arange(perm.shape[1], device=perm.device).expand_as(perm)
    return perm, torch.empty_like(perm).scatter_(1, perm, rows)
