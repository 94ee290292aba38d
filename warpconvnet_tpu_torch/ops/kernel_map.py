"""Kernel-map construction (counterpart of ``warpconvnet_tpu/ops/kernel_map.py``).

A kernel map is a dense pair table ``table[B, K, N_out]`` int32: for offset
k and output row o, the input row i with
``in_coords[i] == stride * out_coords[o] + offsets[k]``, or -1. Its reverse
``rev[B, K, N_in]`` exists because the map o -> i is injective per offset,
and serves transposed convs.

Each builder runs in a span ``wcn.map.<function>`` (``tracing``); none
copies host data to the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.kernels import sorted_search
from warpconvnet_tpu_torch.ops.keys import PAD_COORD, argsort_keys, coord_keys


def _as_tuple3(v) -> Tuple[int, int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v),) * 3
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected a 3D value, got {t}")
    return t


def kernel_offsets(
    kernel_size: Sequence[int] | int,
    dilation: Sequence[int] | int = 1,
    center_offset: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """[K, 3] int32 offsets, x-major / z-fastest. Odd kernels are centred;
    even ones anchored at 0."""
    ks = _as_tuple3(kernel_size)
    dil = _as_tuple3(dilation)
    if center_offset is None:
        center_offset = [(s - 1) // 2 if s % 2 == 1 else 0 for s in ks]
    grids = np.meshgrid(*[np.arange(s) for s in ks], indexing="ij")
    offs = np.stack([g.reshape(-1) for g in grids], axis=1).astype(np.int32)
    return (offs - np.asarray(center_offset, np.int32)) * np.asarray(dil, np.int32)


def identity_offset_index(offsets: np.ndarray) -> Optional[int]:
    """Index of the all-zero offset, if present."""
    hits = np.nonzero((np.asarray(offsets) == 0).all(axis=1))[0]
    return int(hits[0]) if hits.size else None


@tracing.spanned("wcn.map.reverse_tables")
def reverse_tables(table: torch.Tensor, num_in: int) -> torch.Tensor:
    """table [B, K, N_out] -> rev [B, K, N_in]: the output row per (offset,
    input row), or -1. One scatter; entries are unique per (b, k)."""
    b, k, n_out = table.shape
    rev = torch.full((b, k, num_in + 1), -1, dtype=torch.int32, device=table.device)
    cols = torch.where(table >= 0, table, num_in).to(torch.int64)  # -1 -> dropped slot
    src = torch.arange(n_out, dtype=torch.int32, device=table.device).expand(b, k, n_out)
    rev.scatter_(2, cols, src)
    return rev[:, :, :num_in].contiguous()


MASK_BITS = 62  # offsets that enter a row's order key
_mask_bits = {}  # (offsets, dtype, device) -> [offsets] powers of two


@tracing.spanned("wcn.map.row_order")
def row_order(table: torch.Tensor) -> torch.Tensor:
    """[B, K, N] table -> [B, N] int32: each scene's rows ordered by their
    offset mask (bit k set where ``table[b, k, row] >= 0``), the order in
    which K2 and K4 take their tiles (``kernels/implicit_gemm.py``).

    Rows with equal masks are contiguous, in index order (a stable sort),
    and rows with no pair (pad rows) come last. A map with more than
    ``MASK_BITS`` offsets is keyed by its first ``MASK_BITS``. Computed on
    the table's device in a few launches, a sort among them (int32 keys up
    to 30 offsets)."""
    kk = min(table.shape[1], MASK_BITS)
    dtype = torch.int32 if kk <= 30 else torch.int64
    key = (kk, dtype, table.device)
    if key not in _mask_bits:
        _mask_bits[key] = 2 ** torch.arange(kk, dtype=dtype, device=table.device)
    mask = ((table[:, :kk] >= 0) * _mask_bits[key][:, None]).sum(1, dtype=dtype)
    mask.masked_fill_(mask == 0, torch.iinfo(dtype).max)  # no pair: last
    return torch.sort(mask, dim=1, stable=True).indices.to(torch.int32)


class PairTable(NamedTuple):
    """Single-scene kernel map: table [K, N_out], offsets [K, 3], num_in."""

    table: torch.Tensor
    offsets: np.ndarray
    num_in: int

    def reverse(self) -> "PairTable":
        """Reverse table [K, N_in] with negated offsets (the transposed map)."""
        rev = reverse_tables(self.table[None], self.num_in)[0]
        return PairTable(rev, -np.asarray(self.offsets), self.table.shape[1])


@tracing.spanned("wcn.map.build_pair_tables_batched")
def build_pair_tables_batched(
    in_coords: torch.Tensor,  # [B, N, 3] int32
    in_num_valid: torch.Tensor,  # [B]
    out_coords: torch.Tensor,  # [B, M, 3] int32
    out_num_valid: torch.Tensor,  # [B]
    offsets: np.ndarray,
    stride: Sequence[int] | int = 1,
    assume_sorted: bool = False,
) -> torch.Tensor:
    """Batched dense kernel map: table [B, K, M] int32 (input row or -1).

    ``assume_sorted``: the valid input rows of each scene are already in
    lexicographic order, so their keys are searched as they are; otherwise
    the keys are sorted first and hits are mapped back through the sort.
    The search is kernel K1 on CUDA tensors, its plain version on CPU.
    """
    n = in_coords.shape[1]
    iv = torch.arange(n, device=in_coords.device)[None, :] < in_num_valid[:, None]
    keys = coord_keys(torch.where(iv[..., None], in_coords, PAD_COORD))
    perm = None
    if not assume_sorted:
        keys, perm = argsort_keys(keys)
    pos = sorted_search.kernel_map_probe(
        keys.contiguous(),
        in_num_valid.to(torch.int32).contiguous(),
        out_coords.to(torch.int32).contiguous(),
        out_num_valid.to(torch.int32).contiguous(),
        offsets,
        _as_tuple3(stride),
    )
    if perm is None:
        return pos
    b, k, m = pos.shape
    orig = torch.gather(perm, 1, pos.clamp(min=0).reshape(b, k * m).to(torch.int64))
    return torch.where(pos >= 0, orig.reshape(b, k, m), -1).to(torch.int32)


def parity_partition_applies(
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int,
    dilation: Sequence[int] | int = 1,
) -> bool:
    """True when the strided map is a parity partition: every input voxel
    matches exactly one (offset, output) pair, ``offset = coord mod stride``
    and ``output = coord // stride`` (even kernel == stride, dilation 1)."""
    ks = _as_tuple3(kernel_size)
    st = _as_tuple3(stride)
    dil = _as_tuple3(dilation)
    return ks == st and all(s % 2 == 0 for s in ks) and dil == (1, 1, 1)


def _parity_k_index(coords: torch.Tensor, kernel_size: Tuple[int, int, int]) -> torch.Tensor:
    """Offset slot of each row under the x-major enumeration, from the
    floor-mod residue of its coordinate: ``c & (k - 1)`` per axis for a
    power-of-two k, negative coordinates included (two's complement)."""
    if not all(k > 0 and (k & (k - 1)) == 0 for k in kernel_size):
        raise ValueError(f"parity maps: power-of-two kernels only, got {kernel_size}")
    kx, ky, kz = kernel_size
    r = [coords[..., a] & (k - 1) for a, k in enumerate(kernel_size)]
    return r[0] * (ky * kz) + r[1] * kz + r[2]


@tracing.spanned("wcn.map.parity_pair_tables_from_unique")
def parity_pair_tables_from_unique(
    coords: torch.Tensor,  # [B, N, 3] int32, fine side
    valid: torch.Tensor,  # [B, N] bool
    to_unique: torch.Tensor,  # [B, N] output row per input row; out_capacity = dropped
    kernel_size: Tuple[int, int, int],  # == stride, powers of two
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table [B, K, M], rev [B, K, N]) of a parity-partition map with one
    injective scatter and one broadcast compare, no search."""
    b, n, _ = coords.shape
    k_vol = int(np.prod(kernel_size))
    dev = coords.device
    k_i = _parity_k_index(coords, kernel_size)
    u = to_unique.to(torch.int64)
    ok = valid & (u >= 0) & (u < out_capacity)
    rows = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    table = torch.full((b, k_vol + 1, out_capacity + 1), -1, dtype=torch.int32, device=dev)
    bi = torch.arange(b, device=dev)[:, None].expand(b, n)
    table[bi, torch.where(ok, k_i, k_vol), torch.where(ok, u, out_capacity)] = rows
    table = table[:, :k_vol, :out_capacity].contiguous()
    karange = torch.arange(k_vol, device=dev)[None, :, None]
    hit = (k_i[:, None, :] == karange) & ok[:, None, :]
    rev = torch.where(hit, u[:, None, :], -1).to(torch.int32)
    return table, rev


@tracing.spanned("wcn.map.parity_strided_unique")
def parity_strided_unique(
    coords: torch.Tensor,  # [B, N, 3] int32
    num_valid: torch.Tensor,  # [B]
    kernel_size: Tuple[int, int, int],  # == stride, powers of two
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out_coords [B, M, 3], num_unique [B], to_unique [B, N]) of the
    floor-divided coordinates (``c >> log2 k`` per axis, which floors
    negative coordinates too): one stable sort, a first-occurrence mask and
    a cumsum; output rows come out in lexicographic order."""
    b, n, _ = coords.shape
    ks = tuple(int(k) for k in kernel_size)
    if not all(k > 0 and (k & (k - 1)) == 0 for k in ks):
        raise ValueError(f"parity_strided_unique: power-of-two strides only, got {ks}")
    dev = coords.device
    valid = torch.arange(n, device=dev)[None, :] < num_valid[:, None]
    c = coords.to(torch.int32)
    shifted = torch.stack([c[..., a] >> (k.bit_length() - 1) for a, k in enumerate(ks)], dim=-1)
    cdiv = torch.where(valid[..., None], shifted, PAD_COORD)
    sk, pay = argsort_keys(coord_keys(cdiv))
    first = torch.ones_like(valid)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    first &= valid  # valid rows sort first: validity is positional
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    num_unique = first.sum(dim=1).to(torch.int32)
    u_s = torch.where(valid, rank.clamp(max=out_capacity), out_capacity)
    cdiv_s = torch.gather(cdiv, 1, pay[..., None].expand(-1, -1, 3))
    slot = torch.where(first & (rank < out_capacity), rank, out_capacity)
    oc = torch.full((b, out_capacity + 1, 3), PAD_COORD, dtype=torch.int32, device=dev)
    oc.scatter_(1, slot[..., None].expand(-1, -1, 3), cdiv_s)
    to_u = torch.empty((b, n), dtype=torch.int32, device=dev)
    to_u.scatter_(1, pay, u_s.to(torch.int32))
    return oc[:, :out_capacity].contiguous(), num_unique, to_u
