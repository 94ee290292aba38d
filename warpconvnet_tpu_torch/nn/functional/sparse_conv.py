"""Spatially sparse convolution, forward (counterpart of
``warpconvnet_tpu/nn/functional/sparse_conv.py``).

The kernel map is a dense pair table built by sort and search (kernel K1
for 3^3 submanifold maps) or, for even kernel == stride convs, by the
parity partition. Every conv that uses a table, whatever its stride or
direction, runs the implicit-GEMM kernel K2; 1x1 convs are a matmul.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.geometry.voxels import Voxels, _as3
from warpconvnet_tpu_torch.kernels import implicit_gemm
from warpconvnet_tpu_torch.ops.kernel_map import (
    build_pair_tables_batched,
    identity_offset_index,
    kernel_offsets,
    parity_pair_tables_from_unique,
    parity_partition_applies,
    parity_strided_unique,
    reverse_tables,
)


class BatchedPairTable(NamedTuple):
    """Per-scene pair tables stacked on a batch axis.

    table [B, K, N_out] int32; rev [B, K, N_in] int32 (or None until built);
    offsets [K, 3] numpy; self_map: in and out are the same coordinate set.
    """

    table: torch.Tensor
    rev: Optional[torch.Tensor]
    offsets: np.ndarray
    self_map: bool = False

    @property
    def identity_index(self) -> Optional[int]:
        """Offset slot whose table row is iota; only guaranteed for self-maps."""
        return identity_offset_index(self.offsets) if self.self_map else None

    def with_reverse(self, num_in: int) -> "BatchedPairTable":
        if self.rev is not None:
            return self
        return self._replace(rev=reverse_tables(self.table, num_in))

    def reversed(self) -> "BatchedPairTable":
        """Swap the in/out roles: the transposed-conv map."""
        if self.rev is None:
            raise ValueError("call with_reverse(num_in) first")
        return BatchedPairTable(self.rev, self.table, -self.offsets, self.self_map)


def _offsets_symmetric(offsets: np.ndarray) -> bool:
    """offsets[K-1-k] == -offsets[k] for all k (centred odd kernels)."""
    return bool(np.array_equal(offsets[::-1], -offsets))


def build_batched_pair_table(
    in_coords: torch.Tensor,
    in_num_valid: torch.Tensor,
    out_coords: torch.Tensor,
    out_num_valid: torch.Tensor,
    offsets: np.ndarray,
    stride: Sequence[int] | int = 1,
    self_map: bool = False,
    assume_sorted: bool = False,
) -> BatchedPairTable:
    """Pair tables with their reverse. For a self-map with a symmetric
    offset enumeration the reverse is the table with the offset axis
    flipped (``in[i] == out[o] + off_k  <=>  out[o] == in[i] - off_k``),
    so no scatter is needed."""
    table = build_pair_tables_batched(
        in_coords, in_num_valid, out_coords, out_num_valid, offsets,
        stride=stride, assume_sorted=assume_sorted,
    )
    if self_map and _offsets_symmetric(offsets):
        return BatchedPairTable(table, table.flip(1), offsets, self_map=True)
    return BatchedPairTable(table, None, offsets, self_map).with_reverse(in_coords.shape[1])


def generate_output_coords_and_kernel_map(
    voxels: Voxels,
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int = 1,
    out_coords: Optional[Voxels] = None,
    out_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, BatchedPairTable, Tuple[int, int, int]]:
    """(out_coords [B, M, 3], out_num_valid [B], map, out tensor stride) for a
    stride-1 conv (onto ``out_coords`` if given, else submanifold) or a
    parity-partition strided conv.

    Transposed, generative, dilated and non-parity strided maps are not
    ported; MinkUNet feeds its transposed convs a reversed encoder map."""
    ks = tuple(int(k) for k in _as3(kernel_size))
    st = tuple(int(s) for s in _as3(stride))
    offsets = kernel_offsets(ks)
    b, n, _ = voxels.coords.shape
    if all(s == 1 for s in st):
        target = voxels if out_coords is None else out_coords
        table = build_batched_pair_table(
            voxels.coords, voxels.num_valid, target.coords, target.num_valid,
            offsets, stride=1, self_map=out_coords is None,
            assume_sorted=voxels.lex_sorted,
        )
        return target.coords, target.num_valid, table, target.tensor_stride
    if not (parity_partition_applies(ks, st) and all(s & (s - 1) == 0 for s in st)):
        raise NotImplementedError(
            f"strided map for kernel {ks}, stride {st}: only power-of-two "
            "kernel == stride (parity partition) is ported"
        )
    cap = out_capacity or n
    oc, num_unique, to_u = parity_strided_unique(voxels.coords, voxels.num_valid, ks, cap)
    tab, rev = parity_pair_tables_from_unique(
        voxels.coords, voxels.valid_mask(), to_u, ks, cap
    )
    out_ts = tuple(t * s for t, s in zip(voxels.tensor_stride, st))
    return oc, torch.clamp(num_unique, max=cap), BatchedPairTable(tab, rev, offsets), out_ts


def spatially_sparse_conv(
    voxels: Voxels,
    weight: torch.Tensor,  # [K, C_in, C_out]
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int = 1,
    bias: Optional[torch.Tensor] = None,
    transposed: bool = False,
    out_coords: Optional[Voxels] = None,
    pair_table: Optional[BatchedPairTable] = None,
    out_capacity: Optional[int] = None,
) -> Tuple[Voxels, Optional[BatchedPairTable]]:
    """Sparse convolution over :class:`Voxels`, forward only.

    Returns (output voxels, kernel map or None for a 1x1 conv). The map can
    be fed back as ``pair_table`` together with ``out_coords`` to reuse it
    (a UNet stage's blocks, or a decoder's transposed conv with
    ``map.reversed()``). Features and weight are cast to the global compute
    dtype (``constants.set_compute_dtype``) when one is set.
    """
    ks = tuple(int(k) for k in _as3(kernel_size))
    st = tuple(int(s) for s in _as3(stride))
    features = voxels.features
    compute_dtype = constants.get_compute_dtype()
    if compute_dtype is not None:
        features = features.to(compute_dtype)
        weight = weight.to(compute_dtype)
    acc = constants.accum_dtype()

    if ks == (1, 1, 1) and st == (1, 1, 1) and not transposed:
        out = (features.to(acc) @ weight[0].to(acc)).to(features.dtype)
        if bias is not None:
            out = out + bias
        out = torch.where(voxels.valid_mask()[..., None], out, 0)
        return voxels.replace(features=out), None

    if pair_table is not None:
        if out_coords is None:
            raise ValueError("pair_table reuse requires out_coords")
        oc, onv, out_ts = out_coords.coords, out_coords.num_valid, out_coords.tensor_stride
        table = pair_table
    elif transposed:
        raise NotImplementedError(
            "transposed conv needs a pair_table (e.g. the encoder map's reversed())"
        )
    else:
        oc, onv, table, out_ts = generate_output_coords_and_kernel_map(
            voxels, ks, st, out_coords, out_capacity
        )
    if out_coords is not None:
        out_sorted = out_coords.lex_sorted
    elif any(s != 1 for s in st):
        out_sorted = True
    else:
        out_sorted = voxels.lex_sorted

    out_feats = implicit_gemm.implicit_gemm_fwd(
        features.contiguous(), weight.contiguous(), table.table.contiguous(), acc
    )
    if bias is not None:
        out_feats = out_feats + bias
    row_valid = torch.arange(oc.shape[1], device=oc.device)[None, :] < onv[:, None]
    out_feats = torch.where(row_valid[..., None], out_feats, 0)
    out = Voxels(
        coords=oc,
        features=out_feats,
        num_valid=onv,
        voxel_size=voxels.voxel_size,
        tensor_stride=tuple(out_ts),
        lex_sorted=out_sorted,
    )
    return out, table
