"""Spatially sparse convolution (counterpart of
``warpconvnet_tpu/nn/functional/sparse_conv.py``).

The kernel map is a dense pair table built by sort and search (kernel K1
for 3^3 submanifold maps) or, for even kernel == stride convs, by the
parity partition. Every conv that uses a table, whatever its stride or
direction, dense or depthwise, runs through :func:`table_conv` and
:class:`TableConv` with its family's kernels (:class:`TableKernels`): the
implicit-GEMM K2-K4 for the dense conv (:data:`DENSE`), the depthwise
K6-K8 for the depthwise conv (``sparse_conv_depth.DEPTHWISE``); 1x1 convs
are a matmul.

A map that a dense conv builds gets a row order of its output rows and one
of its input rows (:meth:`BatchedPairTable.with_orders`, from
:func:`~warpconvnet_tpu_torch.ops.kernel_map.row_order`: rows grouped by
offset mask), computed once, where the conv builds the map; every K2 and
K4 call on the map, and every K2 dgrad on its reverse, takes its tiles in
that order, so that a 64-row tile meets few offsets. The depthwise and
pooling paths, which build maps here too, read no order and compute none.

Backward routing, one rule for both families and no knob: a symmetric
self-map (every 3^3 submanifold conv) runs the fused K4 (K8); every other
table (strided and transposed) runs K2 (K6) as dgrad through the reverse
table and K3 (K7) for the weight gradient. The JAX auto dispatch sends
strided and transposed convs to its explicit scan
(``sparse_conv.py:984-994``) only because of the TPU's gather windows; a
Hopper kernel gathers rows by index and needs no such exception.

A grouped conv (``groups > 1``, weight [K, G, C_in/G, C_out/G]) embeds its
weight block-diagonally into [K, C_in, C_out] and rides the same path, as
the JAX fast path does (``sparse_conv.py:873-909``); the embedding is
differentiable, so dw comes back by block extraction. JAX keeps an explicit
grouped scan for unsorted input and pinned backends; K2 gathers rows by
index, so the port serves both through the embedding.
"""

from __future__ import annotations

from types import ModuleType
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from warpconvnet_tpu_torch import constants, tracing
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
    row_order,
)


class BatchedPairTable(NamedTuple):
    """Per-scene pair tables stacked on a batch axis.

    table [B, K, N_out] int32; stored_rev [B, K, N_in] int32 (None for a
    symmetric self-map, whose reverse :attr:`rev` gives); offsets [K, 3]
    numpy; self_map: in and out are the same coordinate set. order [B,
    N_out] and rev_order [B, N_in] int32: the row orders K2 and K4 take
    their tiles in on ``table`` and on the reverse (None: the index order,
    until :meth:`with_orders`).
    """

    table: torch.Tensor
    stored_rev: Optional[torch.Tensor]
    offsets: np.ndarray
    self_map: bool = False
    order: Optional[torch.Tensor] = None
    rev_order: Optional[torch.Tensor] = None

    @property
    def symmetric_self_map(self) -> bool:
        """A self-map over symmetric offsets: its reverse is
        ``table.flip(1)``, so the fused backward K4 or K8 reads ``table``
        alone."""
        return self.self_map and implicit_gemm.offsets_symmetric(self.offsets)

    @property
    def rev(self) -> Optional[torch.Tensor]:
        """The reverse table [B, K, N_in]: the stored one, or a symmetric
        self-map's ``table.flip(1)``, a new copy at each read. No forward or
        backward reads a symmetric self-map's reverse: K4 and K8 flip the
        offset axis themselves."""
        if self.stored_rev is None and self.symmetric_self_map:
            return self.table.flip(1)
        return self.stored_rev

    @property
    def identity_index(self) -> Optional[int]:
        """Offset slot whose table row is iota; only guaranteed for self-maps."""
        return identity_offset_index(self.offsets) if self.self_map else None

    @tracing.spanned("wcn.map.with_orders")
    def with_orders(self) -> "BatchedPairTable":
        """This map with its row orders (itself if it has them). A
        symmetric self-map's reverse, ``table.flip(1)``, has its rows' masks
        reversed: the same classes, so one order serves both."""
        if self.order is not None:
            return self
        order = row_order(self.table)
        rev_order = order if self.symmetric_self_map else row_order(self.stored_rev)
        return self._replace(order=order, rev_order=rev_order)

    def reversed(self) -> "BatchedPairTable":
        """Swap the in/out roles (and the row orders): the transposed-conv map."""
        rev = self.rev
        if rev is None:
            raise ValueError("the map has no reverse table")
        return BatchedPairTable(rev, self.table, -self.offsets, self.self_map,
                                self.rev_order, self.order)


@tracing.spanned("wcn.map.build_batched_pair_table")
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
    """Pair tables with their reverse. A self-map with a symmetric offset
    enumeration stores none: its reverse is the table with the offset axis
    flipped (``in[i] == out[o] + off_k  <=>  out[o] == in[i] - off_k``),
    which :attr:`BatchedPairTable.rev` gives where it is read."""
    table = build_pair_tables_batched(
        in_coords, in_num_valid, out_coords, out_num_valid, offsets,
        stride=stride, assume_sorted=assume_sorted,
    )
    bpt = BatchedPairTable(table, None, offsets, self_map)
    if bpt.symmetric_self_map:
        return bpt
    return bpt._replace(stored_rev=reverse_tables(table, in_coords.shape[1]))


@tracing.spanned("wcn.map.generate_output_coords_and_kernel_map")
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


def conv_detail(kind: str, stride: int, x: torch.Tensor, weight: torch.Tensor,
                table: torch.Tensor) -> str:
    """A conv span's detail: ``kind B N_in->N_out C_in->C_out K stride dtype``."""
    b, n_in, c_in = x.shape
    dtype = str(x.dtype).replace("torch.", "")
    return (f"{kind} {b} {n_in}->{table.shape[2]} {c_in}->{weight.shape[-1]} "
            f"{table.shape[1]} {stride} {dtype}")


class TableKernels(NamedTuple):
    """A family of table-conv kernels: the wrappers ``<prefix>_fwd``,
    ``_dgrad``, ``_wgrad`` and ``_bwd_fused`` of ``module``, looked up on
    it at each call; ``ordered``: they take the map's row orders; ``tag``
    leads the kind in the conv spans' details."""

    module: ModuleType
    prefix: str
    ordered: bool
    tag: str

    def __call__(self, kernel: str, *args, order: Optional[torch.Tensor] = None):
        """Wrapper ``<prefix>_<kernel>`` on ``args``, its tiles in ``order``
        where one is given."""
        fn = getattr(self.module, f"{self.prefix}_{kernel}")
        return fn(*args) if order is None else fn(*args, order=order)


DENSE = TableKernels(implicit_gemm, "implicit_gemm", ordered=True, tag="")


class TableConv(torch.autograd.Function):
    """A table conv with its backward kernels, for either family of
    :class:`TableKernels` (counterpart of the ``conv_gemm`` custom_vjp, JAX
    ``sparse_conv.py:389-472``, and of ``depthwise_conv_fma``,
    ``sparse_conv_depth.py:194-247``).

    Forward: K2 (K6). Backward, one rule for both families: the fused K4
    (K8) when ``offsets`` is given (a symmetric self-map, whose reverse is
    ``table.flip(1)``); otherwise K2 (K6) as dgrad through ``rev`` and K3
    (K7). K2 and K4 take their tiles in ``order`` (the table's rows),
    K2-dgrad in ``rev_order``; the depthwise kernels take none. dw comes
    back in fp32 (``accum_dtype``) and is cast to the weight's dtype, dx to
    the features' dtype. On CPU tensors every kernel wrapper runs its plain
    version, through the same routing. ``label`` (kind, stride) names the
    backward's span, ``wcn.conv.bwd[...]``.
    """

    @staticmethod
    def forward(ctx, features, weight, table, rev, offsets, accum_dtype, order, rev_order,
                kernels, label):
        ctx.save_for_backward(features, weight, table, rev, order, rev_order)
        ctx.offsets = offsets
        ctx.accum_dtype = accum_dtype
        ctx.kernels = kernels
        ctx.label = label
        return kernels("fwd", features, weight, table, accum_dtype, order=order)

    @staticmethod
    def backward(ctx, g):
        features, weight, table, rev, order, rev_order = ctx.saved_tensors
        acc, kernels = ctx.accum_dtype, ctx.kernels
        g = g.contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        with tracing.span("wcn.conv.bwd", lambda: conv_detail(*ctx.label, features, weight, table)):
            if ctx.offsets is not None:
                dx, dw = kernels("bwd_fused", features, g, weight, table, ctx.offsets, acc,
                                 order=order)
            else:
                if need_dx:
                    dx = kernels("dgrad", g, weight, rev.contiguous(), acc, order=rev_order)
                if need_dw:
                    dw = kernels("wgrad", features, g, table, acc)
        dx = dx.to(features.dtype) if need_dx else None
        dw = dw.to(weight.dtype) if need_dw else None
        return dx, dw, None, None, None, None, None, None, None, None


def table_conv(
    features: torch.Tensor,  # [B, N_in, C_in]
    weight: torch.Tensor,  # [K, C_in, C_out] (DENSE) or [K, C] (depthwise)
    table: BatchedPairTable,
    kernels: TableKernels,
    accum_dtype: torch.dtype = torch.float32,
    label: Optional[Tuple[str, int]] = None,
) -> torch.Tensor:
    """[B, N_out, C_out] in features' dtype, differentiable in features and
    weight through :class:`TableConv`; the map picks the backward route,
    ``kernels`` the kernels. With no gradient to record (inference mode,
    ``no_grad``, or neither input requiring one) the forward kernel runs
    without the Function's overhead. The forward runs in the span
    ``wcn.conv.fwd[...]``, named by ``label`` (kind, stride; default
    ``sub`` for a self-map, else ``onto``, after the family's tag, stride 1)."""
    features, weight = features.contiguous(), weight.contiguous()
    tab = table.table.contiguous()
    order, rev_order = (table.order, table.rev_order) if kernels.ordered else (None, None)
    label = label or (kernels.tag + ("sub" if table.self_map else "onto"), 1)
    with tracing.span("wcn.conv.fwd", lambda: conv_detail(*label, features, weight, tab)):
        if not (torch.is_grad_enabled() and (features.requires_grad or weight.requires_grad)):
            return kernels("fwd", features, weight, tab, accum_dtype, order=order)
        if table.symmetric_self_map:
            return TableConv.apply(features, weight, tab, None, table.offsets, accum_dtype, order,
                                   None, kernels, label)
        if table.stored_rev is None:
            raise ValueError("the backward of a map that is not a symmetric self-map needs rev")
        return TableConv.apply(features, weight, tab, table.stored_rev, None, accum_dtype, order,
                               rev_order, kernels, label)


def block_diagonal(weight: torch.Tensor) -> torch.Tensor:
    """Grouped weight [K, G, C_in/G, C_out/G] -> dense [K, C_in, C_out]
    with group g's block at rows g*C_in/G and columns g*C_out/G, zero
    elsewhere (exact: a product with a 0/1 mask), differentiable."""
    k, g, cg, cd = weight.shape
    eye = torch.eye(g, dtype=weight.dtype, device=weight.device)
    return (weight[:, :, :, None, :] * eye[None, :, None, :, None]).reshape(k, g * cg, g * cd)


def table_output(
    voxels: Voxels,
    coords: torch.Tensor,
    num_valid: torch.Tensor,
    tensor_stride: Sequence[int],
    features: torch.Tensor,
    stride: Sequence[int],
    out_coords: Optional[Voxels] = None,
    bias: Optional[torch.Tensor] = None,
) -> Voxels:
    """The output of a table conv or pooling over ``voxels``: ``features``
    plus ``bias``, pad rows zero. Strided outputs come out lex-sorted;
    stride 1 keeps its target's order (``out_coords``, else the input)."""
    if bias is not None:
        features = features + bias
    row_valid = torch.arange(coords.shape[1], device=coords.device)[None, :] < num_valid[:, None]
    features = torch.where(row_valid[..., None], features, 0)
    if out_coords is not None:
        out_sorted = out_coords.lex_sorted
    elif any(s != 1 for s in stride):
        out_sorted = True
    else:
        out_sorted = voxels.lex_sorted
    return Voxels(
        coords=coords,
        features=features,
        num_valid=num_valid,
        voxel_size=voxels.voxel_size,
        tensor_stride=tuple(tensor_stride),
        lex_sorted=out_sorted,
    )


def conv_over_map(
    voxels: Voxels,
    features: torch.Tensor,
    weight: torch.Tensor,
    kernels: TableKernels,
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int,
    bias: Optional[torch.Tensor],
    out_coords: Optional[Voxels],
    pair_table: Optional[BatchedPairTable],
    out_capacity: Optional[int],
    transposed: bool = False,
) -> Tuple[Voxels, BatchedPairTable]:
    """A table conv of ``features`` (the rows of ``voxels``, cast as the
    family takes them) over its map: ``pair_table`` onto ``out_coords``
    when given, else the map built here, with its row orders for a family
    that reads them; then :func:`table_conv` and :func:`table_output`.
    Returns (output voxels, map)."""
    st = tuple(int(s) for s in _as3(stride))
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
            voxels, kernel_size, st, out_coords, out_capacity
        )
        if kernels.ordered:
            table = table.with_orders()
    kind = "up" if transposed else "down" if any(s != 1 for s in st) else (
        "sub" if table.self_map else "onto")
    out_feats = table_conv(features, weight, table, kernels, constants.accum_dtype(),
                           label=(kernels.tag + kind, max(st)))
    return table_output(voxels, oc, onv, out_ts, out_feats, st, out_coords, bias), table


def spatially_sparse_conv(
    voxels: Voxels,
    weight: torch.Tensor,  # [K, C_in, C_out], or [K, G, C_in/G, C_out/G]
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int = 1,
    bias: Optional[torch.Tensor] = None,
    transposed: bool = False,
    out_coords: Optional[Voxels] = None,
    pair_table: Optional[BatchedPairTable] = None,
    out_capacity: Optional[int] = None,
    groups: int = 1,
) -> Tuple[Voxels, Optional[BatchedPairTable]]:
    """Sparse convolution over :class:`Voxels`, differentiable in the
    features, ``weight`` and ``bias``.

    Returns (output voxels, kernel map or None for a 1x1 conv). The map can
    be fed back as ``pair_table`` together with ``out_coords`` to reuse it
    (a UNet stage's blocks, or a decoder's transposed conv with
    ``map.reversed()``). Features and weight are cast to the global compute
    dtype (``constants.set_compute_dtype``) when one is set. With
    ``groups > 1`` the weight is grouped and embedded by
    :func:`block_diagonal`.
    """
    ks = tuple(int(k) for k in _as3(kernel_size))
    st = tuple(int(s) for s in _as3(stride))
    features = voxels.features
    compute_dtype = constants.get_compute_dtype()
    if compute_dtype is not None:
        features = features.to(compute_dtype)
        weight = weight.to(compute_dtype)
    if groups > 1:
        if weight.ndim != 4 or weight.shape[1] != groups:
            raise ValueError(
                f"groups={groups} needs a [K, G, C_in/G, C_out/G] weight, got {tuple(weight.shape)}"
            )
        weight = block_diagonal(weight)

    if ks == (1, 1, 1) and st == (1, 1, 1) and not transposed:
        acc = constants.accum_dtype()
        out = (features.to(acc) @ weight[0].to(acc)).to(features.dtype)
        if bias is not None:
            out = out + bias
        out = torch.where(voxels.valid_mask()[..., None], out, 0)
        return voxels.replace(features=out), None
    return conv_over_map(voxels, features, weight, DENSE, ks, st, bias, out_coords, pair_table,
                         out_capacity, transposed)
