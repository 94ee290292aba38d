"""Spatially sparse depthwise convolution (counterpart of
``warpconvnet_tpu/nn/functional/sparse_conv_depth.py``).

The map is the dense conv's (``generate_output_coords_and_kernel_map``):
stride 1 (submanifold, or onto ``out_coords``) or a parity-partition strided
map. :class:`DepthwiseFma` carries every depthwise conv: forward K6; backward
K8 on a symmetric self-map, otherwise K6 as dgrad through ``rev`` plus K7.
The JAX package picks between its explicit scan and the Pallas kernels per
direction because of the TPU's gather windows; a Hopper kernel gathers rows
by index, so the port has one rule and no knob.

Unlike the dense conv, features keep their dtype (no compute-dtype cast)
and the weight is taken in the accumulation dtype, as the JAX scans
multiply in it (``sparse_conv_depth.py:66-78``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels, _as3
from warpconvnet_tpu_torch.kernels import depthwise_fma
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    BatchedPairTable,
    conv_detail,
    generate_output_coords_and_kernel_map,
)


class DepthwiseFma(torch.autograd.Function):
    """The depthwise table conv with its backward kernels (counterpart of
    the ``depthwise_conv_fma`` custom_vjp, JAX ``sparse_conv_depth.py:194-247``).

    Forward: K6. Backward: K8 when ``offsets`` is given (a symmetric
    self-map, whose reverse is ``table.flip(1)``); otherwise K6 as dgrad
    through ``rev`` and K7. dw comes back in fp32 and is cast to the
    weight's dtype, dx to the features' dtype. On CPU tensors every kernel
    wrapper runs its plain version, through the same routing. ``label``
    (kind, stride) names the backward's span, ``wcn.conv.bwd[dw-...]``.
    """

    @staticmethod
    def forward(ctx, features, weight, table, rev, offsets, accum_dtype, label):
        ctx.save_for_backward(features, weight, table, rev)
        ctx.offsets = offsets
        ctx.accum_dtype = accum_dtype
        ctx.label = label
        return depthwise_fma.depthwise_fma_fwd(features, weight, table, accum_dtype)

    @staticmethod
    def backward(ctx, g):
        features, weight, table, rev = ctx.saved_tensors
        acc = ctx.accum_dtype
        g = g.contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        with tracing.span("wcn.conv.bwd", lambda: conv_detail(*ctx.label, features, weight, table)):
            if ctx.offsets is not None:
                dx, dw = depthwise_fma.depthwise_fma_bwd_fused(
                    features, g, weight, table, ctx.offsets, acc
                )
            else:
                if need_dx:
                    dx = depthwise_fma.depthwise_fma_dgrad(g, weight, rev.contiguous(), acc)
                if need_dw:
                    dw = depthwise_fma.depthwise_fma_wgrad(features, g, table, acc)
        dx = dx.to(features.dtype) if need_dx else None
        dw = dw.to(weight.dtype) if need_dw else None
        return dx, dw, None, None, None, None, None


def depthwise_conv(
    features: torch.Tensor,  # [B, N_in, C]
    weight: torch.Tensor,  # [K, C]
    table: BatchedPairTable,
    accum_dtype: torch.dtype = torch.float32,
    label: Optional[Tuple[str, int]] = None,
) -> torch.Tensor:
    """[B, N_out, C] in features' dtype, differentiable in features and
    weight through :class:`DepthwiseFma`; the map picks the backward route.
    With no gradient to record K6 runs without the Function's overhead.
    The forward runs in the span ``wcn.conv.fwd[dw-...]``, named by
    ``label`` (kind, stride; default ``dw-sub`` for a self-map, else
    ``dw-onto``, stride 1)."""
    features = features.contiguous()
    weight = weight.to(accum_dtype).contiguous()
    tab = table.table.contiguous()
    label = label or ("dw-sub" if table.self_map else "dw-onto", 1)
    with tracing.span("wcn.conv.fwd", lambda: conv_detail(*label, features, weight, tab)):
        if not (torch.is_grad_enabled() and (features.requires_grad or weight.requires_grad)):
            return depthwise_fma.depthwise_fma_fwd(features, weight, tab, accum_dtype)
        if table.symmetric_self_map:
            return DepthwiseFma.apply(features, weight, tab, None, table.offsets, accum_dtype,
                                      label)
        if table.rev is None:
            raise ValueError("the backward of a map that is not a symmetric self-map needs rev")
        return DepthwiseFma.apply(features, weight, tab, table.rev, None, accum_dtype, label)


def spatially_sparse_depthwise_conv(
    voxels: Voxels,
    weight: torch.Tensor,  # [K, C]
    kernel_size: Sequence[int] | int,
    stride: Sequence[int] | int = 1,
    bias: Optional[torch.Tensor] = None,
    out_coords: Optional[Voxels] = None,
    pair_table: Optional[BatchedPairTable] = None,
    out_capacity: Optional[int] = None,
) -> Tuple[Voxels, BatchedPairTable]:
    """Depthwise sparse conv over :class:`Voxels`, differentiable in the
    features, ``weight`` and ``bias``. Returns (output voxels, kernel map);
    the map can be fed back as ``pair_table`` with ``out_coords``.

    Strides other than 1 and the power-of-two kernel == stride parity
    partition raise ``NotImplementedError``, as in the dense conv."""
    ks = tuple(int(k) for k in _as3(kernel_size))
    st = tuple(int(s) for s in _as3(stride))
    if pair_table is not None:
        if out_coords is None:
            raise ValueError("pair_table reuse requires out_coords")
        oc, onv, out_ts = out_coords.coords, out_coords.num_valid, out_coords.tensor_stride
        table = pair_table
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

    kind = "dw-down" if any(s != 1 for s in st) else "dw-sub" if table.self_map else "dw-onto"
    out_feats = depthwise_conv(voxels.features, weight, table, constants.accum_dtype(),
                               label=(kind, max(st)))
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
