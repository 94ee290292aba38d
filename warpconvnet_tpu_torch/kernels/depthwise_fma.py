"""Depthwise sparse-conv kernels: the forward K6 (also dgrad, on the reverse
table), the weight gradient K7 and the fused self-map backward K8. Ports of
``warpconvnet_tpu/kernels/depthwise_fma.py``:

- K6 ``_depth_fwd_kernel`` (:152, entry ``depthwise_fma_fwd`` :522):
  ``out[b, o, c] = sum_k x[b, table[b, k, o], c] * w[k, c]``; as dgrad
  (``nn/functional/sparse_conv_depth.py:131-140``) it runs on ``(g, w, rev)``.
- K7 ``_depth_wgrad_kernel`` (:261, entry ``depthwise_fma_wgrad`` :607):
  ``dw[k, c] = sum_{b, o} x[b, table[b, k, o], c] * g[b, o, c]``, fp32, on
  any map: K8's dw blocks launched alone.
- K8 ``_depth_bwd_fused_kernel`` (:367, entry ``depthwise_fma_bwd_fused``
  :692): dx and dw of a symmetric self-map in one launch.

Unlike the dense conv, features stay in their dtype (fp32 or bf16) and the
weight stays fp32; products and sums are fp32 (the JAX explicit scans,
``sparse_conv_depth.py:66-105``). Outputs and dx come back in the features'
dtype, dw in fp32. A -1 table entry adds exactly zero. Each wrapper runs its
CUDA kernel (``csrc/depthwise_fma.cu``) on CUDA tensors and its ``*_plain``
version on CPU tensors, counts its launches (``tracing`` host counter
``launches.<wrapper>``), and raises on what its kernel does not take.

K6 walks tiles of 64 or 128 rows with the table tile of each round of 32
offsets staged ahead in shared memory; each row sums its offsets in
ascending order with fp32 ``fmaf``, so K6's output has the same bits on
every call. K8 is one launch of two kinds of blocks: dx blocks run K6's
walk on ``(g, w.flip(0), table)`` (its bits), and dw blocks, one for each
offset and chunk of rows, sum their pairs on chip and add into dw once;
K7 is those dw blocks alone. While recording, the kernels count those
floats in ``tracing``'s device counters ``k8.dw_floats`` and
``k7.dw_floats``, which :func:`bwd_fused_dw_adds` models on the host from
the table and the launch's plan (``depthwise_fma_bwd_fused.plan``,
``depthwise_fma_wgrad.plan``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.kernels import _build
from warpconvnet_tpu_torch.kernels.implicit_gemm import _check_self_map, _gather_rows

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 1024  # csrc/depthwise_fma.cu: at most 128 lanes of 8 channels


def depthwise_fma_fwd_plain(
    x: torch.Tensor,  # [B, N_in, C]
    weight: torch.Tensor,  # [K, C]
    table: torch.Tensor,  # [B, K, N_out] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-offset gather and multiply-add (the JAX ``_depth_fwd_impl``)."""
    b, c = x.shape[0], x.shape[-1]
    acc = torch.zeros((b, table.shape[2], c), dtype=accum_dtype, device=x.device)
    for k in range(table.shape[1]):
        acc += _gather_rows(x, table[:, k]).to(accum_dtype) * weight[k].to(accum_dtype)
    return acc.to(x.dtype)


def depthwise_fma_dgrad_plain(
    g: torch.Tensor,  # [B, N_out, C]
    weight: torch.Tensor,  # [K, C]
    rev: torch.Tensor,  # [B, K, N_in] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """dx [B, N_in, C] in g's dtype: the forward on the reverse table (the
    JAX ``_depth_dgrad_impl``)."""
    return depthwise_fma_fwd_plain(g, weight, rev, accum_dtype)


def depthwise_fma_wgrad_plain(
    x: torch.Tensor,  # [B, N_in, C]
    g: torch.Tensor,  # [B, N_out, C]
    table: torch.Tensor,  # [B, K, N_out] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """dw [K, C] in ``accum_dtype``: per offset a gather and a sum over all
    rows of all scenes (the JAX ``_depth_wgrad_impl``)."""
    g = g.to(accum_dtype)
    return torch.stack([
        (_gather_rows(x, table[:, k]).to(accum_dtype) * g).sum(dim=(0, 1))
        for k in range(table.shape[1])
    ])


def depthwise_fma_bwd_fused_plain(
    x: torch.Tensor,  # [B, N, C]
    g: torch.Tensor,  # [B, N, C]
    weight: torch.Tensor,  # [K, C]
    table: torch.Tensor,  # [B, K, N] int32, a symmetric self-map
    offsets: np.ndarray,
    accum_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw in ``accum_dtype``): dgrad through the K-flipped
    table (the self-map's reverse) and wgrad through the table."""
    _check_self_map("depthwise_fma_bwd_fused", x, table, offsets)
    dx = depthwise_fma_dgrad_plain(g, weight, table.flip(1), accum_dtype).to(x.dtype)
    return dx, depthwise_fma_wgrad_plain(x, g, table, accum_dtype)


def bwd_fused_dw_adds(table: torch.Tensor, c: int, chunk_rows: int) -> int:
    """Floats that K8's or K7's dw blocks add into dw on ``table`` [B, K,
    N] at C channels, a host model of the kernels' counts (``tracing``
    ``k8.dw_floats``, ``k7.dw_floats``): each
    (scene, offset, chunk of ``chunk_rows`` rows) with a pair sums its
    pairs on chip and adds its C channels of dw[k] once. The launch's
    ``chunk_rows`` is in ``depthwise_fma_bwd_fused.plan`` or
    ``depthwise_fma_wgrad.plan``."""
    b, k, n = table.shape
    chunks = -(-n // chunk_rows)
    met = torch.nn.functional.pad(table >= 0, (0, chunks * chunk_rows - n))
    return int(met.reshape(b, k, chunks, chunk_rows).any(-1).sum()) * c


def _cuda_args(name, accum_dtype, feats, table, weight=None):
    """Validate what every kernel of this module needs: CUDA, fp32
    accumulation, features of one float dtype, an fp32 [K, C] weight, an
    int32 table, 3-D contiguous inputs on one device, C <= MAX_CHANNELS."""
    x = feats[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if accum_dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel accumulates in float32 only")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in feats):
        raise ValueError(
            f"{name}: features must share float32 or bfloat16, got "
            f"{[str(t.dtype) for t in feats]}"
        )
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32, got {table.dtype}")
    c = x.shape[-1]
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"{name}: {c} channels, the kernel takes 1..{MAX_CHANNELS}")
    tensors = (*feats, table)
    if weight is not None:
        if weight.dtype != torch.float32 or weight.ndim != 2:
            raise ValueError(f"{name}: weight must be float32 [K, C], got {weight.dtype} "
                             f"{tuple(weight.shape)}")
        if tuple(weight.shape) != (table.shape[1], c):
            raise ValueError(f"{name}: weight {tuple(weight.shape)} does not match "
                             f"table {tuple(table.shape)} and C={c}")
        tensors += (weight,)
    for t in tensors:
        if t is not weight and t.ndim != 3:
            raise ValueError(f"{name}: features and table must be 3-D")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.shape[-1] != c for t in feats) or table.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]} disagree")
    return _build.load_library(), torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(name, x, weight, table, accum_dtype) -> torch.Tensor:
    lib, stream = _cuda_args(name, accum_dtype, (x,), table, weight)
    b, n_in, c = x.shape
    k_vol, n_out = table.shape[1], table.shape[2]
    out = torch.empty((b, n_out, c), dtype=x.dtype, device=x.device)
    rc = lib.wct_depth_fwd(
        x.data_ptr(), weight.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, n_in, n_out, k_vol, c, _DTYPE_CODES[x.dtype], stream,
    )
    _build.check(lib, rc, name)
    return out


def depthwise_fma_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    table: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K6 on CUDA tensors, :func:`depthwise_fma_fwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return depthwise_fma_fwd_plain(x, weight, table, accum_dtype)
    out = _launch_fwd("depthwise_fma_fwd", x, weight, table, accum_dtype)
    tracing.add("launches.depthwise_fma_fwd")
    return out


def depthwise_fma_dgrad(
    g: torch.Tensor,
    weight: torch.Tensor,
    rev: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K6 on ``(g, w, rev)`` on CUDA tensors (counted as
    ``launches.depthwise_fma_dgrad``, not as the forward's launches),
    :func:`depthwise_fma_dgrad_plain` on CPU tensors."""
    if g.device.type == "cpu":
        return depthwise_fma_dgrad_plain(g, weight, rev, accum_dtype)
    dx = _launch_fwd("depthwise_fma_dgrad", g, weight, rev, accum_dtype)
    tracing.add("launches.depthwise_fma_dgrad")
    return dx


def depthwise_fma_wgrad(
    x: torch.Tensor,
    g: torch.Tensor,
    table: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K7 on CUDA tensors, :func:`depthwise_fma_wgrad_plain` on CPU tensors.
    Each launch leaves its plan in ``.plan``: its dw blocks and the rows of
    their chunks."""
    if x.device.type == "cpu":
        return depthwise_fma_wgrad_plain(x, g, table, accum_dtype)
    name = "depthwise_fma_wgrad"
    lib, stream = _cuda_args(name, accum_dtype, (x, g), table)
    b, n_in, c = x.shape
    k_vol, n_out = table.shape[1], table.shape[2]
    if g.shape[:2] != (b, n_out):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"table {tuple(table.shape)} disagree"
        )
    dw = torch.zeros((k_vol, c), dtype=torch.float32, device=x.device)
    plan = (ctypes.c_int * 2)()
    rc = lib.wct_depth_wgrad(
        x.data_ptr(), g.data_ptr(), table.data_ptr(), dw.data_ptr(),
        b, n_in, n_out, k_vol, c, _DTYPE_CODES[x.dtype],
        tracing.counter_ptr(x.device, "k7.dw_floats"), ctypes.addressof(plan), stream,
    )
    _build.check(lib, rc, name)
    tracing.add("launches.depthwise_fma_wgrad")
    depthwise_fma_wgrad.plan = dict(dw_blocks=plan[0], chunk_rows=plan[1])
    return dw


def depthwise_fma_bwd_fused(
    x: torch.Tensor,
    g: torch.Tensor,
    weight: torch.Tensor,
    table: torch.Tensor,
    offsets: np.ndarray,
    accum_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on CUDA tensors, :func:`depthwise_fma_bwd_fused_plain` on CPU
    tensors. Raises unless ``table`` is a self-map (n_in == n_out) over
    symmetric ``offsets``, whose reverse is ``table.flip(1)``: dx is taken
    through that flip, as in the plain version. Each launch leaves its plan
    in ``.plan``: its dw blocks and the rows of their chunks."""
    if x.device.type == "cpu":
        return depthwise_fma_bwd_fused_plain(x, g, weight, table, offsets, accum_dtype)
    name = "depthwise_fma_bwd_fused"
    _check_self_map(name, x, table, offsets)
    lib, stream = _cuda_args(name, accum_dtype, (x, g), table, weight)
    b, n, c = x.shape
    if g.shape != x.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)} != x {tuple(x.shape)}")
    k_vol = table.shape[1]
    dx = torch.empty_like(x)
    dw = torch.zeros((k_vol, c), dtype=torch.float32, device=x.device)
    plan = (ctypes.c_int * 2)()
    rc = lib.wct_depth_bwd_fused(
        x.data_ptr(), g.data_ptr(), weight.data_ptr(), table.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), b, n, k_vol, c, _DTYPE_CODES[x.dtype],
        tracing.counter_ptr(x.device, "k8.dw_floats"), ctypes.addressof(plan), stream,
    )
    _build.check(lib, rc, name)
    tracing.add("launches.depthwise_fma_bwd_fused")
    depthwise_fma_bwd_fused.plan = dict(dw_blocks=plan[0], chunk_rows=plan[1])
    return dx, dw


depthwise_fma_wgrad.plan = None
depthwise_fma_bwd_fused.plan = None
