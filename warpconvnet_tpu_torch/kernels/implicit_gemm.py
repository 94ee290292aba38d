"""Implicit-GEMM sparse-conv forward: K2, the port of
``warpconvnet_tpu/kernels/implicit_gemm.py`` ``_igemm_kernel`` (:546) and its
entry ``implicit_gemm_fwd`` (:1022).

``out[b, o] = sum_k x[b, table[b, k, o]] @ w[k]``, where a -1 entry adds
exactly zero. fp32 or bf16 inputs, fp32 accumulation, output in ``x.dtype``.

:func:`implicit_gemm_fwd` runs the CUDA kernel (``csrc/implicit_gemm.cu``) on
CUDA tensors and :func:`implicit_gemm_fwd_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from warpconvnet_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def implicit_gemm_fwd_plain(
    x: torch.Tensor,  # [B, N_in, C_in]
    weight: torch.Tensor,  # [K, C_in, C_out]
    table: torch.Tensor,  # [B, K, N_out] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-offset gather + matmul (the JAX ``_fwd_impl`` scan, unrolled)."""
    b, _, c_in = x.shape
    k_vol, n_out = table.shape[1], table.shape[2]
    acc = torch.zeros((b, n_out, weight.shape[-1]), dtype=accum_dtype, device=x.device)
    for k in range(k_vol):
        t = table[:, k].to(torch.int64)
        rows = torch.gather(x, 1, t.clamp(min=0)[..., None].expand(-1, -1, c_in))
        rows = torch.where((t >= 0)[..., None], rows, 0).to(accum_dtype)
        acc += rows @ weight[k].to(accum_dtype)
    return acc.to(x.dtype)


def implicit_gemm_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    table: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K2 on CUDA tensors, :func:`implicit_gemm_fwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return implicit_gemm_fwd_plain(x, weight, table, accum_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"implicit_gemm_fwd: unsupported device {x.device}")
    if accum_dtype != torch.float32:
        raise ValueError("implicit_gemm_fwd: the CUDA kernel accumulates in float32 only")
    if x.dtype not in _DTYPE_CODES or weight.dtype != x.dtype:
        raise ValueError(
            f"implicit_gemm_fwd: x and weight must share float32 or bfloat16, "
            f"got {x.dtype} and {weight.dtype}"
        )
    if table.dtype != torch.int32:
        raise ValueError(f"implicit_gemm_fwd: table must be int32, got {table.dtype}")
    if x.ndim != 3 or weight.ndim != 3 or table.ndim != 3:
        raise ValueError("implicit_gemm_fwd: x, weight and table must be 3-D")
    b, n_in, c_in = x.shape
    k_vol, c_in_w, c_out = weight.shape
    if c_in_w != c_in or table.shape[0] != b or table.shape[1] != k_vol:
        raise ValueError(
            f"implicit_gemm_fwd: shapes x {tuple(x.shape)}, weight "
            f"{tuple(weight.shape)}, table {tuple(table.shape)} disagree"
        )
    for t in (weight, table):
        if t.device != x.device:
            raise ValueError("implicit_gemm_fwd: inputs on different devices")
    if not (x.is_contiguous() and weight.is_contiguous() and table.is_contiguous()):
        raise ValueError("implicit_gemm_fwd: inputs must be contiguous")
    n_out = table.shape[2]
    out = torch.empty((b, n_out, c_out), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    rc = lib.wct_igemm_fwd(
        x.data_ptr(), weight.data_ptr(), table.data_ptr(), out.data_ptr(),
        b, n_in, n_out, k_vol, c_in, c_out, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "implicit_gemm_fwd")
    implicit_gemm_fwd.launches += 1
    return out


implicit_gemm_fwd.launches = 0
