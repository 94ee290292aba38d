"""Implicit-GEMM sparse-conv kernels: the forward K2 and, for the backward,
K2 again as dgrad, the weight gradient K3 and the fused self-map backward
K4. Ports of ``warpconvnet_tpu/kernels/implicit_gemm.py``:

- K2 ``_igemm_kernel`` (:546, entry ``implicit_gemm_fwd`` :1022):
  ``out[b, o] = sum_k x[b, table[b, k, o]] @ w[k]``; as dgrad
  (``nn/functional/sparse_conv.py:301-311``) it runs on ``(g, w^T, rev)``.
- K3 ``_igemm_wgrad_kernel`` (:683, entry ``implicit_gemm_wgrad`` :1122):
  ``dw[k] = sum_{b, o} x[b, table[b, k, o]]^T @ g[b, o]``, fp32, on any
  map: K4's dw blocks launched alone, over chunks of rows whose length the
  launch picks (``implicit_gemm_wgrad.plan``).
- K4 ``_igemm_bwd_fused_kernel`` (:801, entry ``implicit_gemm_bwd_fused``
  :1212): dx and dw of a symmetric self-map in one pass.

A -1 table entry adds exactly zero. Inputs are fp32 or bf16 with fp32
accumulation; conv outputs and dx come back in the input dtype, dw in fp32.
Each wrapper runs its CUDA kernel (``csrc/implicit_gemm*.cu``) on CUDA
tensors and its ``*_plain`` version on CPU tensors, counts its launches
(``tracing`` host counter ``launches.<wrapper>``), and raises on what its
kernel does not take.

K2 and K4 take their tiles of ``TILE_ROWS`` rows in a row order of the map
(``order`` [B, N] int32, a permutation of each scene's rows; None: the
index order), such as ``ops.kernel_map.row_order``'s, which groups rows with
equal offset masks so that a tile meets few offsets. The order changes
which rows share a tile, never a result: K2's output has the same bits
under any order. The plain versions take no order.

While recording (``tracing``), the kernels count what they did on the
card in the registry's device counters: K2's tile work
(``k2.fwd_tile_work``, ``k2.dgrad_tile_work``), K4's (``k4.tile_work``)
and the floats K4 and K3 add into dw with atomics (``k4.dw_floats``,
``k3.dw_floats``), which :func:`tile_work` and
:func:`bwd_fused_dw_atomics` model on the host; the K2 forward's wrapper
adds its table's useful pairs (``k2.fwd_pairs``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 64  # rows of a K2 / K4 tile (csrc/igemm.cuh BM)
DW_ROWS = 4096  # rows of a bf16 K4 weight-gradient chunk, K3's longest (csrc/igemm.cuh DW_ROWS)
F_DW_ROWS = 2048  # rows of an fp32 one (csrc/igemm.cuh F_DW_ROWS)


def offsets_symmetric(offsets: np.ndarray) -> bool:
    """offsets[K-1-k] == -offsets[k] for all k (centred odd kernels): on a
    self-map the reverse table is then the table with its offset axis
    flipped."""
    offsets = np.asarray(offsets)
    return bool(np.array_equal(offsets[::-1], -offsets))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] rows at idx [B, M]; zero rows where idx is -1."""
    t = idx.to(torch.int64)
    rows = torch.gather(x, 1, t.clamp(min=0)[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where((t >= 0)[..., None], rows, 0)


def implicit_gemm_fwd_plain(
    x: torch.Tensor,  # [B, N_in, C_in]
    weight: torch.Tensor,  # [K, C_in, C_out]
    table: torch.Tensor,  # [B, K, N_out] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-offset gather + matmul (the JAX ``_fwd_impl`` scan, unrolled)."""
    b = x.shape[0]
    k_vol, n_out = table.shape[1], table.shape[2]
    acc = torch.zeros((b, n_out, weight.shape[-1]), dtype=accum_dtype, device=x.device)
    for k in range(k_vol):
        acc += _gather_rows(x, table[:, k]).to(accum_dtype) @ weight[k].to(accum_dtype)
    return acc.to(x.dtype)


def implicit_gemm_dgrad_plain(
    g: torch.Tensor,  # [B, N_out, C_out]
    weight: torch.Tensor,  # [K, C_in, C_out]
    rev: torch.Tensor,  # [B, K, N_in] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """dx [B, N_in, C_in] in g's dtype: the forward on (g, w^T, rev), the
    JAX ``_dgrad_impl``."""
    return implicit_gemm_fwd_plain(g, weight.transpose(1, 2), rev, accum_dtype)


def implicit_gemm_wgrad_plain(
    x: torch.Tensor,  # [B, N_in, C_in]
    g: torch.Tensor,  # [B, N_out, C_out]
    table: torch.Tensor,  # [B, K, N_out] int32
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """dw [K, C_in, C_out] in ``accum_dtype``: per offset a gather and a
    contraction over all rows of all scenes (the JAX ``_wgrad_impl``)."""
    g = g.to(accum_dtype)
    return torch.stack([
        torch.einsum("bmc,bmd->cd", _gather_rows(x, table[:, k]).to(accum_dtype), g)
        for k in range(table.shape[1])
    ])


def _check_self_map(name: str, x: torch.Tensor, table: torch.Tensor, offsets) -> None:
    if not offsets_symmetric(offsets):
        raise ValueError(f"{name}: offsets are not symmetric (offsets[K-1-k] != -offsets[k])")
    if len(offsets) != table.shape[1]:
        raise ValueError(f"{name}: {len(offsets)} offsets for a table of {table.shape[1]}")
    if x.shape[1] != table.shape[2]:
        raise ValueError(
            f"{name}: needs a self-map, got n_in={x.shape[1]} != n_out={table.shape[2]}"
        )


def implicit_gemm_bwd_fused_plain(
    x: torch.Tensor,  # [B, N, C_in]
    g: torch.Tensor,  # [B, N, C_out]
    weight: torch.Tensor,  # [K, C_in, C_out]
    table: torch.Tensor,  # [B, K, N] int32, a symmetric self-map
    offsets: np.ndarray,
    accum_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dw in ``accum_dtype``): dgrad through the K-flipped
    table (the self-map's reverse) and wgrad through the table."""
    _check_self_map("implicit_gemm_bwd_fused", x, table, offsets)
    dx = implicit_gemm_dgrad_plain(g, weight, table.flip(1), accum_dtype).to(x.dtype)
    return dx, implicit_gemm_wgrad_plain(x, g, table, accum_dtype)


def tile_work(
    table: torch.Tensor,  # [B, K, N] int32
    order: Optional[torch.Tensor] = None,  # [B, N] int32, or None for the index order
    tile_rows: int = TILE_ROWS,
) -> Tuple[int, int]:
    """(tile work, useful pairs) of K2 on ``table`` with its tiles taken in
    ``order``: a tile of ``tile_rows`` rows computes all its rows for every
    offset that has a pair among them, so the work is tile_rows x the
    non-empty (tile, offset) pairs; the useful pairs are the entries >= 0.
    Their ratio is the share of K2's tensor-core work that adds zeros. A
    host model of the kernels' count (``tracing`` ``k2.fwd_tile_work``,
    ``k2.dgrad_tile_work``, ``k4.tile_work``)."""
    b, k, n = table.shape
    valid = table >= 0
    if order is not None:
        valid = torch.gather(valid, 2, order.long()[:, None, :].expand(b, k, n))
    valid = torch.nn.functional.pad(valid, (0, (-n) % tile_rows))
    busy = valid.reshape(b, k, -1, tile_rows).any(-1)
    return int(busy.sum()) * tile_rows, int(table.ge(0).sum())


def bwd_fused_dw_atomics(
    table: torch.Tensor, c_in: int, c_out: int, chunk_rows: int = DW_ROWS
) -> int:
    """Floats that K4's or K3's dw blocks add into dw with atomics on
    ``table``, a host model of the kernels' counts (``tracing``
    ``k4.dw_floats``, ``k3.dw_floats``): every (scene, offset, chunk
    of ``chunk_rows`` rows) with a pair flushes its C_in x C_out share of
    dw[k] once. K4's chunks are DW_ROWS rows (fp32: F_DW_ROWS); K3's are
    in ``implicit_gemm_wgrad.plan`` after a launch."""
    b, k, n = table.shape
    valid = torch.nn.functional.pad(table >= 0, (0, (-n) % chunk_rows))
    return int(valid.reshape(b, k, -1, chunk_rows).any(-1).sum()) * c_in * c_out


def _cuda_args(name, accum_dtype, tensors, table):
    """Validate what every kernel of this module needs: CUDA, fp32
    accumulation, one float dtype, an int32 table, 3-D contiguous inputs on
    one device."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if accum_dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel accumulates in float32 only")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(
            f"{name}: inputs must share float32 or bfloat16, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if table.dtype != torch.int32:
        raise ValueError(f"{name}: table must be int32, got {table.dtype}")
    for t in (*tensors, table):
        if t.ndim != 3:
            raise ValueError(f"{name}: inputs must be 3-D")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return _build.load_library(), torch.cuda.current_stream(x.device).cuda_stream


def _order_ptr(name, order, table) -> Optional[int]:
    """The order's pointer (None for the index order) after checking that it
    is an int32 [B, N_out] tensor on the table's device."""
    if order is None:
        return None
    b, _, n = table.shape
    if order.dtype != torch.int32 or tuple(order.shape) != (b, n):
        raise ValueError(
            f"{name}: order must be int32 [{b}, {n}], got {order.dtype} {tuple(order.shape)}"
        )
    if order.device != table.device or not order.is_contiguous():
        raise ValueError(f"{name}: order must be contiguous on the table's device")
    return order.data_ptr()


def _weight_image(lib, x, k_vol, c_in, c_out, n_out) -> Optional[torch.Tensor]:
    """Scratch for the bf16 kernels' weight image (``csrc/igemm.cuh``
    ``pack_weights``: each step's weight slice laid out as the kernel's
    shared-memory stage reads it, one bulk copy a step); None for fp32."""
    if x.dtype != torch.bfloat16:
        return None
    nbytes = lib.wct_igemm_image_bytes(k_vol, c_in, c_out, n_out, x.shape[0])
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def _launch_fwd(name, x, weight, table, accum_dtype, order, w_trans=False) -> torch.Tensor:
    """K2 on (x, w, table), w [K, C_in, C_out]; with ``w_trans`` the weight
    is [K, C_out, C_in] and the product takes its transpose (dgrad)."""
    lib, stream = _cuda_args(name, accum_dtype, (x, weight), table)
    b, n_in, c_in = x.shape
    k_vol = weight.shape[0]
    c_in_w, c_out = (weight.shape[2], weight.shape[1]) if w_trans else weight.shape[1:]
    if c_in_w != c_in or table.shape[0] != b or table.shape[1] != k_vol:
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
            f"table {tuple(table.shape)} disagree"
        )
    n_out = table.shape[2]
    order_ptr = _order_ptr(name, order, table)
    out = torch.empty((b, n_out, c_out), dtype=x.dtype, device=x.device)
    img = _weight_image(lib, x, k_vol, c_in, c_out, n_out)
    rc = lib.wct_igemm_fwd(
        x.data_ptr(), weight.data_ptr(), table.data_ptr(), order_ptr, out.data_ptr(),
        None if img is None else img.data_ptr(), b, n_in, n_out, k_vol, c_in, c_out,
        int(w_trans), _DTYPE_CODES[x.dtype],
        tracing.counter_ptr(x.device, "k2.dgrad_tile_work" if w_trans else "k2.fwd_tile_work"),
        stream,
    )
    _build.check(lib, rc, name)
    return out


def implicit_gemm_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    table: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
    order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2 on CUDA tensors, its tiles in ``order`` (the table's output rows),
    :func:`implicit_gemm_fwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return implicit_gemm_fwd_plain(x, weight, table, accum_dtype)
    out = _launch_fwd("implicit_gemm_fwd", x, weight, table, accum_dtype, order)
    tracing.add("launches.implicit_gemm_fwd")
    tracing.device_add("k2.fwd_pairs", lambda: torch.count_nonzero(table >= 0))
    return out


def implicit_gemm_dgrad(
    g: torch.Tensor,
    weight: torch.Tensor,
    rev: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
    order: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2 on ``(g, w^T, rev)`` on CUDA tensors, its tiles in ``order`` (rev's
    output rows, the conv's input rows; counted as
    ``launches.implicit_gemm_dgrad``, not as the forward's launches),
    :func:`implicit_gemm_dgrad_plain` on CPU tensors."""
    if g.device.type == "cpu":
        return implicit_gemm_dgrad_plain(g, weight, rev, accum_dtype)
    dx = _launch_fwd("implicit_gemm_dgrad", g, weight, rev, accum_dtype, order, w_trans=True)
    tracing.add("launches.implicit_gemm_dgrad")
    return dx


def implicit_gemm_wgrad(
    x: torch.Tensor,
    g: torch.Tensor,
    table: torch.Tensor,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K3 on CUDA tensors, :func:`implicit_gemm_wgrad_plain` on CPU tensors.
    Each launch leaves its plan in ``.plan``: its dw blocks and the rows of
    their chunks."""
    if x.device.type == "cpu":
        return implicit_gemm_wgrad_plain(x, g, table, accum_dtype)
    name = "implicit_gemm_wgrad"
    lib, stream = _cuda_args(name, accum_dtype, (x, g), table)
    b, n_in, c_in = x.shape
    k_vol, n_out = table.shape[1], table.shape[2]
    if g.shape[:2] != (b, n_out) or table.shape[0] != b:
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
            f"table {tuple(table.shape)} disagree"
        )
    c_out = g.shape[2]
    dw = torch.zeros((k_vol, c_in, c_out), dtype=torch.float32, device=x.device)
    plan = (ctypes.c_int * 2)()
    rc = lib.wct_igemm_wgrad(
        x.data_ptr(), g.data_ptr(), table.data_ptr(), dw.data_ptr(),
        b, n_in, n_out, k_vol, c_in, c_out, _DTYPE_CODES[x.dtype],
        tracing.counter_ptr(x.device, "k3.dw_floats"), ctypes.addressof(plan), stream,
    )
    _build.check(lib, rc, name)
    tracing.add("launches.implicit_gemm_wgrad")
    implicit_gemm_wgrad.plan = dict(dw_blocks=plan[0], chunk_rows=plan[1])
    return dw


def implicit_gemm_bwd_fused(
    x: torch.Tensor,
    g: torch.Tensor,
    weight: torch.Tensor,
    table: torch.Tensor,
    offsets: np.ndarray,
    accum_dtype: torch.dtype = torch.float32,
    order: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors, its dx tiles in ``order`` (the table's rows),
    :func:`implicit_gemm_bwd_fused_plain` on CPU tensors. Raises unless
    ``table`` is a self-map (n_in == n_out) over symmetric ``offsets``."""
    if x.device.type == "cpu":
        return implicit_gemm_bwd_fused_plain(x, g, weight, table, offsets, accum_dtype)
    name = "implicit_gemm_bwd_fused"
    _check_self_map(name, x, table, offsets)
    lib, stream = _cuda_args(name, accum_dtype, (x, g, weight), table)
    b, n, c_in = x.shape
    k_vol, c_in_w, c_out = weight.shape
    if (g.shape != (b, n, c_out) or c_in_w != c_in or table.shape[:2] != (b, k_vol)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, weight "
            f"{tuple(weight.shape)}, table {tuple(table.shape)} disagree"
        )
    order_ptr = _order_ptr(name, order, table)
    # dx is K2 on (g, w[K-1-k]^T, table): the kernel flips the offset axis
    # and reads w transposed.
    dx = torch.empty_like(x)
    dw = torch.zeros((k_vol, c_in, c_out), dtype=torch.float32, device=x.device)
    img = _weight_image(lib, x, k_vol, c_out, c_in, n)  # dx's image: the product with w^T
    rc = lib.wct_igemm_bwd_fused(
        x.data_ptr(), g.data_ptr(), weight.data_ptr(), table.data_ptr(), order_ptr,
        dx.data_ptr(), dw.data_ptr(), None if img is None else img.data_ptr(), b, n, k_vol,
        c_in, c_out, _DTYPE_CODES[x.dtype], tracing.counter_ptr(x.device, "k4.tile_work"),
        stream,
    )
    _build.check(lib, rc, name)
    tracing.add("launches.implicit_gemm_bwd_fused")
    return dx, dw


implicit_gemm_wgrad.plan = None
