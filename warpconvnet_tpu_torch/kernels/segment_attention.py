"""Segment-masked attention kernel K9, forward. Port of the stock Pallas TPU
flash attention that ``warpconvnet_tpu/nn/functional/flash_attention.py``
``segment_attention`` (:73-155) calls with ``SegmentIds``.

``out[b, i, h] = softmax over {j : seg_kv[b, j] == seg_q[b, i]} of
scale * q[b, i, h] . k[b, j, h], applied to v[b, j, h]``; a query row with no
matching kv row gives 0. q [B, Sq, H, D] and k, v [B, Skv, H, D] share fp32
or bf16; out is [B, Sq, H, D] in that dtype. The wrapper runs the CUDA kernel
(``csrc/segment_attention.cu``) on CUDA tensors and
:func:`segment_attention_fwd_plain` on CPU tensors, counts its launches in
``.launches``, and raises on what the kernel does not take.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from warpconvnet_tpu_torch.kernels import _build
from warpconvnet_tpu_torch.nn.functional.attention import masked_sdpa

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)  # csrc/segment_attention.cu instantiates these
QUERY_TILE = 128  # query rows per block of the kernel
KV_TILE = 64  # kv rows per tile
PLAIN_CHUNK = 1024


def segment_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    scale: Optional[float] = None,
    chunk: int = PLAIN_CHUNK,
) -> torch.Tensor:
    """:func:`masked_sdpa` with the pair mask ``seg_q[:, i] == seg_kv[:, j]``,
    ``chunk`` query rows at a time, so that the fp32 scores take
    B * H * chunk * Skv floats rather than B * H * Sq * Skv."""
    outs = []
    for i in range(0, q.shape[1], chunk):
        pair = seg_q[:, i:i + chunk, None] == seg_kv[:, None, :]
        outs.append(masked_sdpa(q[:, i:i + chunk], k, v, None, None, pair, scale))
    out = torch.cat(outs, dim=1) if outs else torch.empty_like(q)
    return out.to(q.dtype)


def _row_strides(name: str, x: torch.Tensor, h: int, d: int) -> Tuple[int, int]:
    """(batch stride, row stride) in elements of a [B, S, H, D] tensor whose
    rows each hold one contiguous [H, D] block, 16-byte aligned."""
    if x.stride(3) != 1 or x.stride(2) != d:
        raise ValueError(f"{name}: each row's [H, D] block must be contiguous, "
                         f"strides {tuple(x.stride())}")
    vec = 16 // x.element_size()
    if x.data_ptr() % 16 or x.stride(0) % vec or x.stride(1) % vec:
        raise ValueError(f"{name}: rows must start 16-byte aligned, strides {tuple(x.stride())}")
    return x.stride(0), x.stride(1)


def segment_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K9 on CUDA tensors, :func:`segment_attention_fwd_plain` on CPU
    tensors. The kernel takes fp32 or bf16 q/k/v with each row's [H, D]
    block contiguous (slices of a fused QKV projection are read in place),
    D in ``HEAD_DIMS``, any Sq and Skv, and int32 segment ids."""
    if q.device.type == "cpu":
        return segment_attention_fwd_plain(q, k, v, seg_q, seg_kv, scale)
    name = "segment_attention_fwd"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, Sq, H, D], k and v [B, Skv, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}, the kernel takes {HEAD_DIMS}")
    for s, want in ((seg_q, (b, sq)), (seg_kv, (b, skv))):
        if s.dtype != torch.int32 or tuple(s.shape) != want or not s.is_contiguous():
            raise ValueError(f"{name}: segment ids must be contiguous int32 {want}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    if any(t.device != q.device for t in (k, v, seg_q, seg_kv)):
        raise ValueError(f"{name}: inputs on different devices")
    strides = [st for name_, t in (("q", q), ("k", k), ("v", v))
               for st in _row_strides(f"{name}: {name_}", t, h, d)]
    lib = _build.load_library()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    rc = lib.wct_segment_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
        out.data_ptr(), b, sq, skv, h, d, *strides,
        float(scale if scale is not None else d ** -0.5), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, name)
    segment_attention_fwd.launches += 1
    return out


def kv_tiles_visited(seg_q: torch.Tensor, seg_kv: torch.Tensor) -> Tuple[int, int]:
    """(kv tiles the kernel visits, kv tiles in all) over every (scene,
    query tile), by the kernel's rule: a kv tile is visited when one of its
    rows has a segment inside the query tile's [min, max] range. Per head;
    plain PyTorch, for reporting."""
    b, sq = seg_q.shape
    skv = seg_kv.shape[1]
    qt = QUERY_TILE
    nq, nkv = -(-sq // qt), -(-skv // KV_TILE)
    big, small = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    sqp = torch.nn.functional.pad(seg_q, (0, nq * qt - sq), value=big).reshape(b, nq, qt)
    lo = sqp.amin(dim=2)
    hi = torch.where(sqp == big, small, sqp).amax(dim=2)
    visited = 0
    for i in range(nq):
        inside = (seg_kv >= lo[:, i, None]) & (seg_kv <= hi[:, i, None])  # [B, Skv]
        inside = torch.nn.functional.pad(inside, (0, nkv * KV_TILE - skv))
        visited += int(inside.reshape(b, nkv, KV_TILE).any(dim=2).sum())
    return visited, b * nq * nkv


segment_attention_fwd.launches = 0
