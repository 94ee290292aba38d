"""Segment-masked attention kernels: K9 (forward) and its backward K9-dkv
and K9-dq. Ports of the stock Pallas TPU flash attention that
``warpconvnet_tpu/nn/functional/flash_attention.py`` ``segment_attention``
(:73-155) calls with ``SegmentIds``: its forward, and its backward passes
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``.

``out[b, i, h] = softmax over {j : seg_kv[b, j] == seg_q[b, i]} of
scale * q[b, i, h] . k[b, j, h], applied to v[b, j, h]``; a query row with no
matching kv row gives 0. q [B, Sq, H, D] and k, v [B, Skv, H, D] share fp32
or bf16; out is [B, Sq, H, D] in that dtype. The forward can also return the
rows' log-sum-exp ``lse`` [B, H, Sq] (fp32, natural log, +inf on a row that
matches nothing), which the backward reads. Each wrapper runs its CUDA
kernel on CUDA tensors, all on the tensor cores, fp32 in 3xTF32
(``csrc/segment_attention_fwd_tf32.cu``, ``csrc/segment_attention_bwd_tf32.cu``),
bf16 in ``csrc/segment_attention_fwd_bf16.cu`` and
``csrc/segment_attention_bwd_bf16.cu`` (the forward's entry point is
``csrc/segment_attention.cu``), and its ``*_plain`` version on CPU tensors,
counts its launches (``tracing`` host counter ``launches.<wrapper>``), and
raises on what the kernel does not take. The kernels read q, k, v and dO through their row strides (no copy).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)  # csrc/segment_attention.cu instantiates these
QUERY_TILE = 128  # query rows per block of the fp32 forward at D <= 64
KV_TILE = 64  # kv rows per tile
PLAIN_CHUNK = 1024


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for fp32 and bf16 inputs, float64 for float64 ones."""
    return torch.promote_types(x.dtype, torch.float32)


def segment_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    scale: Optional[float] = None,
    chunk: int = PLAIN_CHUNK,
    return_lse: bool = False,
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
):
    """``nn.functional.attention.masked_sdpa`` with the pair mask
    ``seg_q[:, i] == seg_kv[:, j]``, ``chunk`` query rows at a time, so that
    the fp32 scores take B * H * chunk * Skv floats rather than
    B * H * Sq * Skv (the same values as one call). ``matmul``
    forms its two products, S = Q K^T and P V (:func:`tf32_matmul`
    emulates the fp32 kernel's arithmetic). With ``return_lse`` also the
    rows' log-sum-exp [B, H, Sq] (+inf where a row matches nothing), in the
    compute dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    acc = _compute_dtype(q)
    kf, vf = (t.transpose(1, 2).to(acc) for t in (k, v))  # [B, H, Skv, D]
    outs, lses = [], []
    for i in range(0, q.shape[1], chunk):
        pair = (seg_q[:, i:i + chunk, None] == seg_kv[:, None, :])[:, None]  # [B, 1, c, Skv]
        s = matmul(q[:, i:i + chunk].transpose(1, 2).to(acc), kf.transpose(-1, -2)) * scale
        probs = torch.softmax(torch.where(pair, s, -1e30), dim=-1)
        probs = torch.where(pair.any(dim=-1, keepdim=True), probs, 0)
        outs.append(matmul(probs.to(v.dtype).to(acc), vf).to(v.dtype).transpose(1, 2))
        if return_lse:
            lse = torch.logsumexp(s.masked_fill(~pair, -math.inf), dim=-1)
            lses.append(torch.where(torch.isneginf(lse), math.inf, lse))
    out = torch.cat(outs, dim=1) if outs else torch.empty_like(q)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    b, sq, h, _ = q.shape
    lse = torch.cat(lses, dim=2) if lses else q.new_empty((b, h, sq), dtype=_compute_dtype(q))
    return out, lse


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


def _check_qkv(name, q, k, v, seg_q, seg_kv) -> Tuple[int, int, int, int, int]:
    """(B, Sq, Skv, H, D) of CUDA tensors the kernels take; raises on the rest."""
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
    return b, sq, skv, h, d


def segment_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """K9 on CUDA tensors, :func:`segment_attention_fwd_plain` on CPU
    tensors. The kernel takes fp32 or bf16 q/k/v with each row's [H, D]
    block contiguous (slices of a fused QKV projection are read in place),
    D in ``HEAD_DIMS``, any Sq and Skv, and int32 segment ids. Returns out,
    or (out, lse) with ``return_lse``."""
    if q.device.type == "cpu":
        return segment_attention_fwd_plain(q, k, v, seg_q, seg_kv, scale, return_lse=return_lse)
    name = "segment_attention_fwd"
    b, sq, skv, h, d = _check_qkv(name, q, k, v, seg_q, seg_kv)
    strides = [st for name_, t in (("q", q), ("k", k), ("v", v))
               for st in _row_strides(f"{name}: {name_}", t, h, d)]
    lib = _build.load_library()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    rc = lib.wct_segment_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, sq, skv, h, d, *strides,
        float(scale if scale is not None else d ** -0.5), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, name)
    tracing.add("launches.segment_attention_fwd")
    return (out, lse) if return_lse else out


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``x`` as the fp32 backward kernels split their
    operands: hi is x rounded to TF32 (10 mantissa bits; to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds), lo is x - hi rounded
    the same way, so |x - hi - lo| <= 2^-22 |x| for normal x. A non-finite
    hi is kept as it is, with lo 0. For tests: the kernels split on the
    card."""
    def rna(v):
        r = ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(v), r, v)

    hi = rna(x)
    finite = torch.isfinite(hi)
    lo = torch.where(finite, rna(torch.where(finite, x - hi, 0)), 0)
    return hi, lo


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b of fp32 tensors as the fp32 backward kernels form it on the
    tensor cores: from :func:`tf32_split`'s parts, a_lo b_hi + a_hi b_lo +
    a_hi b_hi (``terms=3``, 3xTF32), or a_hi b_hi alone (``terms=1``, one
    TF32 product). A product of two TF32 values is exact in fp32; the sums
    are fp32 (on a card, only with TF32 matmuls off). For tests."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if terms == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _bwd_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale, chunk, matmul=torch.matmul):
    """(dq, dk, dv) by the explicit formulas, ``chunk`` query rows at a
    time: P = exp(S - lse) over equal segments, dV = P^T dO, dP = dO V^T,
    dS = scale P (dP - di), dQ = dS K, dK = dS^T Q. As in the stock TPU
    kernels, P and dS (with the scale folded in) are rounded to the
    inputs' dtype before the products that read them (a no-op for fp32 and
    float64); dP and the sums stay in the compute dtype. ``matmul`` forms
    the six products (S and the five of the backward). lse and di are
    [B, H, Sq]; the gradients come back contiguous in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    acc = _compute_dtype(q)
    qf, kf, vf, dof = (t.transpose(1, 2).to(acc) for t in (q, k, v, do))  # [B, H, S, D]
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(0, q.shape[1], chunk):
        rows = slice(i, i + chunk)
        pair = (seg_q[:, rows, None] == seg_kv[:, None, :])[:, None]  # [B, 1, c, Skv]
        s = matmul(qf[:, :, rows], kf.transpose(-1, -2)) * scale
        p = torch.where(pair, torch.exp(s - lse[:, :, rows, None].to(acc)), 0)
        dv += matmul(p.to(q.dtype).to(acc).transpose(-1, -2), dof[:, :, rows])
        dp = matmul(dof[:, :, rows], vf.transpose(-1, -2))
        ds = (p * (dp - di[:, :, rows, None].to(acc)) * scale).to(q.dtype).to(acc)
        dq[:, :, rows] = matmul(ds, kf)
        dk += matmul(ds.transpose(-1, -2), qf[:, :, rows])
    return tuple(t.transpose(1, 2).to(q.dtype).contiguous() for t in (dq, dk, dv))


def rowsum_o_do(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(o * do) as [B, H, Sq] in the compute dtype (the stock
    backward computes it outside its kernels too)."""
    acc = _compute_dtype(o)
    return (o.to(acc) * do.to(acc)).sum(-1).transpose(1, 2).contiguous()


def segment_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    scale: Optional[float] = None,
    chunk: int = PLAIN_CHUNK,
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the segment attention whose forward gave ``o`` and
    ``lse``, for the output gradient ``do``: the explicit formulas
    (:func:`_bwd_plain`, products by ``matmul``; :func:`tf32_matmul`
    emulates the fp32 kernels' arithmetic) with di = rowsum(o * do), in one
    pass."""
    return _bwd_plain(q, k, v, do, lse, rowsum_o_do(o, do), seg_q, seg_kv, scale, chunk, matmul)


def segment_attention_bwd_dkv_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale=None,
                                    chunk=PLAIN_CHUNK):
    """(dk, dv): K9-dkv's function by the explicit formulas."""
    return _bwd_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale, chunk)[1:]


def segment_attention_bwd_dq_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale=None,
                                   chunk=PLAIN_CHUNK):
    """dq: K9-dq's function by the explicit formulas."""
    return _bwd_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale, chunk)[0]


def _bwd_launch(name, q, k, v, do, lse, di, seg_q, seg_kv, scale, shapes):
    """Checks the inputs of K9-dkv or K9-dq, allocates its outputs
    (contiguous, ``shapes``, in q's dtype) and launches it into them."""
    b, sq, skv, h, d = _check_qkv(name, q, k, v, seg_q, seg_kv)
    if do.dtype != q.dtype or tuple(do.shape) != (b, sq, h, d) or do.device != q.device:
        raise ValueError(f"{name}: do must be {q.dtype} {(b, sq, h, d)} like q, got "
                         f"{do.dtype} {tuple(do.shape)}")
    for t_name, t in (("lse", lse), ("di", di)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name}: {t_name} must be contiguous float32 {(b, h, sq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    strides = [st for t_name, t in (("q", q), ("k", k), ("v", v), ("do", do))
               for st in _row_strides(f"{name}: {t_name}", t, h, d)]
    outs = [torch.empty(shape, dtype=q.dtype, device=q.device) for shape in shapes]
    lib = _build.load_library()
    rc = getattr(lib, f"wct_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        seg_q.data_ptr(), seg_kv.data_ptr(), *(t.data_ptr() for t in outs), b, sq, skv, h, d,
        (ctypes.c_int64 * 8)(*strides), float(scale if scale is not None else d ** -0.5),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, name)
    return outs


def segment_attention_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, scale=None):
    """K9-dkv on CUDA tensors, :func:`segment_attention_bwd_dkv_plain` on
    CPU tensors: (dk, dv) [B, Skv, H, D], contiguous, in q's dtype. Takes
    what K9 takes, plus dO [B, Sq, H, D] in q's dtype (read through its row
    strides) and contiguous fp32 lse and di [B, H, Sq]."""
    if q.device.type == "cpu":
        return segment_attention_bwd_dkv_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale)
    dk, dv = _bwd_launch("segment_attention_bwd_dkv", q, k, v, do, lse, di, seg_q, seg_kv,
                         scale, (k.shape, k.shape))
    tracing.add("launches.segment_attention_bwd_dkv")
    return dk, dv


def segment_attention_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, scale=None):
    """K9-dq on CUDA tensors, :func:`segment_attention_bwd_dq_plain` on CPU
    tensors: dq [B, Sq, H, D], contiguous, in q's dtype; takes what K9-dkv
    takes."""
    if q.device.type == "cpu":
        return segment_attention_bwd_dq_plain(q, k, v, do, lse, di, seg_q, seg_kv, scale)
    (dq,) = _bwd_launch("segment_attention_bwd_dq", q, k, v, do, lse, di, seg_q, seg_kv, scale,
                        (q.shape,))
    tracing.add("launches.segment_attention_bwd_dq")
    return dq


def segment_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): on CUDA tensors di = rowsum(o * do) (one torch
    reduction), then K9-dkv and K9-dq; on CPU tensors
    :func:`segment_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return segment_attention_bwd_plain(q, k, v, o, lse, do, seg_q, seg_kv, scale)
    di = rowsum_o_do(o, do)
    dk, dv = segment_attention_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, scale)
    return segment_attention_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, scale), dk, dv


def query_tile(dtype: torch.dtype, d: int) -> int:
    """Query rows per block of the forward kernel: fp32 two warpgroups of
    64 rows (one at D 128), bf16 three (two at D 128)."""
    if dtype == torch.bfloat16:
        return 3 * 64 if d <= 64 else 2 * 64
    return QUERY_TILE if d <= 64 else 64


def kv_tiles_visited(seg_q: torch.Tensor, seg_kv: torch.Tensor,
                     qt: int = QUERY_TILE) -> Tuple[int, int]:
    """(kv tiles the kernel visits, kv tiles in all) over every (scene,
    query tile of ``qt`` rows), by the kernel's rule: a kv tile is visited
    when one of its rows has a segment inside the query tile's [min, max]
    range. Per head; plain PyTorch, for reporting."""
    b, sq = seg_q.shape
    skv = seg_kv.shape[1]
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
