"""Segment-masked attention (counterpart of
``warpconvnet_tpu/nn/functional/flash_attention.py``): query row i attends
kv row j iff ``seg_q[i] == seg_kv[j]``. One primitive serves global
attention over a ragged batch (segment = scene validity), window and patch
attention (segment = group) and cross attention (separate ids).

Routing has one rule: on CUDA tensors the hand-written kernel K9 runs
(``kernels/segment_attention.py``), unless the caller asks for
``impl="xla"``, the score-matrix path :func:`masked_sdpa` (differentiated by
autograd); on CPU tensors the plain version runs. When a gradient is to be
recorded, the call goes through :class:`SegmentAttention`, whose backward is
K9-dkv and K9-dq on CUDA tensors and the plain backward on CPU tensors (the
counterpart of the stock kernel's ``custom_vjp``). K9 takes any sequence
length, so the TPU path's padding glue (head dim to 128 lanes, sequences to
the block, an extra sentinel kv row) has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.nn.functional.attention import masked_sdpa

_PAD_SEGMENT = 2_000_000_000


def segment_ids_from_valid(row_valid: torch.Tensor) -> torch.Tensor:
    """[..., S] bool -> int32 segment ids: 0 on each scene's valid rows, the
    shared pad sentinel elsewhere."""
    return torch.where(row_valid, 0, _PAD_SEGMENT).to(torch.int32)


def segment_ids_from_groups(
    group: torch.Tensor, row_valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[..., S] int group labels (window rank, patch index) -> int32
    segment ids, pads sentineled."""
    seg = group.to(torch.int32)
    if row_valid is not None:
        seg = torch.where(row_valid, seg, _PAD_SEGMENT).to(torch.int32)
    return seg


class SegmentAttention(torch.autograd.Function):
    """Segment attention differentiable in q, k and v. The forward runs K9
    with the rows' log-sum-exp and saves q, k, v, the output and lse; the
    backward runs K9-dkv and K9-dq (their plain versions on CPU tensors).
    dq, dk and dv come back contiguous in q's dtype; autograd carries them
    into the tensors q, k and v were sliced from."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, scale):
        out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_kv)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg_q, seg_kv = ctx.saved_tensors
        dq, dk, dv = k9.segment_attention_bwd(q, k, v, out, lse, do.contiguous(), seg_q, seg_kv,
                                              ctx.scale)
        return dq, dk, dv, None, None, None


def segment_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,
    seg_kv: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Skv, H, D]; seg_q [B, Sq] and seg_kv
    [B, Skv] int (seg_kv defaults to seg_q); scale defaults to D**-0.5.
    ``impl``: None (K9 on CUDA tensors, the plain version on CPU tensors;
    through :class:`SegmentAttention` when a gradient is to be recorded, the
    bare forward otherwise) or ``"xla"`` (:func:`masked_sdpa` over the full
    pair mask). Returns [B, Sq, H, D] in q's dtype."""
    if seg_kv is None:
        seg_kv = seg_q
    if impl == "xla":
        pair = seg_q[:, :, None] == seg_kv[:, None, :]
        return masked_sdpa(q, k, v, None, None, pair, scale=scale).to(q.dtype)
    if impl is not None:
        raise ValueError(f"impl must be None or 'xla', got {impl!r}")
    seg_q = seg_q.to(torch.int32).contiguous()
    seg_kv = seg_kv.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SegmentAttention.apply(q, k, v, seg_q, seg_kv, scale)
    return k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, scale)
