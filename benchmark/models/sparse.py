"""Plain PyTorch sparse-voxel operations shared by the benchmark's
references (``minkunet.py``, ``volt.py``) and its work counter
(``benchmark/harness/work.py``).

Everything here is written from the published semantics of a voxel network
(integer coordinates, a kernel map per level, stride-2 parity maps between
levels) and imports nothing of the measured program. A scene is its valid
voxels only, in lexicographic (x, y, z) order; a batch is its scenes' rows
stacked, with the row offset of each scene.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

_BIAS = 1 << 20  # coordinates live in (-2**20, 2**20)


def coord_keys(coords: torch.Tensor) -> torch.Tensor:
    """[n, 3] int -> [n] int64 whose order is the lexicographic order."""
    c = coords.to(torch.int64) + _BIAS
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def lex_order(coords: torch.Tensor) -> torch.Tensor:
    """Permutation that puts unique coordinates in lexicographic order."""
    return torch.argsort(coord_keys(coords))


def offsets_3d(size: int, device) -> torch.Tensor:
    """[size**3, 3] offsets, x-major and z-fastest; odd sizes centred,
    even ones anchored at 0."""
    r = torch.arange(size, device=device) - ((size - 1) // 2 if size % 2 else 0)
    g = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([a.reshape(-1) for a in g], dim=1).to(torch.int64)


class Level(NamedTuple):
    """One scene's voxels at one stride level."""

    coords: torch.Tensor  # [n, 3] lexicographic
    parent: Optional[torch.Tensor]  # [n_fine] row of this level per finer row, -1 if dropped
    slot: Optional[torch.Tensor]  # [n_fine] parity slot of each finer row


def coarsen(coords: torch.Tensor, factor: int, cap: int) -> Level:
    """The cells ``coords // factor`` (``factor`` a power of two): the first
    ``cap`` of them in lexicographic order, each finer row's cell (-1 where
    its cell is past ``cap``) and its slot ``r_x f^2 + r_y f + r_z`` with
    ``r = coords mod f``."""
    shift = factor.bit_length() - 1
    cells, inv = torch.unique(coords >> shift, dim=0, return_inverse=True)
    parent = torch.where(inv < cap, inv, -1)
    r = coords & (factor - 1)
    slot = (r[:, 0] * factor + r[:, 1]) * factor + r[:, 2]
    return Level(cells[:cap], parent, slot)


def neighbour_pairs(coords: torch.Tensor, size: int = 3):
    """Submanifold map of a lexicographic scene: ``(inp, out, starts)`` with
    pairs grouped by offset k in ``starts[k]:starts[k+1]``, such that
    ``coords[inp] == coords[out] + offsets_3d(size)[k]``."""
    keys = coord_keys(coords)
    n = keys.numel()
    ins, outs, starts = [], [], [0]
    for off in offsets_3d(size, coords.device):
        q = coord_keys(coords + off)
        pos = torch.searchsorted(keys, q).clamp(max=max(n - 1, 0))
        hit = keys[pos] == q
        out = torch.nonzero(hit).squeeze(1)
        ins.append(pos[out])
        outs.append(out)
        starts.append(starts[-1] + out.numel())
    return torch.cat(ins), torch.cat(outs), starts


def level_caps(n_cap: int, levels: int, floor: int) -> List[int]:
    """Row capacity of each stride level: ``n_cap`` halved per level, at
    least ``floor`` (the padded layout the measured models use)."""
    return [max(n_cap >> i, floor) for i in range(levels)]


def scene_levels(coords: torch.Tensor, caps: List[int]) -> List[Level]:
    """Levels 0..len(caps)-1 of one lexicographic scene: level 0 is the
    scene; level i+1 coarsens level i by 2 under ``caps[i+1]``."""
    out = [Level(coords[: caps[0]], None, None)]
    for cap in caps[1:]:
        out.append(coarsen(out[-1].coords, 2, cap))
    return out


# ---- the lower-precision control -------------------------------------------

_FP8_MAX = 448.0  # largest float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (amax to
    448), returned in fp32: what an fp8 GEMM would read."""
    s = t.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to fp8 in the forward, and the
    incoming gradient and the operands rounded to fp8 in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Fp8Round(torch.autograd.Function):
    """A tensor the measured program holds in bf16, held in fp8 instead:
    the value rounded in the forward, its gradient in the backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def matmul_for(precision: str):
    """The conv product of a precision: ``"reference"`` fp32, ``"control"``
    fp8 operands with fp32 accumulation."""
    if precision == "reference":
        return torch.matmul
    if precision == "control":
        return Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def rounding_for(precision: str):
    """What becomes of an activation the program holds in bf16: kept in
    fp32 by the reference, rounded to fp8 by the control."""
    if precision == "reference":
        return lambda x: x
    if precision == "control":
        return Fp8Round.apply
    raise ValueError(f"unknown precision {precision!r}")


# ---- batched geometry and convs --------------------------------------------


class Batch(NamedTuple):
    """Stacked scenes: ``rows[l]`` is the row offset of each scene at level
    l (len B + 1)."""

    levels: List[List[Level]]  # [scene][level]
    rows: List[List[int]]  # [level][scene + 1]


def make_batch(scenes: List[torch.Tensor], caps: List[int]) -> Batch:
    levels = [scene_levels(c, caps) for c in scenes]
    rows = []
    for lv in range(len(caps)):
        r = [0]
        for s in levels:
            r.append(r[-1] + s[lv].coords.shape[0])
        rows.append(r)
    return Batch(levels, rows)


class SubMap(NamedTuple):
    inp: torch.Tensor
    out: torch.Tensor
    starts: List[int]
    n: int


def submanifold_map(batch: Batch, lv: int, size: int = 3) -> SubMap:
    """The ``size``^3 map of level ``lv`` over the stacked rows."""
    per = [neighbour_pairs(s[lv].coords, size) for s in batch.levels]
    k = size ** 3
    ins, outs, starts = [], [], [0]
    for j in range(k):
        for b, (i, o, st) in enumerate(per):
            base = batch.rows[lv][b]
            ins.append(i[st[j]:st[j + 1]] + base)
            outs.append(o[st[j]:st[j + 1]] + base)
        starts.append(sum(t.numel() for t in ins))
    return SubMap(torch.cat(ins), torch.cat(outs), starts, batch.rows[lv][-1])


class ParityMap(NamedTuple):
    """Fine rows of level ``lv`` with a kept parent at ``lv + 1``, grouped by
    slot: ``fine[starts[k]:starts[k+1]]`` and ``coarse[...]``."""

    fine: torch.Tensor
    coarse: torch.Tensor
    starts: List[int]
    n_fine: int
    n_coarse: int


def parity_map(batch: Batch, lv: int) -> ParityMap:
    fines, coarses, slots = [], [], []
    for b, s in enumerate(batch.levels):
        parent, slot = s[lv + 1].parent, s[lv + 1].slot
        keep = torch.nonzero(parent >= 0).squeeze(1)
        fines.append(keep + batch.rows[lv][b])
        coarses.append(parent[keep] + batch.rows[lv + 1][b])
        slots.append(slot[keep])
    fine, coarse, slot = torch.cat(fines), torch.cat(coarses), torch.cat(slots)
    order = torch.argsort(slot, stable=True)
    counts = torch.bincount(slot, minlength=8).tolist()
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + c)
    return ParityMap(fine[order], coarse[order], starts, batch.rows[lv][-1],
                     batch.rows[lv + 1][-1])


def conv_sub(x: torch.Tensor, w: torch.Tensor, m: SubMap, mm) -> torch.Tensor:
    """out[o] = sum_k x[inp] @ w[k] over the map's pairs; w [K, C_in, C_out]."""
    out = x.new_zeros((m.n, w.shape[-1]))
    for k in range(w.shape[0]):
        a, b = m.starts[k], m.starts[k + 1]
        if b > a:
            out.index_add_(0, m.out[a:b], mm(x[m.inp[a:b]], w[k]))
    return out


def conv_down(x: torch.Tensor, w: torch.Tensor, m: ParityMap, mm) -> torch.Tensor:
    """Stride-2 conv, kernel 2: coarse[c] = sum over its fine rows f of
    x[f] @ w[slot(f)]."""
    out = x.new_zeros((m.n_coarse, w.shape[-1]))
    for k in range(w.shape[0]):
        a, b = m.starts[k], m.starts[k + 1]
        if b > a:
            out.index_add_(0, m.coarse[a:b], mm(x[m.fine[a:b]], w[k]))
    return out


def conv_up(x: torch.Tensor, w: torch.Tensor, m: ParityMap, mm) -> torch.Tensor:
    """Transposed stride-2 conv onto the fine rows: fine[f] = x[parent(f)]
    @ w[slot(f)]; fine rows whose parent was dropped get 0."""
    out = x.new_zeros((m.n_fine, w.shape[-1]))
    for k in range(w.shape[0]):
        a, b = m.starts[k], m.starts[k + 1]
        if b > a:
            out.index_add_(0, m.fine[a:b], mm(x[m.coarse[a:b]], w[k]))
    return out


def split_rows(x: torch.Tensor, rows: List[int]) -> List[torch.Tensor]:
    return [x[rows[b]:rows[b + 1]] for b in range(len(rows) - 1)]
