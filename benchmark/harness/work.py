"""The plain work counter: what a batch asks of the model, counted by the
benchmark on the device from the coordinates and the configuration's call
table, never from the program's own counters, so that a share reads the
same work whatever implements it.

Per scene: the cells of each stride level (the first ``max(n_cap >> l,
floor)`` in lexicographic order), the k^3 pairs of each (level, k) in
one store: k 3 at every level, and each other (level, k) that a ``sub``
call names; the stride-2 parity pairs between levels (finer cells whose cell is kept),
the 4^3 tokens (the first ``token_capacity``), the voxels whose token is
kept, and the rows a capacity drops (finer rows whose cell lies past its
level's capacity, tokens' voxels likewise): a cell's set-up refuses a pool
on which a capacity drops any, so that every cell times the model's whole
work. Where a ``window_attn`` call names it, each (level, window,
shift) also holds its window sum, the useful pairs of attention within
3D windows, and the same sum of the scene flipped in x, in y and in both
as the feed flips it: set-up refuses a pool on which a flip changes one
(``flip_dependent``). A configuration without ``window_attn`` computes
none of it.

The call table (``calls`` in a configuration) lists each conv and
attention call of one forward:

- ``{"op": "sub", "kernel": k, "level": l, "c_in", "c_out"}``: a k^3
  submanifold conv, k odd, 3 where ``kernel`` is left out; ``sub3``, the
  name the MinkUNet18 and Volt-s tables use, is the same op at k 3;
- ``{"op": "down2", "level": l, ...}``: the 2^3 stride-2 conv from level l
  to l + 1; ``{"op": "up2", "level": l, ...}``: the transposed conv from
  l + 1 onto level l;
- ``{"op": "dense", "rows": "voxels" | "tokens", "level": l, ...}``: a 1x1
  conv or a dense layer over the level's cells or the tokens;
- ``{"op": "attn", "heads", "head_dim"}``: global attention over each
  scene's tokens;
- ``{"op": "patch_attn", "level": l, "patch": P, "heads", "head_dim"}``:
  attention within consecutive P-row patches of the level's cells in
  serialized order (the last patch holds the rest);
- ``{"op": "window_attn", "level": l, "window": w, "shift": s, "heads",
  "head_dim"}``: attention among the level's cells that share a w^3
  window, s 0 or w / 2, grouped as the JAX package's ``window_partition``
  groups them: per axis ``local = cell - min + s`` over the scene's cells
  at the level, the window ``local // w``. Its useful pairs are the sum
  over windows of their occupancy squared.

each with an optional ``count``. ``patch_attn`` carries its patch on the
call because ``patch_size`` at the top of a configuration means Volt's
4^3 tokens: a configuration that sets it has tokens counted, and the rows
they drop refused, which a serialized-patch model has none of.

Operations are multiply-adds times two. Attention counts its useful pairs
only: no pad rows, no recompute, the backward twice the forward. Bytes
count each input read once and each output written once, over the rows
that hold a pair only (``wgrad_nbytes`` of ``chip_smoke.py``, for every
table conv): features in the conv dtype, tables int32, weight gradients
fp32; ``patch_attn``'s and ``window_attn``'s q, k, v, o and their
gradients in the trunk dtype (the conv dtype where the configuration has
none), their log-sum-exp and delta rows fp32, over the level's cells.
Dense calls and global ``attn`` carry no byte count. Both attention ops
count their bytes by this one model (``_local_attn``); ``window_attn``'s
are unchecked against a trace until the configuration that first uses
the op holds them against its kernel's.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from benchmark.models import sparse


def _pair_kernels(cfg: dict, levels: int) -> List[Tuple[int, int]]:
    """(level, k) whose k^3 pairs a scene's counts hold: k 3 at every
    level, then each other (level, k) of a ``sub`` call, in first use order."""
    out = [(level, 3) for level in range(levels)]
    for call in cfg.get("calls", []):
        if call["op"] != "sub":
            continue
        key = (call["level"], call.get("kernel", 3))
        if key[1] % 2 == 0:
            raise ValueError(f"a submanifold conv needs an odd kernel, not {key[1]}")
        if key not in out:
            out.append(key)
    return out


def _windows(cfg: dict) -> List[Tuple[int, int, int]]:
    """(level, window, shift) of every ``window_attn`` call, in first use
    order."""
    out = []
    for call in cfg.get("calls", []):
        if call["op"] != "window_attn":
            continue
        key = (call["level"], call["window"], call["shift"])
        if key[1] < 1 or key[2] not in (0, key[1] // 2):
            raise ValueError(f"a window of {key[1]} shifts by 0 or {key[1] // 2}, not {key[2]}")
        if key not in out:
            out.append(key)
    return out


# The feed's flips of x and y. It maps x to R - 1 - x (R a power of two),
# a level-l cell x to R / 2**l - 1 - x; anchored at the minimum, that is
# the cell's window as if x were negated.
_FLIPS = ((1, 1, 1), (-1, 1, 1), (1, -1, 1), (-1, -1, 1))


def _window_sums(coords: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """[4] sums over the ``window``^3 windows of one level's cells (anchored
    at their minimum, moved by ``shift``) of the cells a window holds,
    squared: the cells as they are, flipped in x, in y and in both."""
    out = torch.zeros(len(_FLIPS), dtype=torch.int64, device=coords.device)
    if coords.shape[0] == 0:
        return out
    for i, sign in enumerate(_FLIPS):
        c = coords * torch.tensor(sign, dtype=coords.dtype, device=coords.device)
        local = c - c.min(dim=0).values + shift
        occ = torch.unique(sparse.coord_keys(local // window), return_counts=True)[1]
        out[i] = (occ * occ).sum()
    return out


def _pairs(keys: torch.Tensor, coords: torch.Tensor, size: int) -> torch.Tensor:
    """Pairs of the ``size``^3 submanifold map of one level (keys sorted)."""
    n = keys.numel()
    total = torch.zeros((), dtype=torch.int64, device=coords.device)
    for off in sparse.offsets_3d(size, coords.device):
        q = sparse.coord_keys(coords + off)
        pos = torch.searchsorted(keys, q).clamp(max=max(n - 1, 0))
        total += (keys[pos] == q).sum()
    return total


def scene_counts(coords: torch.Tensor, cfg: dict, n_cap: int) -> dict:
    """Counts of one lexicographic scene (coords [n, 3] on the device)."""
    levels = cfg.get("levels", 1)
    caps = sparse.level_caps(n_cap, levels, cfg.get("level_cap_floor", 1))
    lv = sparse.scene_levels(coords, caps)
    dev = coords.device
    dropped = torch.zeros((), dtype=torch.int64, device=dev) + max(coords.shape[0] - caps[0], 0)
    kernels = _pair_kernels(cfg, levels)
    pairs = torch.zeros(len(kernels), dtype=torch.int64, device=dev)
    down = torch.zeros(max(levels - 1, 0), dtype=torch.int64, device=dev)
    windows = _windows(cfg)
    sums = torch.zeros((len(windows), len(_FLIPS)), dtype=torch.int64, device=dev)
    for i, level in enumerate(lv):
        keys = sparse.coord_keys(level.coords)
        for j, (at, size) in enumerate(kernels):
            if at == i:
                pairs[j] = _pairs(keys, level.coords, size)
        for j, (at, w, s) in enumerate(windows):
            if at == i:
                sums[j] = _window_sums(level.coords, w, s)
        if i > 0:
            down[i - 1] = (level.parent >= 0).sum()
            dropped += (level.parent < 0).sum()
    tokens = torch.zeros(2, dtype=torch.int64, device=dev)
    if "patch_size" in cfg:
        tok = sparse.coarsen(lv[0].coords, cfg["patch_size"], cfg["token_capacity"])
        tokens[0] = tok.coords.shape[0]
        tokens[1] = (tok.parent >= 0).sum()
        dropped += (tok.parent < 0).sum()
    cells = [level.coords.shape[0] for level in lv]
    host = torch.cat([pairs, down, tokens, dropped[None], sums.reshape(-1)]).tolist()
    n = len(host) - sums.numel()
    per = [host[n + j * len(_FLIPS):n + (j + 1) * len(_FLIPS)] for j in range(len(windows))]
    return {"cells": cells, "pairs": dict(zip(kernels, host)),
            "down": host[len(kernels):len(kernels) + levels - 1],
            "tokens": host[n - 3], "token_voxels": host[n - 2], "dropped": host[n - 1],
            "windows": {key: p[0] for key, p in zip(windows, per)},
            "window_flips": {key: p[1:] for key, p in zip(windows, per)}}


def pool_counts(pool, cfg: dict, n_cap: int) -> List[List[dict]]:
    """[entry][scene] counts of every pool batch."""
    from benchmark.models.sparse import lex_order

    out = []
    for e, sizes in enumerate(pool.sizes):
        entry = []
        for s, n in enumerate(sizes):
            c = pool.coords[e, s, :n].to(torch.int64)
            entry.append(scene_counts(c[lex_order(c)], cfg, n_cap))
        out.append(entry)
    return out


def flip_dependent(counts: List[List[dict]]) -> List[str]:
    """Each scene and (level, window, shift) of a pool whose window sum a
    flip of the feed changes: the pool's counts would not hold for every
    item."""
    out = []
    for e, entry in enumerate(counts):
        for s, sc in enumerate(entry):
            for (level, w, sh), flipped in sc["window_flips"].items():
                if any(p != sc["windows"][(level, w, sh)] for p in flipped):
                    out.append(f"entry {e} scene {s} level {level} (window {w}, shift {sh}): "
                               f"{sc['windows'][(level, w, sh)]} pairs, flipped x, y, both "
                               f"{flipped}")
    return out


_ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def _rows(call: dict, sc: dict) -> int:
    if call.get("rows") == "tokens":
        return sc["tokens"]
    return sc["cells"][call.get("level", 0)]


def _table_conv(n: int, p: int, taps: int, ci: int, co: int, e: int,
                train: bool) -> List[tuple]:
    """A submanifold conv of ``taps`` offsets over n rows with p pairs; its
    backward is the fused dx and dw kernel."""
    w = 4  # fp32 weight gradients
    f = 2.0 * p * ci * co
    wb = taps * ci * co * e
    out = [("fwd", f, n * ci * e + wb + taps * n * 4 + n * co * e)]
    if train:
        out.append(("fused", 2 * f, 2 * n * ci * e + n * co * e + wb + taps * n * 4
                    + taps * ci * co * w))
    return out


def _local_attn(n: int, pairs: int, heads: int, dim: int, e: int, train: bool) -> List[tuple]:
    """Attention of n rows among groups of them with ``pairs`` useful
    query-key pairs in all: q, k, v and o once, an fp32 log-sum-exp a row
    and head; the backward reads q, k, v, o and dO, writes dq, dk and dv,
    and reads the log-sum-exp and delta rows."""
    f = 4.0 * dim * heads * pairs
    act, row = n * heads * dim * e, n * heads * 4
    out = [("attn", f, 4 * act + row)]
    if train:
        out.append(("attn_bwd", 2 * f, 8 * act + 2 * row))
    return out


OPS = ("sub", "sub3", "down2", "up2", "dense", "attn", "patch_attn", "window_attn")


def call_work(call: dict, sc: dict, cfg: dict, train: bool) -> List[tuple]:
    """[(kind, flops, bytes)] of the kernels one call of ``call`` runs on
    one scene: the forward, and with ``train`` its backward (``fused``: dx
    and dw of a k^3 self-map in one kernel; ``dgrad`` and ``wgrad`` for
    the stride-2 convs; ``attn_bwd``). Dense calls and global attention
    have no byte count. An op outside ``OPS`` is refused before any
    lookup."""
    op = call["op"]
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}: the call table knows {', '.join(OPS)}")
    ci, co = call.get("c_in", 0), call.get("c_out", 0)
    e = _ELT[cfg["conv_dtype"]]
    w = 4  # fp32 weight gradients
    if op == "attn":
        s = sc["tokens"]
        f = 4.0 * s * s * call["head_dim"] * call["heads"]
        return [("attn", f, 0.0)] + ([("attn_bwd", 2 * f, 0.0)] if train else [])
    if op in ("patch_attn", "window_attn"):
        n = sc["cells"][call["level"]]
        if op == "patch_attn":
            q, r = divmod(n, call["patch"])  # q full patches, r rows in the last
            pairs = q * call["patch"] * call["patch"] + r * r
        else:
            pairs = sc["windows"][(call["level"], call["window"], call["shift"])]
        return _local_attn(n, pairs, call["heads"], call["head_dim"],
                           _ELT[cfg.get("trunk_dtype", cfg["conv_dtype"])], train)
    if op == "dense":
        f = 2.0 * _rows(call, sc) * ci * co
        return [("dense", f, 0.0)] + ([("dense_bwd", 2 * f, 0.0)] if train else [])
    if op in ("sub", "sub3"):
        lv, k = call["level"], call.get("kernel", 3)
        return _table_conv(sc["cells"][lv], sc["pairs"][(lv, k)], k ** 3, ci, co, e, train)
    lv = call["level"]
    fine, coarse = sc["down"][lv], sc["cells"][lv + 1]
    f = 2.0 * fine * ci * co
    wb = 8 * ci * co * e
    n_in, n_out = (fine, coarse) if op == "down2" else (coarse, fine)
    # The table has 8 slots a row of its output side; its reverse, of its input side.
    out = [("fwd", f, n_in * ci * e + wb + 8 * n_out * 4 + n_out * co * e)]
    if train:
        out.append(("dgrad", f, n_out * co * e + wb + 8 * n_in * 4 + n_in * ci * e))
        out.append(("wgrad", f, 8 * n_out * 4 + 8 * ci * co * w + n_in * ci * e + n_out * co * e))
    return out


def batch_work(entry_counts: List[dict], cfg: dict, train: bool) -> List[tuple]:
    """(kind, op, flops, bytes) of every kernel call a step or request runs
    on one pool batch."""
    out = []
    for sc in entry_counts:
        for call in cfg["calls"]:
            for _ in range(call.get("count", 1)):
                for kind, f, b in call_work(call, sc, cfg, train):
                    out.append((kind, call["op"], f, b))
    return out


def model_flops(entry_counts: List[dict], cfg: dict, train: bool) -> float:
    return sum(f for _, _, f, _ in batch_work(entry_counts, cfg, train))


def voxels(entry_counts: List[dict]) -> int:
    return sum(sc["cells"][0] for sc in entry_counts)
