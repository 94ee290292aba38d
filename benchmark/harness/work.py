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
work.

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
  serialized order (the last patch holds the rest).

each with an optional ``count``. ``patch_attn`` carries its patch on the
call because ``patch_size`` at the top of a configuration means Volt's
4^3 tokens: a configuration that sets it has tokens counted, and the rows
they drop refused, which a serialized-patch model has none of.

Operations are multiply-adds times two. Attention counts its useful pairs
only: no pad rows, no recompute, the backward twice the forward. Bytes
count each input read once and each output written once, over the rows
that hold a pair only (``wgrad_nbytes`` of ``chip_smoke.py``, for every
table conv): features in the conv dtype, tables int32, weight gradients
fp32; ``patch_attn``'s q, k, v, o and their gradients in the trunk dtype
(the conv dtype where the configuration has none), its log-sum-exp and
delta rows fp32. Dense calls and global ``attn`` carry no byte count.
``patch_attn``'s bytes are this model alone: no kernel of the port runs
serialized patch attention yet, so they are unchecked against a trace
until the configuration that first uses the op holds them against its
kernel's.
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
    for i, level in enumerate(lv):
        keys = sparse.coord_keys(level.coords)
        for j, (at, size) in enumerate(kernels):
            if at == i:
                pairs[j] = _pairs(keys, level.coords, size)
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
    host = torch.cat([pairs, down, tokens, dropped[None]]).tolist()
    return {"cells": cells, "pairs": dict(zip(kernels, host)),
            "down": host[len(kernels):len(kernels) + levels - 1],
            "tokens": host[-3], "token_voxels": host[-2], "dropped": host[-1]}


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


def _patch_attn(n: int, patch: int, heads: int, dim: int, e: int, train: bool) -> List[tuple]:
    """Attention within consecutive ``patch``-row patches of n rows: the
    useful pairs q P^2 + r^2 (q = n // P full patches, r = n % P rows in
    the last); q, k, v and o once, an fp32 log-sum-exp a row and head; the
    backward reads q, k, v, o and dO, writes dq, dk and dv, and reads the
    log-sum-exp and delta rows."""
    q, r = divmod(n, patch)
    f = 4.0 * dim * heads * (q * patch * patch + r * r)
    act, row = n * heads * dim * e, n * heads * 4
    out = [("attn", f, 4 * act + row)]
    if train:
        out.append(("attn_bwd", 2 * f, 8 * act + 2 * row))
    return out


def call_work(call: dict, sc: dict, cfg: dict, train: bool) -> List[tuple]:
    """[(kind, flops, bytes)] of the kernels one call of ``call`` runs on
    one scene: the forward, and with ``train`` its backward (``fused``: dx
    and dw of a k^3 self-map in one kernel; ``dgrad`` and ``wgrad`` for
    the stride-2 convs; ``attn_bwd``). Dense calls and global attention
    have no byte count."""
    ci, co = call.get("c_in", 0), call.get("c_out", 0)
    e = _ELT[cfg["conv_dtype"]]
    w = 4  # fp32 weight gradients
    op = call["op"]
    if op == "attn":
        s = sc["tokens"]
        f = 4.0 * s * s * call["head_dim"] * call["heads"]
        return [("attn", f, 0.0)] + ([("attn_bwd", 2 * f, 0.0)] if train else [])
    if op == "patch_attn":
        return _patch_attn(sc["cells"][call["level"]], call["patch"], call["heads"],
                           call["head_dim"], _ELT[cfg.get("trunk_dtype", cfg["conv_dtype"])],
                           train)
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
    if op == "down2":
        n_in, n_out = fine, coarse
    elif op == "up2":
        n_in, n_out = coarse, fine
    else:
        raise ValueError(f"unknown op {op!r}")
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
