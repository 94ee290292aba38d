"""The plain work counter: what a batch asks of the model, counted by the
benchmark on the device from the coordinates and the configuration's call
table, never from the program's own counters, so that a share reads the
same work whatever implements it.

Per scene: the cells of each stride level (the first ``max(n_cap >> l,
floor)`` in lexicographic order), the 3^3 pairs of each level, the stride-2
parity pairs between levels (finer cells whose cell is kept), the 4^3
tokens (the first ``token_capacity``), the voxels whose token is kept,
and the rows a capacity drops (finer rows whose cell lies past its level's
capacity, tokens' voxels likewise): a cell's set-up refuses a pool on
which a capacity drops any, so that every cell times the model's whole
work.

The call table (``calls`` in a configuration) lists each conv and
attention call of one forward:

- ``{"op": "sub3", "level": l, "c_in", "c_out"}``: a 3^3 submanifold conv;
- ``{"op": "down2", "level": l, ...}``: the 2^3 stride-2 conv from level l
  to l + 1; ``{"op": "up2", "level": l, ...}``: the transposed conv from
  l + 1 onto level l;
- ``{"op": "dense", "rows": "voxels" | "tokens", "level": l, ...}``: a 1x1
  conv or a dense layer over the level's cells or the tokens;
- ``{"op": "attn", "heads", "head_dim"}``: global attention over each
  scene's tokens;

each with an optional ``count``. Operations are multiply-adds times two.
Bytes count each input read once and each output written once, over the
rows that hold a pair only (``wgrad_nbytes`` of ``chip_smoke.py``, for
every table conv): features in the conv dtype, tables int32, weight
gradients fp32.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.models import sparse


def scene_counts(coords: torch.Tensor, cfg: dict, n_cap: int) -> Dict[str, list]:
    """Counts of one lexicographic scene (coords [n, 3] on the device)."""
    levels = cfg.get("levels", 1)
    caps = sparse.level_caps(n_cap, levels, cfg.get("level_cap_floor", 1))
    lv = sparse.scene_levels(coords, caps)
    dev = coords.device
    dropped = torch.zeros((), dtype=torch.int64, device=dev) + max(coords.shape[0] - caps[0], 0)
    pairs = torch.zeros(levels, dtype=torch.int64, device=dev)
    down = torch.zeros(max(levels - 1, 0), dtype=torch.int64, device=dev)
    for i, level in enumerate(lv):
        keys = sparse.coord_keys(level.coords)
        n = keys.numel()
        for off in sparse.offsets_3d(3, dev):
            q = sparse.coord_keys(level.coords + off)
            pos = torch.searchsorted(keys, q).clamp(max=max(n - 1, 0))
            pairs[i] += (keys[pos] == q).sum()
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
    return {"cells": cells, "pairs": host[:levels], "down": host[levels:2 * levels - 1],
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


def call_work(call: dict, sc: dict, cfg: dict, train: bool) -> List[tuple]:
    """[(kind, flops, bytes)] of the kernels one call of ``call`` runs on
    one scene: the forward, and with ``train`` its backward (``fused``: dx
    and dw of a 3^3 self-map in one kernel; ``dgrad`` and ``wgrad`` for
    the stride-2 convs; ``attn_bwd``). Dense calls have no byte count."""
    ci, co = call.get("c_in", 0), call.get("c_out", 0)
    e = _ELT[cfg["conv_dtype"]]
    w = 4  # fp32 weight gradients
    op = call["op"]
    if op == "attn":
        s = sc["tokens"]
        f = 4.0 * s * s * call["head_dim"] * call["heads"]
        return [("attn", f, 0.0)] + ([("attn_bwd", 2 * f, 0.0)] if train else [])
    if op == "dense":
        f = 2.0 * _rows(call, sc) * ci * co
        return [("dense", f, 0.0)] + ([("dense_bwd", 2 * f, 0.0)] if train else [])
    if op == "sub3":
        n, p = sc["cells"][call["level"]], sc["pairs"][call["level"]]
        f = 2.0 * p * ci * co
        wb = 27 * ci * co * e
        out = [("fwd", f, n * ci * e + wb + 27 * n * 4 + n * co * e)]
        if train:
            out.append(("fused", 2 * f, 2 * n * ci * e + n * co * e + wb + 27 * n * 4
                        + 27 * ci * co * w))
        return out
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
