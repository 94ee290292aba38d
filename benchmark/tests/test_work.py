"""CPU tests of the work counter's call-table ops and of the roofline
readers that use them: k^3 submanifold pairs against a set lookup,
serialized patch attention against an explicit construction, ``sub`` at
k 3 against ``sub3``, the four cells' work totals pinned, and a PTv3 call
table at published widths counted on the pool of 80k-120k samples.

    python3 -m pytest benchmark/tests/test_work.py -q
"""

import numpy as np
import pytest
import torch

from benchmark.harness import cell, measure, spec, traffic, work

SMALL_MIX = {"kind": "train", "batch": 2, "pairs": 2, "n_points": [700, 1500], "coord_range": 64,
             "augment": {"translate_step": 16, "translate_max": 1024}}


def brute_levels(coords: np.ndarray, caps):
    """Each level's cells as a sorted list of tuples, as the counter keeps
    them: the first ``cap`` in lexicographic order, each level the cells
    of the one before halved."""
    levels = [sorted(map(tuple, coords.tolist()))[:caps[0]]]
    for cap in caps[1:]:
        levels.append(sorted({(x >> 1, y >> 1, z >> 1) for x, y, z in levels[-1]})[:cap])
    return levels


def brute_pairs(cells, k: int) -> int:
    s, r = set(cells), range(-(k // 2), k // 2 + 1)
    return sum((x + a, y + b, z + c) in s for x, y, z in cells for a in r for b in r for c in r)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 19])
def test_sub_pairs_match_a_set_lookup(seed):
    cfg = {"levels": 3, "level_cap_floor": 1, "conv_dtype": "bfloat16",
           "calls": [{"op": "sub", "kernel": 5, "level": 0, "c_in": 6, "c_out": 32},
                     {"op": "sub", "kernel": 5, "level": 2, "c_in": 8, "c_out": 8},
                     {"op": "sub", "kernel": 7, "level": 1, "c_in": 8, "c_out": 8},
                     {"op": "sub", "kernel": 3, "level": 1, "c_in": 8, "c_out": 8},
                     {"op": "sub", "kernel": 5, "level": 0, "c_in": 32, "c_out": 32}]}
    n_cap = 1024  # level 0 keeps the first 1024 cells of a larger scene
    pool = traffic.make_pool(SMALL_MIX, 3, seed, "cpu", 2048)
    counts = work.pool_counts(pool, cfg, n_cap)
    for e, sizes in enumerate(pool.sizes):
        for s, n in enumerate(sizes):
            lv = brute_levels(pool.coords[e, s, :n].numpy(), [n_cap, n_cap >> 1, n_cap >> 2])
            got = counts[e][s]
            assert list(got["pairs"]) == [(0, 3), (1, 3), (2, 3), (0, 5), (2, 5), (1, 7)]
            for (level, k), p in got["pairs"].items():
                assert p == brute_pairs(lv[level], k), (level, k)


def test_configurations_without_sub_count_3_cubed_pairs_only():
    pool = traffic.make_pool(SMALL_MIX, 3, 8, "cpu", 2048)
    for name in ("minkunet18", "volt-s"):
        cfg = spec.config(name)
        levels = cfg.get("levels", 1)
        for entry in work.pool_counts(pool, cfg, 2048):
            assert all(list(sc["pairs"]) == [(lv, 3) for lv in range(levels)] for sc in entry)


def test_an_even_submanifold_kernel_is_refused():
    cfg = {"calls": [{"op": "sub", "kernel": 4, "level": 0, "c_in": 1, "c_out": 1}]}
    with pytest.raises(ValueError, match="odd"):
        work.scene_counts(torch.zeros((1, 3), dtype=torch.int64), cfg, 16)


def explicit_patch_attn(n, patch, heads, dim, dtype, seed):
    """FLOPs and bytes of patch attention built by hand: serialize the rows
    in some order, chunk them into ``patch`` rows, and sum each chunk's
    query-key pairs; bytes from the tensors a kernel reads and writes."""
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    chunks = torch.split(order, patch)
    pairs = sum(len(c) ** 2 for c in chunks)
    fwd = 4 * dim * heads * pairs
    act = torch.empty(n, heads, dim, dtype=dtype).nbytes
    row = torch.empty(n, heads, dtype=torch.float32).nbytes
    q = k = v = o = do = dq = dk = dv = act
    lse = delta = row
    return [("attn", fwd, q + k + v + o + lse),
            ("attn_bwd", 2 * fwd, q + k + v + o + do + dq + dk + dv + lse + delta)]


@pytest.mark.parametrize("n", [1, 300, 1024, 3072, 2500, 40961])
@pytest.mark.parametrize("dtypes,torch_dtype", [({"conv_dtype": "bfloat16"}, torch.bfloat16),
                                                ({"conv_dtype": "bfloat16",
                                                  "trunk_dtype": "float32"}, torch.float32)])
def test_patch_attn_matches_an_explicit_construction(n, dtypes, torch_dtype):
    call = {"op": "patch_attn", "level": 1, "patch": 1024, "heads": 4, "head_dim": 16}
    sc = {"cells": [7, n]}
    want = explicit_patch_attn(n, 1024, 4, 16, torch_dtype, n)
    assert work.call_work(call, sc, dtypes, True) == want
    assert work.call_work(call, sc, dtypes, False) == want[:1]


def test_patch_attn_hand_checked_example():
    call = {"op": "patch_attn", "level": 0, "patch": 1024, "heads": 2, "head_dim": 16}
    (kind, flops, _), = work.call_work(call, {"cells": [2500]}, {"conv_dtype": "bfloat16"}, False)
    assert kind == "attn" and flops == 4 * 16 * 2 * (2 * 1024 ** 2 + 452 ** 2)


@pytest.mark.parametrize("kernel", [{"kernel": 3}, {}])
@pytest.mark.parametrize("train", [True, False])
def test_sub_at_kernel_3_is_sub3(train, kernel):
    cfg = spec.config("minkunet18")
    pool = traffic.make_pool(SMALL_MIX, 3, 2 ** 31 + 23, "cpu", 8192)
    as_sub = {**cfg, "calls": [{**c, "op": "sub", **kernel} if c["op"] == "sub3" else c
                               for c in cfg["calls"]]}
    for entry in work.pool_counts(pool, as_sub, 8192):
        got = work.batch_work(entry, as_sub, train)
        want = work.batch_work(entry, cfg, train)
        assert [(k, f, b) for k, _, f, b in got] == [(k, f, b) for k, _, f, b in want]
        assert {op for _, op, _, _ in got} == {"sub", "down2", "up2", "dense"}


# (kind/op) -> [FLOPs, bytes] summed over the pool below, from the counter
# before ``sub`` and ``patch_attn`` existed.
PINNED = {
    "minkunet18.train": {
        "dense/dense": [459748224.0, 0.0], "dense_bwd/dense": [919496448.0, 0.0],
        "fwd/down2": [52723712.0, 3050528.0], "dgrad/down2": [52723712.0, 3182208.0],
        "wgrad/down2": [52723712.0, 4492320.0], "fwd/sub3": [12659814400.0, 195436784.0],
        "fused/sub3": [25319628800.0, 534009584.0], "fwd/up2": [380325888.0, 11966336.0],
        "dgrad/up2": [380325888.0, 11834656.0], "wgrad/up2": [380325888.0, 19634048.0]},
    "minkunet18.infer": {
        "dense/dense": [459748224.0, 0.0], "fwd/down2": [52723712.0, 3050528.0],
        "fwd/sub3": [12659814400.0, 195436784.0], "fwd/up2": [380325888.0, 11966336.0]},
    "volt-s.train": {
        "fwd/sub3": [77149696.0, 3516252.0], "fused/sub3": [154299392.0, 5941384.0],
        "dense/dense": [85459055616.0, 0.0], "dense_bwd/dense": [170918111232.0, 0.0],
        "attn/attn": [18748993536.0, 0.0], "attn_bwd/attn": [37497987072.0, 0.0]},
    "volt-s.infer": {
        "fwd/sub3": [77149696.0, 3516252.0], "dense/dense": [85459055616.0, 0.0],
        "attn/attn": [18748993536.0, 0.0]},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_cells_work_totals_are_pinned(name):
    config, kind = name.split(".")
    cfg = spec.config(config)
    pool = traffic.make_pool(SMALL_MIX, 3, 2 ** 31 + 17, "cpu", 8192)
    totals = {}
    for entry in work.pool_counts(pool, cfg, 8192):
        for k, op, f, b in work.batch_work(entry, cfg, kind == "train"):
            t = totals.setdefault(f"{k}/{op}", [0.0, 0.0])
            t[0] += f
            t[1] += b
    assert totals == PINNED[name]


def ptv3_calls():
    """One PTv3 forward at the published ScanNet widths (Wu et al., CVPR
    2024; Pointcept ``semseg-pt-v3m1-0-base``): a 5^3 stem 6 -> 32; per
    block an xCPE (3^3 conv and a linear), qkv, attention over 1024-row
    serialized patches in heads of 16 channels, the projection and a 4x
    MLP; stride-2 grid pooling as a linear on the finer rows, unpooling as
    a linear on the coarser rows plus one on the skip; a 64 -> 20 head."""
    enc_depths, enc = (2, 2, 2, 6, 2), (32, 64, 128, 256, 512)
    dec_depths, dec = (2, 2, 2, 2), (64, 64, 128, 256)

    def dense(level, c_in, c_out):
        return {"op": "dense", "rows": "voxels", "level": level, "c_in": c_in, "c_out": c_out}

    def blocks(level, c, depth):
        return [
            {"op": "sub3", "level": level, "c_in": c, "c_out": c, "count": depth},
            {**dense(level, c, c), "count": depth},
            {**dense(level, c, 3 * c), "count": depth},
            {"op": "patch_attn", "level": level, "patch": 1024, "heads": c // 16, "head_dim": 16,
             "count": depth},
            {**dense(level, c, c), "count": depth},
            {**dense(level, c, 4 * c), "count": depth},
            {**dense(level, 4 * c, c), "count": depth},
        ]

    calls = [{"op": "sub", "kernel": 5, "level": 0, "c_in": 6, "c_out": 32}]
    for level, (c, depth) in enumerate(zip(enc, enc_depths)):
        if level:
            calls.append(dense(level - 1, enc[level - 1], c))
        calls += blocks(level, c, depth)
    below = enc[-1]
    for level in reversed(range(len(dec))):
        calls += [dense(level + 1, below, dec[level]), dense(level, enc[level], dec[level])]
        calls += blocks(level, dec[level], dec_depths[level])
        below = dec[level]
    return calls + [dense(0, 64, 20)]


PTV3 = {"name": "ptv3-fixture", "n_cap": 262144, "levels": 5, "level_cap_floor": 128,
        "conv_dtype": "bfloat16", "calls": ptv3_calls()}


@pytest.fixture(scope="module")
def ptv3_counts():
    """The counts of the benchmark's training pool of 80k and 120k samples
    (one batch of two scenes)."""
    mix = {**spec.traffic("train"), "pairs": 1}
    pool = traffic.make_pool(mix, 6, 2 ** 31 + 29, "cpu", PTV3["n_cap"])
    return work.pool_counts(pool, PTV3, PTV3["n_cap"])[0]


def test_ptv3_call_table_counts_with_attention_a_third_of_its_forward(ptv3_counts):
    for sc in ptv3_counts:
        assert sc["dropped"] == 0 and set(sc["pairs"]) == {(lv, 3) for lv in range(5)} | {(0, 5)}
        assert sc["pairs"][(0, 5)] > sc["pairs"][(0, 3)] > sc["cells"][0]
        fwd = work.batch_work([sc], PTV3, False)
        total = sum(f for _, _, f, _ in fwd)
        attn = sum(f for k, _, f, _ in fwd if k == "attn")
        assert 0.30 <= attn / total <= 0.40, attn / total
        assert {op for _, op, _, _ in fwd} == {"sub", "sub3", "dense", "patch_attn"}
    step = work.batch_work(ptv3_counts, PTV3, True)
    assert {k for k, _, _, _ in step} >= {"fwd", "fused", "attn", "attn_bwd", "dense_bwd"}


def test_ptv3_patch_attention_is_near_the_ridge(ptv3_counts):
    """At head size 16 the bytes' time is within 2x of the FLOPs' time, so
    the roofline has to bound by both."""
    peak = measure.PEAK_FLOPS["bfloat16"]
    for _, op, f, b in work.batch_work(ptv3_counts, PTV3, True):
        if op == "patch_attn":
            ratio = (b / measure.HBM_BYTES_PER_S) / (f / peak)
            assert 0.5 <= ratio <= 2.0, ratio


def _ctx(config, traced_work, seconds, kernel):
    ctx = cell.Context("train", config, {})
    ctx.traced_work = traced_work
    ctx.trace = measure.Trace(device=[(kernel, 0.0, seconds)], host=[])
    return ctx


def test_attn_roofline_reads_global_attention_as_before():
    cfg = spec.config("volt-s")
    traced = [("attn", "attn", 1.2345678e12, 0.0), ("attn_bwd", "attn", 2.4691356e12, 0.0),
              ("fwd", "sub3", 3e9, 1e6)]
    spent = 0.123456789
    before = 100.0 * (1.2345678e12 + 2.4691356e12) / measure.PEAK_FLOPS["tf32"] / spent
    got = spec.metric_reader("attn_roofline")(_ctx(cfg, traced, spent, "seg_attn_fwd_tf32_64"))
    assert got == before


def test_attn_roofline_bounds_patch_attention_by_its_bytes_too():
    cfg = {**spec.config("volt-s"), "attn_peak": "bfloat16"}
    f, b = 1e9, 3.35e12 * 2e-3  # 1 us of FLOPs, 2 ms of bytes
    traced = [("attn", "patch_attn", f, b), ("attn", "attn", 989e12 * 1e-3, 0.0)]
    got = spec.metric_reader("attn_roofline")(_ctx(cfg, traced, 0.01, "seg_attn_fwd_bf16"))
    assert got == pytest.approx(100.0 * 3e-3 / 0.01)


def test_conv_roofline_counts_sub_convs():
    cfg = spec.config("minkunet18")
    f = 989e12 * 1e-3
    traced = [("fwd", "sub", f, 0.0), ("fwd", "sub3", f, 0.0), ("dense", "dense", f, 0.0)]
    got = spec.metric_reader("conv_roofline")(_ctx(cfg, traced, 0.004, "igemm_fwd_bf16"))
    assert got == pytest.approx(50.0)
