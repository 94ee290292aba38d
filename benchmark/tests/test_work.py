"""CPU tests of the work counter's call-table ops and of the roofline
readers that use them: k^3 submanifold pairs against a set lookup,
serialized patch attention against an explicit construction, window
attention's pair sums against a brute force and a hand count, set-up
refusing a pool whose window sums a flip changes, ``sub`` at k 3 against
``sub3``, an unknown op refused, the four cells' work totals pinned, and
PTv3 and SpaCeFormer call tables at published widths counted on the pool
of 80k-120k samples.

    python3 -m pytest benchmark/tests/test_work.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch

from benchmark.harness import cell, measure, spec, traffic, work
from benchmark.models import sparse

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


def brute_window_sum(cells, window: int, shift: int) -> int:
    """Sum over the windows of ``cells`` (anchored at their minimum per
    axis, moved by ``shift``) of the cells each holds, squared."""
    low = [min(c[a] for c in cells) for a in range(3)]
    occ = Counter(tuple((c[a] - low[a] + shift) // window for a in range(3)) for c in cells)
    return sum(k * k for k in occ.values())


WINDOWS = [(4, 0), (4, 2), (2, 0), (2, 1)]


def window_cfg():
    """Window attention at levels 0-3 at each of ``WINDOWS``."""
    return {"levels": 4, "level_cap_floor": 1, "conv_dtype": "bfloat16",
            "calls": [{"op": "window_attn", "level": lv, "window": w, "shift": sh, "heads": 2,
                       "head_dim": 16} for lv in range(4) for w, sh in WINDOWS]}


@pytest.mark.parametrize("seed", [13, 2 ** 31 + 41])
def test_window_attn_pairs_match_a_brute_force(seed):
    cfg = window_cfg()
    n_cap = 4096
    pool = traffic.make_pool(SMALL_MIX, 3, seed, "cpu", n_cap)
    counts = work.pool_counts(pool, cfg, n_cap)
    for e, sizes in enumerate(pool.sizes):
        for s, n in enumerate(sizes):
            lv = brute_levels(pool.coords[e, s, :n].numpy(), [n_cap >> i for i in range(4)])
            got = counts[e][s]
            assert list(got["windows"]) == [(level, w, sh) for level in range(4)
                                            for w, sh in WINDOWS]
            for (level, w, sh), p in got["windows"].items():
                assert p == brute_window_sum(lv[level], w, sh), (level, w, sh)
                assert len(lv[level]) <= p <= len(lv[level]) * w ** 3
            call = {"op": "window_attn", "level": 2, "window": 4, "shift": 2, "heads": 2,
                    "head_dim": 16}
            (kind, f, b), (kind_bwd, f_bwd, b_bwd) = work.call_work(call, got, cfg, True)
            n2 = len(lv[2])
            assert (kind, kind_bwd) == ("attn", "attn_bwd")
            assert f == 4 * 16 * 2 * got["windows"][(2, 4, 2)] and f_bwd == 2 * f
            assert b == 4 * n2 * 2 * 16 * 2 + n2 * 2 * 4
            assert b_bwd == 8 * n2 * 2 * 16 * 2 + 2 * n2 * 2 * 4


def test_window_attn_hand_checked_example():
    """Five cells, anchored at their minimum (5, 6, 7): windows of 4 hold
    3, 1 and 1 of them (9 + 1 + 1 pairs); shifted by 2, they hold 2, 2
    and 1 (4 + 4 + 1)."""
    cells = torch.tensor([[0, 0, 0], [1, 0, 0], [3, 3, 3], [4, 0, 0], [5, 5, 5]]) + torch.tensor(
        [5, 6, 7])
    cfg = {"levels": 1, "conv_dtype": "float32", "trunk_dtype": "float32",
           "calls": [{"op": "window_attn", "level": 0, "window": 4, "shift": s, "heads": 3,
                      "head_dim": 16} for s in (0, 2)]}
    sc = work.scene_counts(cells, cfg, 16)
    assert sc["windows"] == {(0, 4, 0): 11, (0, 4, 2): 9}
    (kind, flops, nbytes), = work.call_work(cfg["calls"][1], sc, cfg, False)
    assert kind == "attn" and flops == 4 * 16 * 3 * 9
    assert nbytes == 4 * 5 * 3 * 16 * 4 + 5 * 3 * 4


def test_window_attn_flips_are_counted_and_a_bad_shift_is_refused():
    """Cells at x 0, 3, 4, 5: windows of 4 from x 0 hold 2 and 2 (8
    pairs); flipped in x, from x 5 down, 3 and 1 (10)."""
    cells = torch.tensor([[0, 0, 0], [3, 0, 0], [4, 0, 0], [5, 0, 0]])
    cfg = {"levels": 1, "conv_dtype": "bfloat16",
           "calls": [{"op": "window_attn", "level": 0, "window": 4, "shift": 0, "heads": 1,
                      "head_dim": 16}]}
    sc = work.scene_counts(cells, cfg, 16)
    assert sc["windows"] == {(0, 4, 0): 8} and sc["window_flips"] == {(0, 4, 0): [10, 8, 10]}
    assert work.flip_dependent([[sc]]) == [
        "entry 0 scene 0 level 0 (window 4, shift 0): 8 pairs, flipped x, y, both [10, 8, 10]"]
    bad = {**cfg, "calls": [{**cfg["calls"][0], "shift": 1}]}
    with pytest.raises(ValueError, match="shifts by 0 or 2"):
        work.scene_counts(cells, bad, 16)


def test_configurations_without_window_attn_count_no_windows():
    pool = traffic.make_pool(SMALL_MIX, 3, 8, "cpu", 2048)
    for name in ("minkunet18", "volt-s", "ptv3"):
        for entry in work.pool_counts(pool, spec.config(name), 2048):
            assert all(sc["windows"] == {} and sc["window_flips"] == {} for sc in entry)


def test_a_pool_whose_window_sums_a_flip_changes_is_refused(monkeypatch):
    """Scenes moved off x 0 (they span [1, R-1]) fall into other windows
    when the feed flips x: set-up names the scene and level and refuses."""
    made = traffic.make_surface_scene

    def off_the_edge(rng, n_cap, coord_range, n_points):
        c = made(rng, n_cap, coord_range, n_points)
        c = c[c[:, 0] < coord_range - 1]
        c[:, 0] += 1
        return c

    monkeypatch.setattr(traffic, "make_surface_scene", off_the_edge)
    name = "minkunet18.infer"
    c = spec.cell(name)
    window = {"op": "window_attn", "level": 0, "window": 4, "shift": 0, "heads": 2,
              "head_dim": 16}
    c = c._replace(config={**c.config, "n_cap": 8192, "conv_dtype": "float32",
                           "calls": c.config["calls"] + [window]},
                   traffic={**c.traffic, "n_points": [700, 1500], "pairs": 1,
                            "coord_range": 64})
    with pytest.raises(ValueError, match=r"flips change the window sums.*entry 0 scene \d level 0"):
        cell.Run(c, 3, 0.1, "cpu").setup()


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3])
def test_the_feed_keeps_every_window_sum(seed):
    """Every item of the feed (flips, swap, translation) has the pool's
    window sums, shifted or not, at every level."""
    cfg = window_cfg()
    n_cap = 4096
    pool = traffic.make_pool(SMALL_MIX, 3, seed, "cpu", n_cap)
    base = work.pool_counts(pool, cfg, n_cap)
    assert work.flip_dependent(base) == []
    feed = traffic.Feed(pool, SMALL_MIX, seed)
    for i in range(12):
        item = feed(i)
        for s in range(item.coords.shape[0]):
            n = int(item.num_valid[s])
            c = item.coords[s, :n].to(torch.int64)
            got = work.scene_counts(c[sparse.lex_order(c)], cfg, n_cap)
            assert got["windows"] == base[item.entry][s]["windows"]


def test_an_unknown_op_is_refused_by_name():
    sc = {"cells": [10], "down": [], "pairs": {}, "windows": {}}
    for call in ({"op": "conv5"}, {"op": "window", "level": 0}, {"op": "down3", "level": 9}):
        with pytest.raises(ValueError, match=f"unknown op '{call['op']}'"):
            work.call_work(call, sc, {"conv_dtype": "bfloat16"}, True)


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


def spaceformer_calls():
    """One SpaCeFormer forward at the JAX package's defaults
    (``warpconvnet_tpu/models/space_former.py``): dims (64, 128, 256, 512),
    depths (2, 2, 6, 2), decoder depths (2, 2, 2), heads of 16 channels,
    4^3 windows, 512-row curve patches, a 4x MLP. A 3^3 stem; block i of a
    stage attends within windows, shifted by 2 where i % 3 is 1, or within
    serialized patches where i % 3 is 2; 2^3 down convs, transposed up
    convs, a 1x1 fuse of the skip concat, a 64 -> 20 head."""
    dims, depths, dec_depths = (64, 128, 256, 512), (2, 2, 6, 2), (2, 2, 2)

    def dense(level, c_in, c_out):
        return {"op": "dense", "rows": "voxels", "level": level, "c_in": c_in, "c_out": c_out}

    def stage(level, c, depth):
        calls = []
        for i in range(depth):
            if i % 3 == 2:
                attn = {"op": "patch_attn", "patch": 512}
            else:
                attn = {"op": "window_attn", "window": 4, "shift": 2 if i % 3 == 1 else 0}
            calls += [dense(level, c, 3 * c),
                      {**attn, "level": level, "heads": c // 16, "head_dim": 16},
                      dense(level, c, c), dense(level, c, 4 * c), dense(level, 4 * c, c)]
        return calls

    calls = [{"op": "sub3", "level": 0, "c_in": 6, "c_out": dims[0]}]
    for level, (c, depth) in enumerate(zip(dims, depths)):
        if level:
            calls.append({"op": "down2", "level": level - 1, "c_in": dims[level - 1], "c_out": c})
        calls += stage(level, c, depth)
    for level in reversed(range(len(dec_depths))):
        calls += [{"op": "up2", "level": level, "c_in": dims[level + 1], "c_out": dims[level]},
                  dense(level, 2 * dims[level], dims[level])]
        calls += stage(level, dims[level], dec_depths[level])
    return calls + [dense(0, dims[0], 20)]


SPACEFORMER = {"name": "spaceformer-fixture", "n_cap": 262144, "levels": 4,
               "level_cap_floor": 128, "conv_dtype": "bfloat16", "trunk_dtype": "float32",
               "calls": spaceformer_calls()}


@pytest.fixture(scope="module")
def spaceformer_counts():
    """The counts of the benchmark's training pool of 80k and 120k samples
    (one batch of two scenes)."""
    mix = {**spec.traffic("train"), "pairs": 1}
    pool = traffic.make_pool(mix, 6, 2 ** 31 + 29, "cpu", SPACEFORMER["n_cap"])
    return work.pool_counts(pool, SPACEFORMER, SPACEFORMER["n_cap"])[0]


def test_spaceformer_call_table_counts_window_attention_by_its_bytes(spaceformer_counts):
    """16 of the 18 blocks attend within windows: under 1% of a forward's
    FLOPs (0.8-1.0% on this pool), but about four fifths of the bytes
    counted (79-80%: dense layers count none, convs few)."""
    calls = SPACEFORMER["calls"]
    assert sum(c["op"] == "window_attn" for c in calls) == 16
    assert sum(c["op"] == "patch_attn" for c in calls) == 2
    assert work.flip_dependent([spaceformer_counts]) == []
    for sc in spaceformer_counts:
        assert sc["dropped"] == 0 and set(sc["windows"]) == {
            (lv, 4, s) for lv in range(4) for s in (0, 2)}
        for (lv, _, _), p in sc["windows"].items():
            assert sc["cells"][lv] < p < 64 * sc["cells"][lv]
        fwd = work.batch_work([sc], SPACEFORMER, False)
        flops = sum(f for _, _, f, _ in fwd)
        nbytes = sum(b for _, _, _, b in fwd)
        win_f = sum(f for _, op, f, _ in fwd if op == "window_attn")
        win_b = sum(b for _, op, _, b in fwd if op == "window_attn")
        assert 0.004 <= win_f / flops <= 0.02, win_f / flops
        assert 0.6 <= win_b / nbytes <= 0.95, win_b / nbytes
        assert {op for _, op, _, _ in fwd} == {"sub3", "down2", "up2", "dense", "window_attn",
                                               "patch_attn"}
    step = work.batch_work(spaceformer_counts, SPACEFORMER, True)
    assert {k for k, op, _, _ in step if op == "window_attn"} == {"attn", "attn_bwd"}


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
