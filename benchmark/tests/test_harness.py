"""CPU tests of the benchmark's harness: the work counter against a brute
force, the augmentation's invariance, discovery by name, the rules of
``BENCHMARK.json``, its independence from JAX, and the exit without a card.

    python3 -m pytest benchmark/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import cell, measure, spec, traffic, work
from benchmark.models import sparse

BENCH = spec.BENCH_DIR
REPO = spec.REPO_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL_MIX = {"kind": "train", "batch": 2, "pairs": 2, "n_points": [700, 1500], "coord_range": 64,
             "augment": {"translate_step": 16, "translate_max": 1024}}
N_CAP = 2048


def brute_counts(coords: np.ndarray, cfg: dict, n_cap: int) -> dict:
    """Pairs, parity pairs, tokens and dropped rows of one scene by sets of
    tuples."""
    caps = [max(n_cap >> i, cfg.get("level_cap_floor", 1)) for i in range(cfg.get("levels", 1))]
    levels = [sorted(map(tuple, coords.tolist()))[:caps[0]]]
    dropped = len(coords) - len(levels[0])
    down = []
    for cap in caps[1:]:
        fine = levels[-1]
        cells = sorted({(x >> 1, y >> 1, z >> 1) for x, y, z in fine})[:cap]
        kept = set(cells)
        down.append(sum((x >> 1, y >> 1, z >> 1) in kept for x, y, z in fine))
        dropped += len(fine) - down[-1]
        levels.append(cells)
    pairs = {}
    for i, lv in enumerate(levels):
        s = set(lv)
        pairs[(i, 3)] = sum((x + a, y + b, z + c) in s for x, y, z in lv
                            for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    out = {"cells": [len(lv) for lv in levels], "pairs": pairs, "down": down}
    if "patch_size" in cfg:
        p = cfg["patch_size"]
        cells = sorted({(x // p, y // p, z // p) for x, y, z in levels[0]})[:cfg["token_capacity"]]
        kept = set(cells)
        out["tokens"] = len(cells)
        out["token_voxels"] = sum((x // p, y // p, z // p) in kept for x, y, z in levels[0])
        dropped += len(levels[0]) - out["token_voxels"]
    out["dropped"] = dropped
    return out


@pytest.mark.parametrize("config", ["minkunet18", "volt-s"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_work_counter_matches_brute_force(config, seed):
    cfg = dict(spec.config(config))
    cfg["token_capacity"] = 60  # small enough to drop tokens, as a capacity must
    pool = traffic.make_pool(SMALL_MIX, 3, seed, "cpu", N_CAP)
    counts = work.pool_counts(pool, cfg, N_CAP // 8)  # caps bind at level 1
    for e, sizes in enumerate(pool.sizes):
        for s, n in enumerate(sizes):
            c = pool.coords[e, s, :n].numpy()
            want = brute_counts(c, cfg, N_CAP // 8)
            got = counts[e][s]
            assert want["dropped"] > 0
            for key, value in want.items():
                assert got[key] == value, (key, got[key], value)


@pytest.mark.parametrize("config", ["minkunet18", "volt-s"])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3])
def test_augmentation_keeps_every_count(config, seed):
    """Flips, swaps and translations keep every count of a pool on which
    no capacity drops a cell (n_cap 8192 for these scenes)."""
    cfg = dict(spec.config(config), token_capacity=4096)
    n_cap = 8192
    pool = traffic.make_pool(SMALL_MIX, 3, seed, "cpu", n_cap)
    base = work.pool_counts(pool, cfg, n_cap)
    assert all(sc["dropped"] == 0 for entry in base for sc in entry)
    feed = traffic.Feed(pool, SMALL_MIX, seed)
    moved = 0
    for i in range(12):
        item = feed(i)
        for s in range(item.coords.shape[0]):
            n = int(item.num_valid[s])
            c = item.coords[s, :n].to(torch.int64)
            moved += int((c != pool.coords[item.entry, s, :n]).any())
            got = work.scene_counts(c[sparse.lex_order(c)], cfg, n_cap)
            assert got == base[item.entry][s]
    assert moved > 0


def test_bench_mixes_keep_the_work_counts():
    """The mixes' coordinate range and translation step are powers of two
    of at least 16, so every stride-2**l level (l <= 4) and every 4^3 patch
    keep their cells under the augmentation."""
    for name in {w["traffic"] for w in spec.benchmark_file()["workloads"]}:
        mix = spec.traffic(name)
        step, top = mix["augment"]["translate_step"], mix["coord_range"]
        assert step % 16 == 0 and top >= 16 and top & (top - 1) == 0


def test_a_capacity_that_drops_cells_is_refused():
    """Set-up refuses a pool on which a level's capacity drops cells: the
    cell would time less than the model's work."""
    name = "minkunet18.infer"
    c = spec.cell(name)
    c = c._replace(config={**c.config, "n_cap": 256, "conv_dtype": "float32"},
                   traffic={**c.traffic, "n_points": [500, 900], "pairs": 1, "coord_range": 64})
    with pytest.raises(ValueError, match="drop"):
        cell.Run(c, 3, 0.1, "cpu").setup()


def test_feed_and_pool_repeat_for_a_seed():
    a, b = (traffic.make_pool(SMALL_MIX, 3, 2 ** 33 + 5, "cpu", N_CAP) for _ in range(2))
    assert torch.equal(a.coords, b.coords) and torch.equal(a.features, b.features)
    fa, fb = traffic.Feed(a, SMALL_MIX, 9), traffic.Feed(b, SMALL_MIX, 9)
    assert torch.equal(fa(5).coords, fb(5).coords)
    sizes = sorted(n for pair in a.sizes for n in pair)
    c = traffic.make_pool(SMALL_MIX, 3, 4, "cpu", N_CAP)
    assert len(sizes) == len([n for pair in c.sizes for n in pair])


def test_labels_repeat_for_a_seed_and_differ_by_scene():
    a, b = (traffic.labels(traffic.torch_generator(2 ** 31 + 9, 6, "cpu"), 2, 4096, 20, 2.0, "cpu")
            for _ in range(2))
    assert torch.equal(a, b) and a.shape == (2, 4096) and 0 <= int(a.min()) <= int(a.max()) < 20
    freq = [torch.bincount(a[s], minlength=20).float() / 4096 for s in range(2)]
    assert float((freq[0] - freq[1]).abs().sum()) > 0.5


def _copy_bench(tmp_path):
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    return dst


def test_new_config_mix_metric_and_cell_are_found_by_name(tmp_path, monkeypatch):
    dst = _copy_bench(tmp_path)
    cfg = json.loads((dst / "configs" / "minkunet18.json").read_text())
    cfg["name"] = "minkunet18-b"
    (dst / "configs" / "minkunet18-b.json").write_text(json.dumps(cfg))
    mix = json.loads((dst / "traffic" / "train.json").read_text())
    mix["batch"] = 8
    (dst / "traffic" / "train.b8.json").write_text(json.dumps(mix))
    (dst / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return float(ctx.items) if ctx.kind == 'train' else None\n")
    monkeypatch.setattr(spec, "BENCH_DIR", str(dst))
    bench = json.loads(open(os.path.join(REPO, "BENCHMARK.json")).read())
    bench["workloads"].append({"name": "minkunet18-b.train.b8", "config": "minkunet18-b",
                               "traffic": "train.b8", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_points_per_s":
            m["workloads"].append("minkunet18-b.train.b8")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "x", "moves": "train_points_per_s"})
    c = spec.cell("minkunet18-b.train.b8", bench)
    assert c.config["name"] == "minkunet18-b" and c.traffic["batch"] == 8
    assert "steps.train" in [m["name"] for m in c.per_layer]
    ctx = cell.Context("train", c.config, c.traffic)
    ctx.items = 4
    assert spec.metric_reader("steps.train")(ctx) == 4.0
    assert spec.metric_path("mfu.infer") == os.path.join(str(dst), "metrics", "mfu.py")
    assert spec.reference(c.config).__name__ == "benchmark.models.minkunet"


def test_benchmark_json_follows_the_rules():
    raw = open(os.path.join(REPO, "BENCHMARK.json")).read()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        for n in group:
            assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(REPO, c["file"]))
        assert json.load(open(os.path.join(REPO, c["file"])))["reduced"] == c["reduced"]
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["name"] in {w["config"] for w in b["workloads"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"]) and w["config"] in names
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cname in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert cname in moved.get("workloads", cells), (m["name"], cname)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(spec.metric_path(m["name"])), m["name"]
    for w in cells:
        c = spec.cell(w, b)
        assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
        assert c.per_layer


def test_every_reader_stays_silent_without_its_data():
    b = spec.benchmark_file()
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] == "setup_s":
            continue
        for kind in ("train", "infer"):
            ctx = cell.Context(kind, spec.config("minkunet18"), {})
            assert spec.metric_reader(m["name"])(ctx) is None, m["name"]


def test_trace_reduction():
    t = measure.Trace(device=[("a", 0.0, 1.0), ("b", 0.5, 1.0), ("a", 3.0, 1.0)],
                      host=[("step", -1.0, 10.0), ("sync", 1.4, 1.0)])
    assert t.busy_s() == pytest.approx(2.5) and t.span_s() == pytest.approx(4.0)
    assert t.top_ops()[0] == ["a", 2.0]
    assert t.idle_gaps() == [["sync", pytest.approx(1.5)]]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package_and_references_import_no_program():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for mod in _imports(path):
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "warpconvnet_tpu", "bench", "data", "scripts"), (
                    path, mod)
                if "models" in path.split(os.sep) or "metrics" in path.split(os.sep):
                    assert top != "warpconvnet_tpu_torch", (path, mod)


def test_jax_in_the_process_is_found_by_whole_top_level_names():
    from benchmark import run

    loaded = {"jax": 0, "jax.numpy": 0, "jaxlib.xla_client": 0, "flax.linen": 0,
              "warpconvnet_tpu": 0, "warpconvnet_tpu.ops": 0, "warpconvnet_tpu_torch": 0,
              "warpconvnet_tpu_torch.ops": 0, "jaxtyping": 0, "torch": 0}
    assert run.jax_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                       "warpconvnet_tpu", "warpconvnet_tpu.ops"]


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "minkunet18.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
