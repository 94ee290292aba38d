"""CPU tests of the readers of the program's spans and counters
(``sync_wait_ms``, ``syncs``, ``map_build_ms``, ``optimizer_ms``,
``k2_tile_waste``) on synthetic traces: nested spans counted once, per
item; no trace gives None; a trace of a program without spans gives None
(the parent of the program that added them); a traced program with no
``wcn.sync.*`` span gives 0 syncs and 0 ms.

    python3 -m pytest benchmark/tests -q
"""

import sys
import types

import pytest

from benchmark.harness import cell, measure, spec

STEP = [("bench.step", 0.0, 1.0), ("bench.step", 2.0, 1.0)]


def _ctx(host, kind="train"):
    ctx = cell.Context(kind, spec.config("minkunet18"), {})
    ctx.trace = measure.Trace(device=[("k", 0.0, 0.5)], host=host)
    return ctx


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_sync_readers_count_outermost_spans_once_per_item():
    host = STEP + [
        ("wcn.train_step", 0.1, 0.8),
        ("wcn.map.generate_output_coords_and_kernel_map", 0.2, 0.3),
        ("wcn.map.parity_strided_unique", 0.25, 0.1),  # nested: counted once
        ("wcn.sync.parity_strided_unique", 0.26, 0.004),
        ("wcn.sync.parity_k_index", 0.4, 0.002),
        ("aten::copy_", 0.26, 0.004),
        ("wcn.sync.parity_k_index", 2.5, 0.006),
    ]
    ctx = _ctx(host)
    assert _read("sync_wait_ms.train", ctx) == pytest.approx(1e3 * 0.012 / 2)
    assert _read("syncs.train", ctx) == pytest.approx(1.5)
    assert _read("map_build_ms.train", ctx) == pytest.approx(1e3 * 0.3 / 2)


def test_no_trace_gives_none():
    ctx = cell.Context("train", spec.config("minkunet18"), {})
    for name in ("sync_wait_ms.train", "syncs.infer", "map_build_ms.train", "optimizer_ms.train",
                 "k2_tile_waste.train"):
        assert _read(name, ctx) is None, name


def test_a_program_without_spans_gives_none():
    ctx = _ctx(STEP + [("aten::copy_", 0.2, 0.1), ("Optimizer.step#Adam.step", 0.5, 0.1)])
    for name in ("sync_wait_ms.train", "syncs.train", "map_build_ms.train", "optimizer_ms.train"):
        assert _read(name, ctx) is None, name


def test_no_sync_span_gives_zero_syncs_and_zero_ms():
    ctx = _ctx([("bench.request", 0.0, 1.0), ("wcn.model.volt", 0.1, 0.8),
                ("wcn.map.lex_sort", 0.1, 0.1)], "infer")
    assert _read("syncs.infer", ctx) == 0.0
    assert _read("sync_wait_ms.infer", ctx) == 0.0
    assert _read("map_build_ms.infer", ctx) == pytest.approx(100.0)


def test_optimizer_ms_reads_the_optimizer_phase():
    ctx = _ctx(STEP + [("wcn.train_step.optimizer", 0.7, 0.2), ("wcn.train_step.optimizer", 2.7, 0.1)])
    assert _read("optimizer_ms.train", ctx) == pytest.approx(150.0)
    assert _read("optimizer_ms.train", _ctx(STEP + [("wcn.train_step", 0.1, 0.8)])) is None


def test_no_item_gives_none():
    assert _read("syncs.train", _ctx([("wcn.sync.x", 0.0, 0.1)])) is None


def test_k2_tile_waste_reads_the_programs_counters(monkeypatch):
    ctx = _ctx(STEP)
    monkeypatch.delitem(sys.modules, "warpconvnet_tpu_torch.tracing", raising=False)
    assert _read("k2_tile_waste.train", ctx) is None  # a program without the registry
    fake = types.SimpleNamespace(counters=lambda: {"k2.fwd_tile_work": 640, "k2.fwd_pairs": 320})
    monkeypatch.setitem(sys.modules, "warpconvnet_tpu_torch.tracing", fake)
    assert _read("k2_tile_waste.infer", ctx) == pytest.approx(2.0)
    fake.counters = lambda: {"k2.fwd_tile_work": 0, "k2.fwd_pairs": 0}  # no K2 in the slice
    assert _read("k2_tile_waste.train", ctx) is None
