"""The port's spans and counters (``warpconvnet_tpu_torch/tracing.py``) on
the CPU: no ``record_function`` is entered without a profiler; under
``torch.profiler`` a small MinkUNet train step and a small Volt forward
give the documented ``wcn.*`` names, nested as documented; the counter
registry's add, read and reset; the span stack that exists only while
recording. Imports no JAX."""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.models.mink_unet import MinkUNetBase
from warpconvnet_tpu_torch.models.volt import build_volt
from warpconvnet_tpu_torch.ops.keys import PAD_COORD
from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

CLASSES = 4


def _voxels(seed=0, b=2, n=256, grid=12, c=3):
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = np.zeros((b, n, c), np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, grid, size=(n - 40 * i, 3)), axis=0)
        nv[i] = len(u)
        coords[i, : len(u)] = u
        feats[i, : len(u)] = rng.standard_normal((len(u), c))
    return Voxels.create(coords, feats, nv, device="cpu").lex_sort()


def _minkunet():
    return MinkUNetBase(3, CLASSES, planes=(8,) * 8, layers=(1,) * 8, init_dim=8, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def _volt():
    return build_volt("volt-s", 3, CLASSES, dim=16, num_heads=2, depth=1, stem_dim=8,
                      device="cpu", generator=torch.Generator().manual_seed(1))


def _train_step(vox):
    model = _minkunet()
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                        CLASSES)
    labels = torch.randint(0, CLASSES, vox.coords.shape[:2], generator=torch.Generator().manual_seed(2))
    return step(vox, labels)


def _spans(prof):
    """{name: [names of the enclosing wcn.* spans, innermost first]} of
    every wcn.* span the profiler recorded (one entry a name: the
    ancestors of its first occurrence)."""
    out = {}
    for e in prof.events():
        if not e.name.startswith("wcn.") or e.name in out:
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("wcn."):
                chain.append(p.name)
            p = p.cpu_parent
        out[e.name] = chain
    return out


def _one(spans, prefix):
    hits = [n for n in spans if n.startswith(prefix)]
    assert hits, (prefix, sorted(spans))
    return hits


@pytest.fixture(autouse=True)
def _fp32():
    constants.set_compute_dtype(None)
    yield
    constants.set_compute_dtype(None)


def test_span_enters_no_record_function_without_a_profiler():
    vox = _voxels()
    with mock.patch.object(torch.profiler, "record_function", wraps=torch.profiler.record_function) as rf:
        out = _train_step(vox)
        _volt()(vox)
        with tracing.span("wcn.test", lambda: pytest.fail("detail formatted")):
            pass
    assert rf.call_count == 0
    assert torch.isfinite(out["loss"])
    assert tracing.span("a") is tracing.span("b")  # the shared no-op context
    assert not tracing.is_recording() and tracing.open_spans() == ()


def test_span_enters_record_function_while_recording():
    with mock.patch.object(torch.profiler, "record_function", wraps=torch.profiler.record_function) as rf:
        with tracing.recording():
            with tracing.span("wcn.outer"), tracing.span("wcn.inner", lambda: "1 2"):
                assert tracing.open_spans() == ("wcn.outer", "wcn.inner[1 2]")
        assert tracing.open_spans() == ()
    assert [c.args[0] for c in rf.call_args_list] == ["wcn.outer", "wcn.inner[1 2]"]


def test_train_step_spans_nest_as_documented():
    vox = _voxels()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_step(vox)
    spans = _spans(prof)
    assert spans["wcn.train_step"] == []
    for phase in ("forward", "loss", "backward", "optimizer"):
        assert spans[f"wcn.train_step.{phase}"] == ["wcn.train_step"]
    assert spans["wcn.model.minkunet"] == ["wcn.train_step.forward", "wcn.train_step"]
    for name in ("generate_output_coords_and_kernel_map", "build_batched_pair_table",
                 "build_pair_tables_batched", "with_orders", "row_order",
                 "parity_strided_unique", "parity_pair_tables_from_unique"):
        assert "wcn.model.minkunet" in spans[f"wcn.map.{name}"], name
    assert spans["wcn.map.build_pair_tables_batched"][0] == "wcn.map.build_batched_pair_table"
    # The parity builders copy no host data to the card, and on CPU tensors
    # K1 builds no descriptor: the step opens no sync span at all.
    assert [n for n in spans if n.startswith("wcn.sync.")] == []
    fwd = _one(spans, "wcn.conv.fwd[")
    assert all(spans[n][0] == "wcn.model.minkunet" for n in fwd)
    assert {n.split("[")[1].split()[0] for n in fwd} == {"sub", "down", "up"}
    assert "wcn.conv.fwd[down 2 256->128 8->8 8 2 float32]" in fwd
    bwd = _one(spans, "wcn.conv.bwd[")
    assert all(spans[n][-1] == "wcn.train_step" and "wcn.train_step.backward" in spans[n]
               for n in bwd)


def test_volt_forward_spans_nest_as_documented():
    vox = _voxels(3)
    model = _volt()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(vox)
    spans = _spans(prof)
    assert spans["wcn.model.volt"] == []
    attn = _one(spans, "wcn.attn.fwd[")
    assert attn == [n for n in attn if n.endswith(" 2 8 float32]")]  # B S H D dtype
    assert all(spans[n] == ["wcn.model.volt"] for n in attn)
    for name in ("generate_output_coords_and_kernel_map", "unpool_parents",
                 "parity_strided_unique"):
        assert spans[f"wcn.map.{name}"][-1] == "wcn.model.volt", name
    assert all(spans[n] == ["wcn.model.volt"] for n in _one(spans, "wcn.conv.fwd[sub "))


def test_attention_backward_runs_in_its_span():
    vox = _voxels(4)
    model = _volt()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(vox).features.square().sum().backward()
    spans = _spans(prof)
    assert _one(spans, "wcn.attn.bwd[")
    assert _one(spans, "wcn.conv.bwd[sub ")


def test_host_counters_add_read_and_reset():
    tracing.reset_counters()
    tracing.add("test.a")
    tracing.add("test.a", 4)
    tracing.add("test.b", 2)
    got = tracing.counters()
    assert got["test.a"] == 5 and got["test.b"] == 2
    assert all(got[k] == 0 for k in tracing.DEVICE_KEYS)
    tracing.reset_counters()
    assert "test.a" not in tracing.counters()


def test_device_counters_count_only_while_recording():
    tracing.reset_counters()
    cpu = torch.device("cpu")
    assert tracing.counter_ptr(cpu, "k2.fwd_tile_work") is None
    tracing.device_add("k2.fwd_pairs", lambda: pytest.fail("computed while not recording"))
    with tracing.recording():
        assert tracing.is_recording()
        ptr = tracing.counter_ptr(cpu, "k1.tiles")
        assert isinstance(ptr, int) and ptr != 0
        # K1's and K4's kernels add to their slot and to the next one.
        assert tracing.counter_ptr(cpu, "k1.wide_tiles") == ptr + 8
        assert tracing.counter_ptr(cpu, "k4.dw_floats") == tracing.counter_ptr(cpu, "k4.tile_work") + 8
        tracing.device_add("k2.fwd_pairs", lambda: torch.tensor(7))
        tracing.device_add("k2.fwd_pairs", lambda: torch.count_nonzero(torch.tensor([-1, 0, 3]) >= 0))
    assert not tracing.is_recording()
    got = tracing.counters(cpu)
    assert got["k2.fwd_pairs"] == 9 and got["k1.tiles"] == 0
    assert tracing.counters()["k2.fwd_pairs"] == 9  # summed over devices
    tracing.reset_counters()
    assert tracing.counters(cpu)["k2.fwd_pairs"] == 0


def test_cpu_paths_count_no_launch():
    tracing.reset_counters()
    _train_step(_voxels(5))
    assert not [k for k in tracing.counters() if k.startswith("launches.")]


def test_spanned_keeps_the_function():
    @tracing.spanned("wcn.test.fn")
    def fn(a, b=2):
        """doc"""
        return tracing.open_spans(), a + b

    assert fn.__name__ == "fn" and fn.__doc__ == "doc"
    assert fn(1) == ((), 3)
    with tracing.recording():
        assert fn(1, b=5) == (("wcn.test.fn",), 6)
