"""CUDA kernels K1, K2 (forward and dgrad), K3, K4, K6 (forward and dgrad),
K7, K8, K9 and its backward K9-dkv / K9-dq against their plain versions,
and the conv and ConvNeXt-block backward, an Attention backward, a small
Volt forward and a small Volt train step on CUDA against the CPU plain
route, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90) and skip elsewhere. They
import no JAX, so on a machine without it run them with the repository's
conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import depthwise_fma, implicit_gemm, sorted_search
from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.models.mink_unet import MinkUNetBase
from warpconvnet_tpu_torch.models.volt import build_volt
from warpconvnet_tpu_torch.nn.modules.blocks import SparseConvNeXtBlock
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    generate_output_coords_and_kernel_map,
    spatially_sparse_conv,
)
from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step
from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets
from warpconvnet_tpu_torch.ops.keys import PAD_COORD, coord_keys
from warpconvnet_tpu_torch.utils.scenes import make_surface_scene

pytestmark = pytest.mark.gpu

# fp32: the kernel and the plain version sum the same products in another
# order. bf16: outputs are rounded once from fp32, so they may differ by one
# bf16 ulp (2^-8 relative).
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# dw (fp32 out) sums products over all rows with fp32 atomics in a varying
# order; bf16 inputs make exact fp32 products, so both dtypes share it.
DW_TOL = dict(rtol=1e-4, atol=1e-4)


def launches(fn) -> int:
    """Launches of the kernel wrapper ``fn`` counted since the registry's
    last reset (``tracing`` host counter ``launches.<wrapper>``)."""
    return tracing.counters().get(f"launches.{fn.__name__}", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _voxels(seed, device, b=2, n=2048, grid=24, c=8, lo=0):
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = np.zeros((b, n, c), np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(lo, grid, size=(n - 300 * i, 3)), axis=0)
        u = u[rng.permutation(len(u))]
        nv[i] = len(u)
        coords[i, : len(u)] = u
        feats[i, : len(u)] = rng.standard_normal((len(u), c))
    return Voxels.create(coords, feats, nv, device=device)


def _probe_args(vox, out, offsets, stride):
    keys = coord_keys(torch.where(vox.valid_mask()[..., None], vox.coords, PAD_COORD))
    return keys, vox.num_valid, out.coords, out.num_valid, offsets, stride


@pytest.mark.parametrize("ks,stride", [(3, 1), (5, 1), (3, 2)])
def test_k1_matches_plain(cuda, ks, stride):
    vox = _voxels(ks, cuda, lo=-12).lex_sort()
    out = vox if stride == 1 else _voxels(7, cuda, n=600, grid=12, lo=-6).lex_sort()
    args = _probe_args(vox, out, kernel_offsets(ks), (stride,) * 3)
    before = launches(sorted_search.kernel_map_probe)
    got = sorted_search.kernel_map_probe(*args)
    ref = sorted_search.kernel_map_probe_plain(*args)
    torch.cuda.synchronize()
    assert launches(sorted_search.kernel_map_probe) == before + 1
    assert torch.equal(got, ref)
    assert int((got >= 0).sum()) > 0


def test_k1_range_edge_matches_plain(cuda):
    top = PAD_COORD - 1
    c = np.array(
        [[5, top - 1, 7], [5, top, 7], [6, -top, 7], [6, -top + 1, 7],
         [2, 3, top], [2, 4, -top], [2, 3, top - 1], [1, -top, -top]],
        np.int32,
    )
    c = c[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))]
    coords = np.full((1, 16, 3), PAD_COORD, np.int32)
    coords[0, : len(c)] = c
    vox = Voxels.create(coords, np.zeros((1, 16, 1), np.float32), [len(c)], device=cuda)
    args = _probe_args(vox, vox, kernel_offsets(5), (1, 1, 1))
    assert torch.equal(
        sorted_search.kernel_map_probe(*args), sorted_search.kernel_map_probe_plain(*args)
    )


CROSS = np.array([[1, 0, 0], [0, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0], [0, 1, 0],
                  [0, 0, -1]], np.int32)


def _scene_voxels(scenes, n, device):
    """Lex-sorted voxels of the given [n_i, 3] scenes, padded to n rows."""
    coords = np.full((len(scenes), n, 3), PAD_COORD, np.int32)
    for i, c in enumerate(scenes):
        coords[i, : len(c)] = c
    nv = [len(c) for c in scenes]
    return Voxels.create(coords, np.zeros((len(scenes), n, 1), np.float32), nv,
                         device=device).lex_sort()


def _probe_once(args):
    """K1 against its plain version on ``args``: asserts one launch and equal
    tables; returns (tiles, tiles walked in device memory) of that launch."""
    tracing.reset_counters()
    before = launches(sorted_search.kernel_map_probe)
    with tracing.recording():
        got = sorted_search.kernel_map_probe(*args)
    ref = sorted_search.kernel_map_probe_plain(*args)
    torch.cuda.synchronize()
    assert launches(sorted_search.kernel_map_probe) == before + 1
    assert torch.equal(got, ref)
    assert int((got >= 0).sum()) > 0
    counts = tracing.counters(args[0].device)
    return counts["k1.tiles"], counts["k1.wide_tiles"]


def _bench_scene(cuda):
    return _scene_voxels([make_surface_scene(np.random.default_rng(0), 1 << 17)], 1 << 17, cuda)


def test_k1_7cubed_surface_scene_stays_in_shared_memory(cuda):
    vox = _bench_scene(cuda)
    tiles, wide = _probe_once(_probe_args(vox, vox, kernel_offsets(7), (1, 1, 1)))
    assert tiles > 0 and wide == 0


def test_k1_unsorted_output_rows_take_the_device_memory_walk(cuda):
    vox = _bench_scene(cuda)
    nv = int(vox.num_valid[0])
    perm = torch.randperm(nv, generator=torch.Generator().manual_seed(0)).to(cuda)
    out = vox.replace(coords=torch.cat([vox.coords[:, perm], vox.coords[:, nv:]], 1))
    tiles, wide = _probe_once(_probe_args(vox, out, kernel_offsets(7), (1, 1, 1)))
    assert 0 < wide <= tiles


def test_k1_two_scenes_with_tiles_across_pad_rows(cuda):
    rng = np.random.default_rng(3)
    scenes = [make_surface_scene(rng, 20_000, coord_range=160, n_points=25_000)[:nv]
              for nv in (7_777, 5_003)]
    vox = _scene_voxels(scenes, 8_200, cuda)
    assert vox.num_valid.tolist() == [7_777, 5_003]
    tiles, wide = _probe_once(_probe_args(vox, vox, kernel_offsets(3), (1, 1, 1)))
    assert tiles >= 2 and wide == 0


@pytest.mark.parametrize("case", ["3^3 stride 2", "cross"])
def test_k1_strided_map_and_cross(cuda, case):
    fine = make_surface_scene(np.random.default_rng(5), 30_000, coord_range=256,
                              n_points=30_000)
    vox = _scene_voxels([fine], 30_000, cuda)
    if case == "cross":
        args = _probe_args(vox, vox, CROSS, (1, 1, 1))
    else:
        coarse = np.unique(fine // 2, axis=0)
        args = _probe_args(vox, _scene_voxels([coarse], len(coarse) + 100, cuda),
                           kernel_offsets(3), (2, 2, 2))
    tiles, wide = _probe_once(args)
    assert tiles > 0 and wide == 0


def test_k1_dense_plane_wider_than_shared_memory(cuda):
    # 96 x 96 = 9216 keys a plane, over twice the 4096 keys a block stages.
    side = 96
    g = np.stack(np.meshgrid(np.arange(3), np.arange(side), np.arange(side), indexing="ij"), -1)
    cube = g.reshape(-1, 3).astype(np.int32) - np.array([1, side // 2, side // 2], np.int32)
    vox = _scene_voxels([cube], len(cube) + 37, cuda)
    tiles, wide = _probe_once(_probe_args(vox, vox, kernel_offsets(3), (1, 1, 1)))
    assert wide == tiles > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(12, 20), (32, 32), (192, 96), (384, 256)])
def test_k2_matches_plain(cuda, dtype, c_in, c_out):
    vox = _voxels(0, cuda, c=c_in).lex_sort()
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    _, _, down, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    coarse = torch.randn((2, down.table.shape[2], c_in), generator=gen, device=cuda)
    for x, table in ((vox.features, sub.table), (vox.features, down.table),
                     (coarse, down.reversed().table)):
        k = table.shape[1]
        w = torch.randn((k, c_in, c_out), generator=gen, device=cuda) / (k * c_in) ** 0.5
        x, w = x.to(dtype).contiguous(), w.to(dtype)
        before = launches(implicit_gemm.implicit_gemm_fwd)
        got = implicit_gemm.implicit_gemm_fwd(x, w, table)
        ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, table)
        torch.cuda.synchronize()
        assert launches(implicit_gemm.implicit_gemm_fwd) == before + 1
        assert got.dtype == dtype and got.shape == (2, table.shape[2], c_out)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


def test_k2_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 4, device=cuda)
    w = torch.zeros(27, 4, 4, device=cuda)
    t = torch.zeros(1, 27, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_fwd(x.half(), w.half(), t)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_fwd(x, w, t.long())
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_fwd(torch.zeros(1, 4, 8, device=cuda).transpose(1, 2), w, t)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_fwd(x, w, t, accum_dtype=torch.bfloat16)


def test_small_unet_kernel_path_matches_cpu_plain_path(cuda):
    """fp32 forward: CUDA kernels on the card against the plain versions on
    the CPU, same weights and inputs."""
    model = MinkUNetBase(
        3, 5, planes=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8, init_dim=8,
        device="cpu", generator=torch.Generator().manual_seed(0),
    ).eval()
    vox = _voxels(3, "cpu", n=1024, c=3)
    with torch.inference_mode():
        ref = model(vox.lex_sort()).features
        k1, k2 = launches(sorted_search.kernel_map_probe), launches(implicit_gemm.implicit_gemm_fwd)
        got = model.to(cuda)(vox.to(cuda).lex_sort()).features.cpu()
    assert launches(sorted_search.kernel_map_probe) - k1 == 5
    assert launches(implicit_gemm.implicit_gemm_fwd) - k2 == 2 * 8 + 8  # 1 block a stage
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _bwd_cases(cuda, c_in, c_out, dtype):
    """(name, x, g, map) on the three table kinds, with one offset of the
    self-map emptied so that K4 skips it everywhere; g is scaled as a mean
    loss's gradient would be."""
    vox = _voxels(0, cuda, c=c_in).lex_sort()
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    sub = sub._replace(table=sub.table.clone())
    sub.table[:, 4] = -1
    sub = sub._replace(table=sub.table.contiguous())
    _, _, down, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2)
    gen = torch.Generator(device=cuda).manual_seed(1)
    coarse = torch.randn((2, down.table.shape[2], c_in), generator=gen, device=cuda)
    cases = []
    for name, x, bpt in (("submanifold", vox.features, sub), ("strided", vox.features, down),
                         ("transposed", coarse, down.reversed())):
        n_out = bpt.table.shape[2]
        g = torch.randn((2, n_out, c_out), generator=gen, device=cuda) / n_out ** 0.5
        cases.append((name, x.to(dtype).contiguous(), g.to(dtype), bpt))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(12, 20), (32, 32), (128, 96), (96, 96), (384, 256)])
def test_k2_dgrad_and_k3_match_plain(cuda, dtype, c_in, c_out):
    """On the three map kinds; K3 also with the floats its blocks add into
    dw (its own count) equal to the host model at its plan's chunk rows,
    and exact zeros for the self-map's emptied offset."""
    for name, x, g, bpt in _bwd_cases(cuda, c_in, c_out, dtype):
        k = bpt.table.shape[1]
        w = (torch.randn((k, c_in, c_out), device=cuda) / (k * c_in) ** 0.5).to(dtype)
        tracing.reset_counters()
        dx = implicit_gemm.implicit_gemm_dgrad(g, w, bpt.rev)
        with tracing.recording():
            dw = implicit_gemm.implicit_gemm_wgrad(x, g, bpt.table)
        floats = tracing.counters(cuda)["k3.dw_floats"]
        plan = implicit_gemm.implicit_gemm_wgrad.plan
        ref_dx = implicit_gemm.implicit_gemm_dgrad_plain(g, w, bpt.rev)
        ref_dw = implicit_gemm.implicit_gemm_wgrad_plain(x, g, bpt.table)
        torch.cuda.synchronize()
        assert (launches(implicit_gemm.implicit_gemm_fwd),
                launches(implicit_gemm.implicit_gemm_dgrad),
                launches(implicit_gemm.implicit_gemm_wgrad)) == (0, 1, 1), name
        assert dx.dtype == dtype and dx.shape == x.shape, name
        assert dw.dtype == torch.float32 and dw.shape == (k, c_in, c_out), name
        torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype], msg=name)
        torch.testing.assert_close(dw, ref_dw, **DW_TOL, msg=name)
        unreached = (bpt.rev < 0).all(dim=1)
        assert bool((dx[unreached] == 0).all()), name
        assert floats == implicit_gemm.bwd_fused_dw_atomics(
            bpt.table, c_in, c_out, plan["chunk_rows"]) > 0, name
        if name == "submanifold":
            assert bool((dw[4] == 0).all()), name  # the emptied offset adds exactly zero


def _small_down_map(cuda, c, dtype):
    """A 2^3 stride-2 map of two scenes of a few hundred voxels, 700 fine
    rows to 600 coarse ones (neither a multiple of 256), with the features
    of both sides."""
    vox = _voxels(5, cuda, n=700, c=c).lex_sort()
    _, _, down, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2, out_capacity=600)
    gen = torch.Generator(device=cuda).manual_seed(9)
    coarse = torch.randn((2, down.table.shape[2], c), generator=gen, device=cuda)
    return [("strided", vox.features.to(dtype).contiguous(), down),
            ("transposed", coarse.to(dtype), down.reversed())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [20, 96])
def test_k3_and_k7_on_a_small_map_take_the_shortest_chunks(cuda, dtype, c):
    """A map of a few hundred rows: K3 halves its chunks down to the
    shortest (256 rows, a ragged last one) to give the card blocks; K3 and
    K7 match their plain versions and count what the host models count."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    for name, x, bpt in _small_down_map(cuda, c, dtype):
        n_out = bpt.table.shape[2]
        assert 256 < n_out < 1024 and n_out % 256 != 0, name
        g = (torch.randn((2, n_out, c), generator=gen, device=cuda) / n_out ** 0.5).to(dtype)
        tracing.reset_counters()
        with tracing.recording():
            dw3 = implicit_gemm.implicit_gemm_wgrad(x, g, bpt.table)
            dw7 = depthwise_fma.depthwise_fma_wgrad(x, g, bpt.table)
        plan3, plan7 = implicit_gemm.implicit_gemm_wgrad.plan, depthwise_fma.depthwise_fma_wgrad.plan
        counts = tracing.counters(cuda)
        floats3, floats7 = counts["k3.dw_floats"], counts["k7.dw_floats"]
        torch.cuda.synchronize()
        torch.testing.assert_close(dw3, implicit_gemm.implicit_gemm_wgrad_plain(x, g, bpt.table),
                                   **DW_TOL, msg=name)
        torch.testing.assert_close(dw7, depthwise_fma.depthwise_fma_wgrad_plain(x, g, bpt.table),
                                   **DW_TOL, msg=name)
        assert plan3["chunk_rows"] == 256, name
        assert floats3 == implicit_gemm.bwd_fused_dw_atomics(bpt.table, c, c, 256) > 0, name
        assert floats7 == depthwise_fma.bwd_fused_dw_adds(bpt.table, c,
                                                          plan7["chunk_rows"]) > 0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(12, 20), (32, 32), (128, 96), (96, 96), (384, 256)])
def test_k4_matches_plain_and_the_split_pair(cuda, dtype, c_in, c_out):
    name, x, g, bpt = _bwd_cases(cuda, c_in, c_out, dtype)[0]
    w = (torch.randn((27, c_in, c_out), device=cuda) / (27 * c_in) ** 0.5).to(dtype)
    before = launches(implicit_gemm.implicit_gemm_bwd_fused)
    dx, dw = implicit_gemm.implicit_gemm_bwd_fused(x, g, w, bpt.table, bpt.offsets)
    ref_dx, ref_dw = implicit_gemm.implicit_gemm_bwd_fused_plain(x, g, w, bpt.table, bpt.offsets)
    split_dx = implicit_gemm.implicit_gemm_dgrad(g, w, bpt.table.flip(1).contiguous())
    split_dw = implicit_gemm.implicit_gemm_wgrad(x, g, bpt.table)
    torch.cuda.synchronize()
    assert launches(implicit_gemm.implicit_gemm_bwd_fused) == before + 1
    assert dx.dtype == dtype and dw.dtype == torch.float32
    for rdx, rdw in ((ref_dx, ref_dw), (split_dx, split_dw)):
        torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
        torch.testing.assert_close(dw, rdw, **DW_TOL)
    assert bool((dw[4] == 0).all())  # the emptied offset adds exactly zero
    pad = (bpt.table < 0).all(dim=1)
    assert bool(pad.any()) and bool((dx[pad] == 0).all())


def test_k4_and_k3_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    vox = _voxels(0, cuda, c=8).lex_sort()
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    x, g, w = vox.features, vox.features.clone(), torch.zeros(27, 8, 8, device=cuda)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_bwd_fused(x.half(), g.half(), w.half(), sub.table, sub.offsets)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_bwd_fused(x, g, w.to(torch.bfloat16), sub.table, sub.offsets)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_bwd_fused(x[:, :-1], g[:, :-1], w, sub.table, sub.offsets)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_wgrad(x, g, sub.table.long())
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_wgrad(x, g[:, :, :4].contiguous().transpose(1, 2), sub.table)
    with pytest.raises(ValueError):
        implicit_gemm.implicit_gemm_wgrad(x, g, sub.table, accum_dtype=torch.bfloat16)


@pytest.mark.parametrize("kind", ["submanifold", "strided"])
def test_conv_backward_on_cuda_matches_cpu_plain_route(cuda, kind):
    """fp32 grads of features and weight through ConvGemm: kernels on the
    card (K4, or K2-dgrad and K3) against the plain versions on the CPU."""
    vox = _voxels(5, "cpu", c=16).lex_sort()
    ks, st = (3, 1) if kind == "submanifold" else (2, 2)
    w0 = torch.randn((ks ** 3, 16, 24), generator=torch.Generator().manual_seed(0)) / 12
    r = None
    grads = []
    for dev in ("cpu", cuda):
        v = vox.to(dev)
        x = v.features.clone().requires_grad_(True)
        w = w0.to(dev).detach().requires_grad_(True)
        out, _ = spatially_sparse_conv(v.replace(features=x), w, ks, stride=st)
        if r is None:
            r = torch.randn(out.features.shape, generator=torch.Generator().manual_seed(1))
        (out.features * r.to(dev)).sum().backward()
        grads.append((x.grad.cpu(), w.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-4, atol=1e-4)


def test_small_unet_train_step_on_cuda_gives_every_parameter_a_grad(cuda):
    """On CUDA every parameter gets a finite gradient (a conv whose output
    lost its grad_fn would leave its weight's grad None), with 5 K1, 24 K2
    forward, 8 K2-dgrad, 8 K3 and 16 K4 launches, and the loss and the
    gradients agree with the CPU plain route."""
    kw = dict(planes=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8, init_dim=8)
    vox = _voxels(3, "cpu", n=1024, c=3).lex_sort()
    labels = torch.randint(0, 5, vox.coords.shape[:2], generator=torch.Generator().manual_seed(0))
    results = []
    for dev in ("cpu", cuda):
        model = MinkUNetBase(3, 5, device=dev, generator=torch.Generator().manual_seed(0), **kw)
        step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), 1e-3), 5)
        counts = [launches(f) for f in (sorted_search.kernel_map_probe,
                                       implicit_gemm.implicit_gemm_fwd,
                                       implicit_gemm.implicit_gemm_dgrad,
                                       implicit_gemm.implicit_gemm_wgrad,
                                       implicit_gemm.implicit_gemm_bwd_fused)]
        loss = float(step(vox.to(dev), labels.to(dev))["loss"])
        after = [launches(f) for f in (sorted_search.kernel_map_probe,
                                      implicit_gemm.implicit_gemm_fwd,
                                      implicit_gemm.implicit_gemm_dgrad,
                                      implicit_gemm.implicit_gemm_wgrad,
                                      implicit_gemm.implicit_gemm_bwd_fused)]
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
        results.append((loss, {n: g.cpu() for n, g in grads.items()},
                        [a - b for a, b in zip(after, counts)]))
    assert results[0][2] == [0] * 5  # CPU: plain versions only
    assert results[1][2] == [5, 24, 8, 8, 16]
    assert abs(results[1][0] - results[0][0]) <= 1e-5 * abs(results[0][0])
    for n, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][n], g, rtol=1e-3, atol=1e-4 * float(g.abs().max()))


def _depth_maps(cuda, c, dtype):
    """Features and the maps the depthwise path uses: 3^3 and 7^3 (K=343)
    self-maps, each with the offsets 1 and K-2 (a pair, so the map stays
    symmetric) emptied to all -1 rows, and the 2^3 parity map."""
    vox = _voxels(0, cuda, c=c).lex_sort()
    maps = {}
    for ks in (3, 7):
        _, _, sub, _ = generate_output_coords_and_kernel_map(vox, ks)
        table = sub.table.clone()
        table[:, [1, ks ** 3 - 2]] = -1
        maps[f"{ks}^3"] = sub._replace(table=table, rev=table.flip(1).contiguous())
    _, _, maps["2^3"], _ = generate_output_coords_and_kernel_map(vox, 2, stride=2)
    return vox.features.to(dtype).contiguous(), maps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 12, 96, 100])
def test_k6_forward_and_dgrad_match_plain(cuda, dtype, c):
    x, maps = _depth_maps(cuda, c, dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for name, bpt in maps.items():
        k, n_out = bpt.table.shape[1], bpt.table.shape[2]
        w = torch.randn((k, c), generator=gen, device=cuda) / k ** 0.5
        g = torch.randn((2, n_out, c), generator=gen, device=cuda).to(dtype)
        fwd, dg = launches(depthwise_fma.depthwise_fma_fwd), launches(depthwise_fma.depthwise_fma_dgrad)
        out = depthwise_fma.depthwise_fma_fwd(x, w, bpt.table)
        dx = depthwise_fma.depthwise_fma_dgrad(g, w, bpt.rev)
        ref = depthwise_fma.depthwise_fma_fwd_plain(x, w, bpt.table)
        ref_dx = depthwise_fma.depthwise_fma_dgrad_plain(g, w, bpt.rev)
        torch.cuda.synchronize()
        assert (launches(depthwise_fma.depthwise_fma_fwd),
                launches(depthwise_fma.depthwise_fma_dgrad)) == (fwd + 1, dg + 1), name
        assert out.dtype == dx.dtype == dtype and out.shape == (2, n_out, c), name
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype], msg=name)
        torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype], msg=name)
        empty = (bpt.table < 0).all(dim=1)
        assert bool(empty.any()) and bool((out[empty] == 0).all()), name
    # A table with no valid entry at all: exact zeros.
    none = torch.full_like(maps["3^3"].table, -1)
    assert bool((depthwise_fma.depthwise_fma_fwd(x, torch.ones(27, c, device=cuda), none) == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 12, 96, 100])
def test_k7_matches_plain(cuda, dtype, c):
    x, maps = _depth_maps(cuda, c, dtype)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for name, bpt in maps.items():
        n_out = bpt.table.shape[2]
        g = (torch.randn((2, n_out, c), generator=gen, device=cuda) / n_out ** 0.5).to(dtype)
        tracing.reset_counters()
        before = launches(depthwise_fma.depthwise_fma_wgrad)
        with tracing.recording():
            dw = depthwise_fma.depthwise_fma_wgrad(x, g, bpt.table)
        adds = tracing.counters(cuda)["k7.dw_floats"]
        plan = depthwise_fma.depthwise_fma_wgrad.plan
        ref = depthwise_fma.depthwise_fma_wgrad_plain(x, g, bpt.table)
        torch.cuda.synchronize()
        assert launches(depthwise_fma.depthwise_fma_wgrad) == before + 1, name
        assert dw.dtype == torch.float32 and dw.shape == (bpt.table.shape[1], c), name
        torch.testing.assert_close(dw, ref, **DW_TOL, msg=name)
        assert adds == depthwise_fma.bwd_fused_dw_adds(bpt.table, c, plan["chunk_rows"]) > 0, name
        if name != "2^3":
            assert bool((dw[1] == 0).all()), name  # the emptied offset adds exactly zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [20, 96, 384])
def test_k7_on_the_conv_maps_matches_plain_and_counts_its_adds(cuda, dtype, c):
    """K7 on the dense conv backward's three map kinds (a self-map with an
    emptied offset, a strided map and its reverse, whose x and g have their
    own row counts), with the floats its blocks add into dw (its own
    count) equal to the host model at its plan's chunk rows."""
    for name, x, g, bpt in _bwd_cases(cuda, c, c, dtype):
        tracing.reset_counters()
        with tracing.recording():
            dw = depthwise_fma.depthwise_fma_wgrad(x, g, bpt.table)
        adds = tracing.counters(cuda)["k7.dw_floats"]
        plan = depthwise_fma.depthwise_fma_wgrad.plan
        ref = depthwise_fma.depthwise_fma_wgrad_plain(x, g, bpt.table)
        torch.cuda.synchronize()
        torch.testing.assert_close(dw, ref, **DW_TOL, msg=name)
        assert adds == depthwise_fma.bwd_fused_dw_adds(bpt.table, c, plan["chunk_rows"]) > 0, name
        if name == "submanifold":
            assert bool((dw[4] == 0).all()), name  # the emptied offset adds exactly zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 12, 96, 100, 384])
@pytest.mark.parametrize("ks", [3, 7])
def test_k8_matches_plain_and_the_split_pair(cuda, dtype, c, ks):
    x, maps = _depth_maps(cuda, c, dtype)
    bpt = maps[f"{ks}^3"]
    k = ks ** 3
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = (torch.randn(x.shape, generator=gen, device=cuda) / x.shape[1] ** 0.5).to(dtype)
    w = torch.randn((k, c), generator=gen, device=cuda) / k ** 0.5
    before = launches(depthwise_fma.depthwise_fma_bwd_fused)
    dx, dw = depthwise_fma.depthwise_fma_bwd_fused(x, g, w, bpt.table, bpt.offsets)
    ref_dx, ref_dw = depthwise_fma.depthwise_fma_bwd_fused_plain(x, g, w, bpt.table, bpt.offsets)
    split_dx = depthwise_fma.depthwise_fma_dgrad(g, w, bpt.rev)
    split_dw = depthwise_fma.depthwise_fma_wgrad(x, g, bpt.table)
    torch.cuda.synchronize()
    assert launches(depthwise_fma.depthwise_fma_bwd_fused) == before + 1
    assert dx.dtype == dtype and dw.dtype == torch.float32
    for rdx, rdw in ((ref_dx, ref_dw), (split_dx, split_dw)):
        torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
        torch.testing.assert_close(dw, rdw, **DW_TOL)
    assert bool((dw[[1, k - 2]] == 0).all())  # the emptied offsets add exactly zero
    pad = (bpt.table < 0).all(dim=1)
    assert bool(pad.any()) and bool((dx[pad] == 0).all())


def _unaligned(t):
    """``t``'s values in a contiguous tensor whose base is one element past
    a 16-byte boundary: the kernels' element-by-element path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _tile_table(cuda, k, n_in=1000, n_out=1000):
    """A [2, K, n_out] table (1000 or 1001 rows: not a multiple of a tile's
    64 or 128): rows 0-127 of scene 0 have every offset valid, rows 128-255
    none (a tile of -1 rows next to a full one), the rest 30% valid."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    idx = torch.randint(0, n_in, (2, k, n_out), generator=gen, device=cuda, dtype=torch.int32)
    keep = torch.rand((2, k, n_out), generator=gen, device=cuda) < 0.3
    keep[0, :, :128] = True
    keep[0, :, 128:256] = False
    return torch.where(keep, idx, -1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 12, 96, 100, 384, 1024])
@pytest.mark.parametrize("k,n_out", [(27, 1000), (343, 1000), (27, 1001)])
def test_k6_tiles_match_plain_and_give_the_same_bits_twice(cuda, dtype, c, k, n_out):
    """1000 output rows (16-byte table rows, staged by cp.async) and 1001
    (the table staged entry by entry)."""
    table = _tile_table(cuda, k, n_out=n_out)
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, 1000, c), generator=gen, device=cuda).to(dtype)
    w = torch.randn((k, c), generator=gen, device=cuda) / k ** 0.5
    out = depthwise_fma.depthwise_fma_fwd(x, w, table)
    again = depthwise_fma.depthwise_fma_fwd(x, w, table)
    ref = depthwise_fma.depthwise_fma_fwd_plain(x, w, table)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(_bits(out), _bits(again))
    assert bool((out[0, 128:256] == 0).all())  # the tile of -1 rows adds exactly zero
    if c == 96:  # the element-by-element path (unaligned bases) sums in the same order
        assert torch.equal(_bits(depthwise_fma.depthwise_fma_fwd(_unaligned(x), w, table)),
                           _bits(out))


def _cube_map(cuda, ks, c, dtype):
    """A 10^3 cube of voxels in scene 0 (rows with every offset valid) and a
    6^3 cube in scene 1, in 1100 rows (tiles of padding rows only at the
    ends), its ks^3 self-map and features."""
    pts = lambda s: np.stack(np.meshgrid(*[np.arange(s)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coords = np.full((2, 1100, 3), PAD_COORD, np.int32)
    coords[0, :1000], coords[1, :216] = pts(10), pts(6)
    feats = np.random.default_rng(13).standard_normal((2, 1100, c)).astype(np.float32)
    feats[0, 1000:] = feats[1, 216:] = 0
    vox = Voxels.create(coords, feats, np.array([1000, 216], np.int32), device=cuda).lex_sort()
    bpt = generate_output_coords_and_kernel_map(vox, ks)[2]
    assert bool(((bpt.table >= 0).sum(1) == ks ** 3).any())
    return vox.features.to(dtype).contiguous(), bpt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 12, 96, 100, 384, 1024])
@pytest.mark.parametrize("ks", [3, 7])
def test_k8_tiles_match_plain_and_k6_bits_and_count_their_dw_adds(cuda, dtype, c, ks):
    """K8 on rows with every offset valid: dx and dw against the plain
    version, dx with the bits of K6 on (g, w flipped, table) (the previous
    design's order: ascending offsets, fp32 fmaf), and the floats its
    blocks add into dw equal to the host model's."""
    x, bpt = _cube_map(cuda, ks, c, dtype)
    k = ks ** 3
    gen = torch.Generator(device=cuda).manual_seed(14)
    g = (torch.randn(x.shape, generator=gen, device=cuda) / x.shape[1] ** 0.5).to(dtype)
    w = torch.randn((k, c), generator=gen, device=cuda) / k ** 0.5
    tracing.reset_counters()
    with tracing.recording():
        dx, dw = depthwise_fma.depthwise_fma_bwd_fused(x, g, w, bpt.table, bpt.offsets)
    plan = depthwise_fma.depthwise_fma_bwd_fused.plan
    count = tracing.counters(cuda)["k8.dw_floats"]
    ref_dx, ref_dw = depthwise_fma.depthwise_fma_bwd_fused_plain(x, g, w, bpt.table, bpt.offsets)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype])
    torch.testing.assert_close(dw, ref_dw, **DW_TOL)
    k6 = depthwise_fma.depthwise_fma_fwd(g, w.flip(0).contiguous(), bpt.table)
    assert torch.equal(_bits(dx), _bits(k6))
    assert count == depthwise_fma.bwd_fused_dw_adds(bpt.table, c, plan["chunk_rows"]) > 0
    if c == 96:  # the element-by-element path: the same dx bits
        udx, udw = depthwise_fma.depthwise_fma_bwd_fused(_unaligned(x), _unaligned(g), w,
                                                         bpt.table, bpt.offsets)
        assert torch.equal(_bits(udx), _bits(dx))
        torch.testing.assert_close(udw, ref_dw, **DW_TOL)


def test_depthwise_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, maps = _depth_maps(cuda, 8, torch.float32)
    sub, down = maps["3^3"], maps["2^3"]
    w = torch.zeros(27, 8, device=cuda)
    with pytest.raises(ValueError):  # the weight stays fp32
        depthwise_fma.depthwise_fma_fwd(x, w.to(torch.bfloat16), sub.table)
    with pytest.raises(ValueError):
        depthwise_fma.depthwise_fma_fwd(x.half(), w, sub.table)
    with pytest.raises(ValueError):
        depthwise_fma.depthwise_fma_fwd(x, w, sub.table.long())
    with pytest.raises(ValueError):
        depthwise_fma.depthwise_fma_fwd(x, w[:, :4], sub.table)
    with pytest.raises(ValueError):
        wide = torch.zeros(2, 4, 1032, device=cuda)
        depthwise_fma.depthwise_fma_fwd(wide, torch.zeros(27, 1032, device=cuda),
                                        sub.table[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        depthwise_fma.depthwise_fma_wgrad(x, x.transpose(1, 2).contiguous().transpose(1, 2),
                                          sub.table)
    with pytest.raises(ValueError):
        depthwise_fma.depthwise_fma_wgrad(x, x, sub.table, accum_dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # not a self-map
        depthwise_fma.depthwise_fma_bwd_fused(x, x, torch.zeros(8, 8, device=cuda), down.table,
                                              down.offsets)


def test_convnext_block_on_cuda_matches_cpu_plain_route(cuda):
    """fp32 fwd+bwd of sum(out^2): K1, K6 and K8 on the card against the
    plain versions on the CPU, every parameter with a finite gradient."""
    vox = _voxels(6, "cpu", c=16).lex_sort()
    keys = ("kernel_map_probe", "depthwise_fma_fwd", "depthwise_fma_bwd_fused")
    fns = (sorted_search.kernel_map_probe, depthwise_fma.depthwise_fma_fwd,
           depthwise_fma.depthwise_fma_bwd_fused)
    results = []
    for dev in ("cpu", cuda):
        block = SparseConvNeXtBlock(16, 3, layer_scale_init=0.5, device=dev,
                                    generator=torch.Generator().manual_seed(0))
        v = vox.to(dev)
        x = v.features.clone().requires_grad_(True)
        before = [launches(f) for f in fns]
        out = block(v.replace(features=x))
        (out.features ** 2).sum().backward()
        launched = dict(zip(keys, (launches(f) - b for f, b in zip(fns, before))))
        grads = {n: p.grad.cpu() for n, p in block.named_parameters()}
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
        grads["input"] = x.grad.cpu()
        results.append((out.features.detach().cpu(), grads, launched))
    assert results[0][2] == dict.fromkeys(keys, 0)
    assert results[1][2] == dict.fromkeys(keys, 1)
    torch.testing.assert_close(results[1][0], results[0][0], rtol=1e-4, atol=1e-4)
    for n, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][n], g, rtol=1e-3, atol=1e-4 * float(g.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_on_three_input_channels_matches_plain(cuda, dtype):
    """Volt's stem1: a 3^3 conv from 3 channels to 64, the ragged C_in edge
    masked inside one 16- or 32-channel slice."""
    vox = _voxels(8, cuda, c=3).lex_sort()
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    w = (torch.randn((27, 3, 64), generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda) / 9).to(dtype)
    x = vox.features.to(dtype).contiguous()
    got = implicit_gemm.implicit_gemm_fwd(x, w, sub.table)
    ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, sub.table)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


# K9 against its plain version: fp32 sums in another order (online softmax);
# bf16 probabilities rounded before (kernel) or after (plain) normalising.
K9_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _k9_case(cuda, layout, dtype, d, h=2):
    """(q, k, v, seg_q, seg_kv): S = 200 (not a multiple of 64) with the
    last tiles all pad, or cross attention Sq 70 / Skv 300 with separate
    ids and some query rows matching no kv row."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    sq, skv = (70, 300) if layout == "cross" else (200, 200)
    q = torch.randn((2, sq, h, d), generator=gen, device=cuda) * 2
    k = torch.randn((2, skv, h, d), generator=gen, device=cuda)
    v = torch.randn((2, skv, h, d), generator=gen, device=cuda)
    if layout == "global":
        valid = torch.arange(sq, device=cuda)[None] < torch.tensor([[190], [60]], device=cuda)
        seg_q = seg_kv = torch.where(valid, 0, 2_000_000_000).to(torch.int32)
    elif layout == "grouped":
        seg_q = seg_kv = (torch.arange(sq, device=cuda) // 24).to(torch.int32).repeat(2, 1)
    else:
        seg_q = torch.randint(0, 4, (2, sq), generator=gen, device=cuda, dtype=torch.int32)
        seg_q[:, ::9] = 7  # no kv row has segment 7: these rows give 0
        seg_kv = torch.randint(0, 4, (2, skv), generator=gen, device=cuda, dtype=torch.int32)
    return q.to(dtype), k.to(dtype), v.to(dtype), seg_q, seg_kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["global", "grouped", "cross"])
def test_k9_matches_plain(cuda, layout, dtype, d):
    q, k, v, seg_q, seg_kv = _k9_case(cuda, layout, dtype, d)
    before = launches(k9.segment_attention_fwd)
    got = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv)
    ref = k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv)
    torch.cuda.synchronize()
    assert launches(k9.segment_attention_fwd) == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), ref.float(), **K9_TOL[dtype])
    if layout == "cross":
        assert bool((got[:, ::9] == 0).all())


def test_k9_reads_strided_qkv_and_takes_a_scale(cuda):
    """Q, K and V as slices of one [B, S, 3, H, D] projection (a row stride
    of 3 H D) give what contiguous copies give; an explicit scale too."""
    qkv = torch.randn((2, 150, 3, 4, 32), generator=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    seg = (torch.arange(150, device=cuda) < 120).to(torch.int32).expand(2, 150).contiguous()
    q, k, v = (qkv[:, :, i] for i in range(3))
    got = k9.segment_attention_fwd(q, k, v, seg, seg, scale=0.1)
    want = k9.segment_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), seg, seg,
                                    scale=0.1)
    ref = k9.segment_attention_fwd_plain(q, k, v, seg, seg, scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, ref, **K9_TOL[torch.float32])


def test_k9_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, seg_q, seg_kv = _k9_case(cuda, "global", torch.float32, 64)
    with pytest.raises(ValueError, match="head dim"):
        k9.segment_attention_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                 v[..., :48].contiguous(), seg_q, seg_kv)
    with pytest.raises(ValueError, match="share"):
        k9.segment_attention_fwd(q.half(), k.half(), v.half(), seg_q, seg_kv)
    with pytest.raises(ValueError, match="share"):
        k9.segment_attention_fwd(q, k.to(torch.bfloat16), v, seg_q, seg_kv)
    with pytest.raises(ValueError, match="int32"):
        k9.segment_attention_fwd(q, k, v, seg_q.long(), seg_kv)
    with pytest.raises(ValueError, match="contiguous"):  # heads innermost, not D
        k9.segment_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, seg_q,
                                 seg_kv)
    with pytest.raises(ValueError, match="aligned"):  # rows 4 bytes off a 16-byte boundary
        unaligned = torch.zeros(q.numel() + 1, device=cuda)[1:].reshape(q.shape)
        k9.segment_attention_fwd(unaligned, k, v, seg_q, seg_kv)
    with pytest.raises(ValueError, match="disagree"):
        k9.segment_attention_fwd(q, k[:1], v[:1], seg_q, seg_kv[:1])


def test_small_volt_on_cuda_matches_cpu_plain_route(cuda):
    """fp32 forward of a small Volt (dim 32, 2 heads, depth 2): K1, K2 and
    K9 on the card against the plain versions on the CPU."""
    model = build_volt("volt-s", 3, 5, dim=32, num_heads=2, depth=2, stem_dim=8, device="cpu",
                       generator=torch.Generator().manual_seed(0)).eval()
    vox = _voxels(9, "cpu", n=1024, c=3)
    fns = (sorted_search.kernel_map_probe, implicit_gemm.implicit_gemm_fwd,
           k9.segment_attention_fwd)
    with torch.inference_mode():
        ref = model(vox.lex_sort()).features
        before = [launches(f) for f in fns]
        got = model.to(cuda)(vox.to(cuda).lex_sort()).features.cpu()
    assert [launches(f) - b for f, b in zip(fns, before)] == [1, 2, 2]
    assert bool((got[~vox.valid_mask()] == 0).all())
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# K9-dkv / K9-dq against the plain backward (relative Frobenius error of
# each gradient): fp32 sums the same products in another order. bf16: both
# round P and scale * dS to bf16 at the same points (the stock TPU
# kernels'), so only the order of the fp32 sums and exp2 against exp
# differ; where that flips the rounding of one P, dS or gradient entry the
# two differ by one bf16 ulp (2^-8).
K9_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# bf16 K9-dkv / K9-dq against that plain backward, held closer: on an H100
# the kernels read at most 1.43e-4 at the shapes below, a backward that
# left P and dS in fp32 (the plain backward on the same inputs widened to
# fp32, gradients rounded to bf16) 2.59e-3 to 2.92e-3, so this bound tells
# a kernel that rounds where the stock kernels round from one that does not.
K9_BWD_STOCK_TOL = 1.5e-3


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def _k9_bwd_case(cuda, layout, dtype, d):
    """_k9_case's layouts; "empty": self-attention (S 200) whose every
    ninth query row matches no kv row; "uniform": self-attention (S 400) in
    segments of 384 rows, so whole own blocks (192 rows at D <= 64, 64 at
    D 128) and whole visited tiles lie in one segment; "long":
    self-attention over S 8192 rows in one segment, so every gradient row
    sums 8192 pairs. dO is zero on pad query rows."""
    if layout == "long":
        gen = torch.Generator(device=cuda).manual_seed(d)
        q, k, v = (torch.randn((1, 8192, 2, d), generator=gen, device=cuda) for _ in "qkv")
        q, k, v = (q * 2).to(dtype), k.to(dtype), v.to(dtype)
        seg_q = seg_kv = torch.zeros((1, 8192), dtype=torch.int32, device=cuda)
    elif layout == "uniform":
        gen = torch.Generator(device=cuda).manual_seed(d)
        q, k, v = (torch.randn((2, 400, 2, d), generator=gen, device=cuda) for _ in "qkv")
        q = (q * 2).to(dtype)
        k, v = k.to(dtype), v.to(dtype)
        seg_q = seg_kv = (torch.arange(400, device=cuda) // 384).to(torch.int32).repeat(2, 1)
    elif layout != "empty":
        q, k, v, seg_q, seg_kv = _k9_case(cuda, layout, dtype, d)
    else:
        q, k, v, _, _ = _k9_case(cuda, "global", dtype, d)
        gen = torch.Generator(device=cuda).manual_seed(d + 1)
        seg_kv = torch.randint(0, 3, (2, 200), generator=gen, device=cuda, dtype=torch.int32)
        seg_q = seg_kv.clone()
        seg_q[:, ::9] = 5
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    do = torch.where((seg_q == 2_000_000_000)[..., None, None], 0, do).to(dtype)
    return q, k, v, do, seg_q, seg_kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["global", "grouped", "cross", "empty"])
def test_k9_bwd_matches_plain(cuda, layout, dtype, d):
    """K9's lse against the plain forward's, then K9-dkv and K9-dq (one
    launch each) against the plain backward on the kernel's own output and
    lse; rows that match nothing get lse +inf and zero dq."""
    q, k, v, do, seg_q, seg_kv = _k9_bwd_case(cuda, layout, dtype, d)
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    _, ref_lse = k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv, return_lse=True)
    before = (launches(k9.segment_attention_bwd_dkv), launches(k9.segment_attention_bwd_dq))
    got = k9.segment_attention_bwd(q, k, v, out, lse, do, seg_q, seg_kv)
    ref = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg_q, seg_kv)
    torch.cuda.synchronize()
    assert (launches(k9.segment_attention_bwd_dkv), launches(k9.segment_attention_bwd_dq)) == (
        before[0] + 1, before[1] + 1)
    finite = torch.isfinite(ref_lse)
    assert lse.dtype == torch.float32 and torch.equal(torch.isfinite(lse), finite)
    assert bool((lse[~finite] == float("inf")).all())
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=1e-5, atol=1e-5)
    for g, r, x in zip(got, ref, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and g.is_contiguous()
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g, r) <= K9_BWD_TOL[dtype]
    empty = ~finite[:, 0]  # [B, Sq]: rows with no match
    assert layout not in ("cross", "empty") or bool(empty.any())
    assert bool((got[0][empty] == 0).all())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["global", "grouped", "uniform"])
def test_k9_bwd_bf16_rounds_p_and_ds_where_the_stock_kernels_do(cuda, layout, d):
    """bf16 K9-dkv and K9-dq against the plain backward within
    K9_BWD_STOCK_TOL, and the fp32-arithmetic backward outside it. The
    "uniform" layout runs the tile pairs whose rows all share one segment
    (the kernels skip the mask there). Prints the readings (pytest -rP)."""
    q, k, v, do, seg_q, seg_kv = _k9_bwd_case(cuda, layout, torch.bfloat16, d)
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    got = k9.segment_attention_bwd(q, k, v, out, lse, do, seg_q, seg_kv)
    ref = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg_q, seg_kv)
    wide = k9.segment_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                          do.float(), seg_q, seg_kv)
    torch.cuda.synchronize()
    for label, g, r, w in zip(("dq", "dk", "dv"), got, ref, wide):
        err, wide_err = _rel(g, r), _rel(w.to(torch.bfloat16), r)
        print(f"{layout} D {d} {label}: kernel {err:.3e}, fp32 arithmetic {wide_err:.3e}")
        assert err <= K9_BWD_STOCK_TOL < wide_err


# fp32 K9-dkv / K9-dq (3xTF32 on the tensor cores) against a float64 plain
# backward on the same inputs, relative Frobenius error of each gradient.
# On an H100 the kernels read 6.4e-7 to 7.1e-6 (D 16-128, growing with D;
# the layouts below), the IEEE fp32 plain backward 2.8e-7 to 2.3e-6, a
# backward of single TF32 products (tf32_matmul(terms=1)) on the same fp32
# out and lse 6.9e-4 to 1.7e-3. The bound sits 4x above the kernels'
# largest reading and 23x below the 1xTF32 backward's smallest. The "long"
# layout fails kernels whose sums drift over long walks: with the tensor
# cores' accumulators carrying dq, dk and dv over the whole walk, dq read
# 5.5e-5 to 6.1e-5 there (D 16-128), and 1.0e-5 at 1024 rows a segment.
K9_BWD_FP64_TOL = 3e-5


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["global", "grouped", "empty", "uniform", "long"])
def test_k9_bwd_fp32_is_fp32_accurate(cuda, layout, d):
    """fp32 K9-dkv and K9-dq against a float64 plain backward within
    K9_BWD_FP64_TOL, and a 1xTF32 backward outside it. Prints the readings
    of the kernels, the IEEE fp32 plain backward, the plain backward with
    emulated 3xTF32 products and the 1xTF32 backward (pytest -rP)."""
    import functools

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    q, k, v, do, seg_q, seg_kv = _k9_bwd_case(cuda, layout, torch.float32, d)
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    got = k9.segment_attention_bwd(q, k, v, out, lse, do, seg_q, seg_kv)
    x64 = [t.double() for t in (q, k, v)]
    o64, lse64 = k9.segment_attention_fwd_plain(*x64, seg_q, seg_kv, return_lse=True)
    ref = k9.segment_attention_bwd_plain(*x64, o64, lse64, do.double(), seg_q, seg_kv)
    args = (q, k, v, out, lse, do, seg_q, seg_kv)
    fp32 = k9.segment_attention_bwd_plain(*args)
    three = k9.segment_attention_bwd_plain(*args, matmul=k9.tf32_matmul)
    one = k9.segment_attention_bwd_plain(*args, matmul=functools.partial(k9.tf32_matmul, terms=1))
    torch.cuda.synchronize()

    def rel64(x, r):
        return float((x.double() - r).norm() / r.norm())

    for label, g, r, f, e, o in zip(("dq", "dk", "dv"), got, ref, fp32, three, one):
        err, one_err = rel64(g, r), rel64(o, r)
        print(f"{layout} D {d} {label} against float64: kernel {err:.3e}, fp32 plain "
              f"{rel64(f, r):.3e}, 3xTF32 plain {rel64(e, r):.3e}, 1xTF32 plain {one_err:.3e}")
        assert err <= K9_BWD_FP64_TOL < one_err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["global", "grouped", "empty"])
def test_k9_bwd_gives_the_same_bits_twice(cuda, layout, dtype):
    """K9-dkv and K9-dq own their output rows and use no atomics: a second
    run on the same inputs gives the same bits."""
    q, k, v, do, seg_q, seg_kv = _k9_bwd_case(cuda, layout, dtype, 64)
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    first = k9.segment_attention_bwd(q, k, v, out, lse, do, seg_q, seg_kv)
    second = k9.segment_attention_bwd(q, k, v, out, lse, do, seg_q, seg_kv)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# fp32 K9 (3xTF32 on the tensor cores) against a float64 plain forward on
# the same inputs: relative Frobenius error of out, and of lse over the rows
# that match something. On an H100 the kernel read out 2.6e-7 to 3.1e-6
# and lse 6.0e-8 to 5.1e-7 (D 16-128; the layouts below), the IEEE fp32
# plain forward 1.7e-7 to 2.0e-6 and 3.0e-8 to 8.4e-8, a forward of single
# TF32 products (tf32_matmul(terms=1)) 4.8e-4 to 9.1e-4 and 1.2e-5 to
# 9.3e-5. Each bound sits 4x above the kernel's largest reading, out's 40x
# and lse's 6x below the 1xTF32 forward's smallest. A kernel whose tensor
# cores carry out over the whole walk read out 5.2e-5 to 5.8e-5 on the
# "long" layout (D 16-128).
K9_FP64_TOL = {"out": 1.2e-5, "lse": 2e-6}


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["global", "grouped", "empty", "uniform", "long"])
def test_k9_fp32_is_fp32_accurate(cuda, layout, d):
    """fp32 K9's out and lse against a float64 plain forward within
    K9_FP64_TOL, and a forward of single TF32 products outside it. The
    "long" layout (8192 rows in one segment) fails a kernel whose tensor
    cores carry out over the whole walk. Prints the readings of the kernel,
    the IEEE fp32 plain forward, the plain forward with emulated 3xTF32
    products and the 1xTF32 one (pytest -rP)."""
    import functools

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    q, k, v, _, seg_q, seg_kv = _k9_bwd_case(cuda, layout, torch.float32, d)
    got = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    ref = k9.segment_attention_fwd_plain(q.double(), k.double(), v.double(), seg_q, seg_kv,
                                         return_lse=True)
    args = (q, k, v, seg_q, seg_kv)
    fp32 = k9.segment_attention_fwd_plain(*args, return_lse=True)
    three = k9.segment_attention_fwd_plain(*args, return_lse=True, matmul=k9.tf32_matmul)
    one = k9.segment_attention_fwd_plain(*args, return_lse=True,
                                         matmul=functools.partial(k9.tf32_matmul, terms=1))
    torch.cuda.synchronize()
    finite = torch.isfinite(ref[1])
    assert torch.equal(torch.isfinite(got[1]), finite)
    assert bool((got[1][~finite] == float("inf")).all())
    assert bool((got[0].transpose(1, 2)[~finite] == 0).all())

    def rel64(x, r, mask=None):
        x = x.double()
        if mask is not None:
            x, r = x[mask], r[mask]
        return float((x - r).norm() / r.norm())

    for i, label in enumerate(("out", "lse")):
        mask = finite if label == "lse" else None
        err, one_err = rel64(got[i], ref[i], mask), rel64(one[i], ref[i], mask)
        print(f"{layout} D {d} {label} against float64: kernel {err:.3e}, fp32 plain "
              f"{rel64(fp32[i], ref[i], mask):.3e}, 3xTF32 plain "
              f"{rel64(three[i], ref[i], mask):.3e}, 1xTF32 plain {one_err:.3e}")
        assert err <= K9_FP64_TOL[label] < one_err


# bf16 K9 against a plain online forward that walks the kv tiles in the
# kernel's order and rounds the unnormalised P = exp(S - running max) to
# bf16 before P V, as the stock TPU kernel does (relative Frobenius error
# of out): on an H100 the kernel read 0 to 8.0e-5 (D 16-128; global,
# grouped and uniform layouts), and 1.51e-3 to 1.69e-3 against the same
# forward with P kept in fp32. The bound sits 5x above the first and 3.8x
# below the second.
K9_STOCK_TOL = 4e-4


def _online_fwd_plain(q, k, v, seg_q, seg_kv, round_p):
    """The forward as an online softmax over KV_TILE-row kv tiles in order,
    fp32 (bf16 inputs widened): per tile m' = max(m, rowmax S),
    alpha = exp(m - m'), l = alpha l + rowsum P, O = alpha O + P V with
    P = exp(S - m'), rounded to bf16 before P V when ``round_p``; out =
    O / l in q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    b, h, sq, d = qf.shape
    m = torch.full((b, h, sq, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    for j in range(0, kf.shape[2], k9.KV_TILE):
        cols = slice(j, j + k9.KV_TILE)
        pair = (seg_q[:, :, None] == seg_kv[:, None, cols])[:, None]
        s = torch.where(pair, qf @ kf[:, :, cols].transpose(-1, -2) * scale, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(torch.isneginf(m_new), 0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if round_p else p
        o = o * alpha + pv @ vf[:, :, cols]
        m = m_new
    out = torch.where(l > 0, o / l, 0)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", ["global", "grouped", "uniform"])
def test_k9_bf16_rounds_p_where_the_stock_kernel_does(cuda, layout, d):
    """bf16 K9 within K9_STOCK_TOL of the online plain forward that rounds
    P as the stock kernel does, and farther than that from the one that
    keeps P in fp32. Prints the readings (pytest -rP)."""
    q, k, v, _, seg_q, seg_kv = _k9_bwd_case(cuda, layout, torch.bfloat16, d)
    got = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv)
    ref = _online_fwd_plain(q, k, v, seg_q, seg_kv, round_p=True)
    wide = _online_fwd_plain(q, k, v, seg_q, seg_kv, round_p=False)
    torch.cuda.synchronize()
    err, wide_err = _rel(got, ref), _rel(got, wide)
    print(f"{layout} D {d} out: kernel against P rounded {err:.3e}, against P in fp32 "
          f"{wide_err:.3e}; the two plain forwards apart {_rel(wide, ref):.3e}")
    assert err <= K9_STOCK_TOL < wide_err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["global", "grouped", "empty"])
def test_k9_gives_the_same_bits_twice(cuda, layout, dtype):
    """K9 owns its output rows and uses no atomics: a second run on the
    same inputs gives the same bits of out and lse."""
    q, k, v, _, seg_q, seg_kv = _k9_bwd_case(cuda, layout, dtype, 64)
    first = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    second = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k9_bwd_reads_strided_qkv(cuda):
    """Q, K and V as slices of one [B, S, 3, H, D] projection and a strided
    dO give what contiguous copies give."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 150, 3, 4, 32), generator=gen, device=cuda)
    seg = (torch.arange(150, device=cuda) < 120).to(torch.int32).expand(2, 150).contiguous()
    q, k, v = (qkv[:, :, i] for i in range(3))
    do = torch.randn((2, 150, 2, 4, 32), generator=gen, device=cuda)[:, :, 1]
    out, lse = k9.segment_attention_fwd(q, k, v, seg, seg, scale=0.1, return_lse=True)
    got = k9.segment_attention_bwd(q, k, v, out, lse, do, seg, seg, scale=0.1)
    want = k9.segment_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                                    do.contiguous(), seg, seg, scale=0.1)
    ref = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg, seg, scale=0.1)
    torch.cuda.synchronize()
    for g, w, r in zip(got, want, ref):
        assert torch.equal(g, w)
        assert _rel(g, r) <= K9_BWD_TOL[torch.float32]


def test_k9_bwd_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v, do, seg_q, seg_kv = _k9_bwd_case(cuda, "global", torch.float32, 64)
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    di = k9.rowsum_o_do(out, do)
    args = (q, k, v, do, lse, di, seg_q, seg_kv)
    for fn in (k9.segment_attention_bwd_dkv, k9.segment_attention_bwd_dq):
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, do, lse.double(), di, seg_q, seg_kv)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, do, lse[:, :1].contiguous(), di, seg_q, seg_kv)
        with pytest.raises(ValueError, match="di"):
            fn(q, k, v, do, lse, di.transpose(1, 2).contiguous().transpose(1, 2), seg_q, seg_kv)
        with pytest.raises(ValueError, match="do"):
            fn(q, k, v, do.to(torch.bfloat16), lse, di, seg_q, seg_kv)
        with pytest.raises(ValueError, match="do"):
            fn(q, k, v, do[:, :-1], lse, di, seg_q, seg_kv)
        with pytest.raises(ValueError, match="share"):
            fn(q, k.to(torch.bfloat16), v, do, lse, di, seg_q, seg_kv)
        with pytest.raises(ValueError, match="int32"):
            fn(q, k, v, do, lse, di, seg_q.long(), seg_kv)
        with pytest.raises(ValueError, match="contiguous"):  # heads innermost, not D
            fn(q, k, v, do.transpose(2, 3).contiguous().transpose(2, 3), lse, di, seg_q, seg_kv)
        with pytest.raises(ValueError, match="head dim"):
            fn(*(t[..., :48].contiguous() for t in (q, k, v, do)), lse, di, seg_q, seg_kv)
        fn(*args)  # the same call with valid inputs launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_attention_grads_through_the_function_on_cuda(cuda, dtype):
    """``segment_attention`` on leaves that require grad, in each dtype:
    q, k and v get finite grads from one K9-dkv and one K9-dq launch, equal
    to the direct kernel calls on the same inputs. fp32 stays on the fp32
    kernels: its grads match the fp32 plain backward at the fp32 tolerance,
    which bf16 arithmetic would miss; bf16 grads match the plain backward
    within K9_BWD_STOCK_TOL, which P and dS left in fp32 would miss."""
    from warpconvnet_tpu_torch.nn.functional.flash_attention import segment_attention

    q0, k0, v0, do, seg_q, seg_kv = _k9_bwd_case(cuda, "grouped", dtype, 64)
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q0, k0, v0))
    fns = (k9.segment_attention_bwd_dkv, k9.segment_attention_bwd_dq)
    out = segment_attention(q, k, v, seg_q, seg_kv)
    before = [launches(f) for f in fns]
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert [launches(f) - b for f, b in zip(fns, before)] == [1, 1]
    _, lse = k9.segment_attention_fwd(q0, k0, v0, seg_q, seg_kv, return_lse=True)
    di = k9.rowsum_o_do(out.detach(), do)
    args = (q0, k0, v0, do, lse, di, seg_q, seg_kv)
    dk, dv = k9.segment_attention_bwd_dkv(*args)
    want = (k9.segment_attention_bwd_dq(*args), dk, dv)
    ref = k9.segment_attention_bwd_plain(q0, k0, v0, out.detach(), lse, do, seg_q, seg_kv)
    torch.cuda.synchronize()
    for g, w, r, x in zip(grads, want, ref, (q0, k0, v0)):
        assert g.dtype == dtype and g.shape == x.shape and bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, w)
        assert _rel(g, r) <= (K9_BWD_STOCK_TOL if dtype == torch.bfloat16 else K9_BWD_TOL[dtype])


def test_attention_grads_reach_the_fused_qkv_projection_on_cuda(cuda):
    """An Attention (fused QKV, RoPE, pad rows) fwd+bwd on the card: q and
    k through RoPE, v as a strided slice of the projection; K9, K9-dkv and
    K9-dq launch once each and every gradient matches the CPU plain route."""
    from warpconvnet_tpu_torch.nn.modules.attention import Attention

    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((2, 90, 64), generator=gen)
    valid = torch.arange(90)[None] < torch.tensor([[80], [50]])
    coords = torch.randint(-20, 20, (2, 90, 3), generator=gen)
    r = torch.randn((2, 90, 64), generator=gen)
    results = []
    for dev in ("cpu", cuda):
        att = Attention(64, 2, rope_base=100.0, device=dev,
                        generator=torch.Generator().manual_seed(1))
        x = x0.to(dev).detach().requires_grad_(True)
        fns = (k9.segment_attention_fwd, k9.segment_attention_bwd_dkv, k9.segment_attention_bwd_dq)
        before = [launches(f) for f in fns]
        (att(x, valid.to(dev), coords.to(dev)) * r.to(dev)).sum().backward()
        launched = [launches(f) - b for f, b in zip(fns, before)]
        grads = {n: p.grad for n, p in att.named_parameters()}
        grads["x"] = x.grad
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
        results.append(({n: g.cpu() for n, g in grads.items()}, launched))
    assert results[0][1] == [0, 0, 0] and results[1][1] == [1, 1, 1]
    for n, g in results[0][0].items():
        torch.testing.assert_close(results[1][0][n], g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


def test_small_volt_train_step_on_cuda_gives_every_parameter_a_grad(cuda):
    """A small fp32 Volt (dim 32, 2 heads, depth 2) takes one train step on
    the card: every parameter gets a finite gradient (an attention whose
    output lost its grad_fn would leave the QKV weights' grads None), with
    1 K1, 2 K2, 2 K4, 2 K9, 2 K9-dkv and 2 K9-dq launches, and the loss and
    gradients agree with the CPU plain route."""
    vox = _voxels(4, "cpu", n=1024, c=3).lex_sort()
    labels = torch.randint(0, 5, vox.coords.shape[:2], generator=torch.Generator().manual_seed(2))
    fns = (sorted_search.kernel_map_probe, implicit_gemm.implicit_gemm_fwd,
           implicit_gemm.implicit_gemm_bwd_fused, k9.segment_attention_fwd,
           k9.segment_attention_bwd_dkv, k9.segment_attention_bwd_dq)
    results = []
    for dev in ("cpu", cuda):
        model = build_volt("volt-s", 3, 5, dim=32, num_heads=2, depth=2, stem_dim=8, device=dev,
                           generator=torch.Generator().manual_seed(0))
        step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), 1e-3), 5)
        before = [launches(f) for f in fns]
        loss = float(step(vox.to(dev), labels.to(dev))["loss"])
        launched = [launches(f) - b for f, b in zip(fns, before)]
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
        results.append((loss, {n: g.cpu() for n, g in grads.items()}, launched))
    assert results[0][2] == [0] * 6  # CPU: plain versions only
    assert results[1][2] == [1, 2, 2, 2, 2, 2]
    assert abs(results[1][0] - results[0][0]) <= 1e-5 * abs(results[0][0])
    for n, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][n], g, rtol=1e-3, atol=1e-4 * float(g.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_on_three_input_channels_matches_plain(cuda, dtype):
    """Volt's stem1 backward: K4 on a 3^3 self-map from 3 channels to 64
    (the ragged C_in edge inside one 64-channel slice, bf16 rows of 6
    bytes that take the unvectorised copy)."""
    vox = _voxels(10, cuda, c=3).lex_sort()
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    gen = torch.Generator(device=cuda).manual_seed(6)
    w = (torch.randn((27, 3, 64), generator=gen, device=cuda) / 9).to(dtype)
    x = vox.features.to(dtype).contiguous()
    g = (torch.randn((x.shape[0], x.shape[1], 64), generator=gen, device=cuda) / 30).to(dtype)
    dx, dw = implicit_gemm.implicit_gemm_bwd_fused(x, g, w, sub.table, sub.offsets)
    ref_dx, ref_dw = implicit_gemm.implicit_gemm_bwd_fused_plain(x, g, w, sub.table, sub.offsets)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and tuple(dx.shape) == tuple(x.shape) and dw.dtype == torch.float32
    torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype])
    torch.testing.assert_close(dw, ref_dw, **DW_TOL)


def _bits(t):
    """The tensor's bit patterns (so that -0.0 and 0.0 differ)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _ordered_maps(cuda, c_in):
    """(name, x, map) for maps with their row orders: the 3^3 and 5^3
    self-maps (K 27, 125), the 2^3 parity map (K 8) and its reverse (K 8,
    one offset a fine row), and a 3^3 map onto other coordinates, some of
    whose valid rows have no pair. Two scenes of different sizes, so that a
    tile of each holds both rows and pad rows."""
    vox = _voxels(0, cuda, c=c_in).lex_sort()
    sub, sub5, down = (generate_output_coords_and_kernel_map(vox, ks, st)[2].with_orders()
                       for ks, st in ((3, 1), (5, 1), (2, 2)))
    other = _voxels(4, cuda, n=1500, grid=30, c=c_in).lex_sort()
    onto = generate_output_coords_and_kernel_map(vox, 3, out_coords=other)[2].with_orders()
    gen = torch.Generator(device=cuda).manual_seed(3)
    coarse = torch.randn((2, down.table.shape[2], c_in), generator=gen, device=cuda)
    return [("3^3", vox.features, sub), ("5^3", vox.features, sub5),
            ("2^3 strided", vox.features, down), ("2^3 transposed", coarse, down.reversed()),
            ("3^3 onto other coordinates", vox.features, onto)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_gives_the_same_bits_under_any_row_order(cuda, dtype):
    """K2's output under the index order, the map's order and a random
    permutation of each scene's rows: bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    cpu_gen = torch.Generator().manual_seed(4)
    for name, x, bpt in _ordered_maps(cuda, 96):
        b, k, n = bpt.table.shape
        w = (torch.randn((k, 96, 96), generator=gen, device=cuda) / (k * 96) ** 0.5).to(dtype)
        x = x.to(dtype).contiguous()
        perm = torch.stack([torch.randperm(n, generator=cpu_gen) for _ in range(b)])
        outs = [implicit_gemm.implicit_gemm_fwd(x, w, bpt.table, order=o)
                for o in (None, bpt.order, perm.to(torch.int32).to(cuda))]
        torch.cuda.synchronize()
        assert bpt.order is not None, name
        for got in outs[1:]:
            assert torch.equal(_bits(got), _bits(outs[0])), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(3, 64), (12, 20), (32, 32), (128, 96), (64, 256),
                                        (384, 256)])
def test_k2_and_its_dgrad_in_the_maps_row_order_match_plain(cuda, dtype, c_in, c_out):
    gen = torch.Generator(device=cuda).manual_seed(5)
    for name, x, bpt in _ordered_maps(cuda, c_in):
        k, n_out = bpt.table.shape[1], bpt.table.shape[2]
        w = (torch.randn((k, c_in, c_out), generator=gen, device=cuda) / (k * c_in) ** 0.5)
        x, w = x.to(dtype).contiguous(), w.to(dtype)
        g = (torch.randn((2, n_out, c_out), generator=gen, device=cuda) / n_out ** 0.5).to(dtype)
        fwd, dg = launches(implicit_gemm.implicit_gemm_fwd), launches(implicit_gemm.implicit_gemm_dgrad)
        got = implicit_gemm.implicit_gemm_fwd(x, w, bpt.table, order=bpt.order)
        dx = implicit_gemm.implicit_gemm_dgrad(g, w, bpt.rev, order=bpt.rev_order)
        ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, bpt.table)
        ref_dx = implicit_gemm.implicit_gemm_dgrad_plain(g, w, bpt.rev)
        torch.cuda.synchronize()
        assert (launches(implicit_gemm.implicit_gemm_fwd),
                launches(implicit_gemm.implicit_gemm_dgrad)) == (fwd + 1, dg + 1), name
        assert got.dtype == dtype and got.shape == (2, n_out, c_out), name
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype], msg=name)
        torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype], msg=name)
        unmatched = (bpt.table < 0).all(dim=1)
        assert bool(unmatched.any()) and bool((got[unmatched] == 0).all()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(3, 64), (12, 20), (32, 32), (128, 96), (96, 96),
                                        (64, 256), (384, 256)])
def test_k4_in_the_maps_row_order_matches_plain(cuda, dtype, c_in, c_out):
    gen = torch.Generator(device=cuda).manual_seed(6)
    for name, x, bpt in _ordered_maps(cuda, c_in)[:2]:
        k, n = bpt.table.shape[1], bpt.table.shape[2]
        w = (torch.randn((k, c_in, c_out), generator=gen, device=cuda) / (k * c_in) ** 0.5)
        x, w = x.to(dtype).contiguous(), w.to(dtype)
        g = (torch.randn((2, n, c_out), generator=gen, device=cuda) / n ** 0.5).to(dtype)
        before = launches(implicit_gemm.implicit_gemm_bwd_fused)
        dx, dw = implicit_gemm.implicit_gemm_bwd_fused(x, g, w, bpt.table, bpt.offsets,
                                                       order=bpt.order)
        ref_dx, ref_dw = implicit_gemm.implicit_gemm_bwd_fused_plain(x, g, w, bpt.table,
                                                                     bpt.offsets)
        torch.cuda.synchronize()
        assert launches(implicit_gemm.implicit_gemm_bwd_fused) == before + 1, name
        assert dx.dtype == dtype and dw.dtype == torch.float32, name
        torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype], msg=name)
        torch.testing.assert_close(dw, ref_dw, **DW_TOL, msg=name)
        pad = (bpt.table < 0).all(dim=1)
        assert bool(pad.any()) and bool((dx[pad] == 0).all()), name


def test_k2_and_k4_wrappers_raise_on_a_bad_order(cuda):
    vox = _voxels(0, cuda, c=8).lex_sort()
    sub = generate_output_coords_and_kernel_map(vox, 3)[2].with_orders()
    x, w = vox.features, torch.zeros(27, 8, 8, device=cuda)
    for bad in (sub.order.long(), sub.order[:, :-1].contiguous(), sub.order.cpu(),
                sub.order.t().contiguous().t()):
        with pytest.raises(ValueError):
            implicit_gemm.implicit_gemm_fwd(x, w, sub.table, order=bad)
        with pytest.raises(ValueError):
            implicit_gemm.implicit_gemm_bwd_fused(x, x, w, sub.table, sub.offsets, order=bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_and_k4_count_their_work_as_the_host_models_do(cuda, dtype):
    """The kernels' own counts (``tracing`` device counters, while
    recording) equal ``tile_work`` in either order, K2's useful pairs the
    table's entries >= 0 and, for K4's dw, ``bwd_fused_dw_atomics`` at the
    chunk rows of the dtype's dw blocks; with nothing recording the kernels
    count nothing."""
    chunk_rows = implicit_gemm.DW_ROWS if dtype == torch.bfloat16 else implicit_gemm.F_DW_ROWS
    gen = torch.Generator(device=cuda).manual_seed(7)
    for name, x, bpt in _ordered_maps(cuda, 96):
        k, n_out = bpt.table.shape[1], bpt.table.shape[2]
        w = (torch.randn((k, 96, 160), generator=gen, device=cuda) / (k * 96) ** 0.5).to(dtype)
        x = x.to(dtype).contiguous()
        g = torch.randn((2, n_out, 160), generator=gen, device=cuda).to(dtype)
        for order in (None, bpt.order):
            tracing.reset_counters()
            with tracing.recording():
                implicit_gemm.implicit_gemm_fwd(x, w, bpt.table, order=order)
            got = tracing.counters(cuda)
            work, pairs = implicit_gemm.tile_work(bpt.table, order)
            assert (got["k2.fwd_tile_work"], got["k2.fwd_pairs"]) == (work, pairs), name
            assert work >= pairs > 0, name
        rev_order = bpt.rev_order
        tracing.reset_counters()
        with tracing.recording():
            implicit_gemm.implicit_gemm_dgrad(g, w, bpt.rev, order=rev_order)
        got = tracing.counters(cuda)
        assert got["k2.dgrad_tile_work"] == implicit_gemm.tile_work(bpt.rev, rev_order)[0], name
        if bpt.symmetric_self_map:
            tracing.reset_counters()
            with tracing.recording():
                implicit_gemm.implicit_gemm_bwd_fused(x, g, w, bpt.table, bpt.offsets,
                                                      order=bpt.order)
            got = tracing.counters(cuda)
            assert got["k4.tile_work"] == implicit_gemm.tile_work(bpt.table, bpt.order)[0]
            assert got["k4.dw_floats"] == implicit_gemm.bwd_fused_dw_atomics(
                bpt.table, 96, 160, chunk_rows) > 0, name
        tracing.reset_counters()  # nothing records: null counters, no atomics
        implicit_gemm.implicit_gemm_fwd(x, w, bpt.table, order=bpt.order)
        implicit_gemm.implicit_gemm_dgrad(g, w, bpt.rev, order=rev_order)
        implicit_gemm.implicit_gemm_wgrad(x, g, bpt.table)
        if bpt.symmetric_self_map:
            implicit_gemm.implicit_gemm_bwd_fused(x, g, w, bpt.table, bpt.offsets,
                                                  order=bpt.order)
        got = tracing.counters(cuda)
        assert all(got[k] == 0 for k in tracing.DEVICE_KEYS), name
