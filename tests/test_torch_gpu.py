"""CUDA kernels K1 and K2 against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90) and skip elsewhere. They
import no JAX, so on a machine without it run them with the repository's
conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import implicit_gemm, sorted_search
from warpconvnet_tpu_torch.models.mink_unet import MinkUNetBase
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    generate_output_coords_and_kernel_map,
)
from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets
from warpconvnet_tpu_torch.ops.keys import PAD_COORD, coord_keys

pytestmark = pytest.mark.gpu

# fp32: the kernel and the plain version sum the same products in another
# order. bf16: outputs are rounded once from fp32, so they may differ by one
# bf16 ulp (2^-8 relative).
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


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
    before = sorted_search.kernel_map_probe.launches
    got = sorted_search.kernel_map_probe(*args)
    ref = sorted_search.kernel_map_probe_plain(*args)
    torch.cuda.synchronize()
    assert sorted_search.kernel_map_probe.launches == before + 1
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
        before = implicit_gemm.implicit_gemm_fwd.launches
        got = implicit_gemm.implicit_gemm_fwd(x, w, table)
        ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, table)
        torch.cuda.synchronize()
        assert implicit_gemm.implicit_gemm_fwd.launches == before + 1
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
        generator=torch.Generator().manual_seed(0),
    ).eval()
    vox = _voxels(3, "cpu", n=1024, c=3)
    with torch.inference_mode():
        ref = model(vox.lex_sort()).features
        k1, k2 = sorted_search.kernel_map_probe.launches, implicit_gemm.implicit_gemm_fwd.launches
        got = model.to(cuda)(vox.to(cuda).lex_sort()).features.cpu()
    assert sorted_search.kernel_map_probe.launches - k1 == 5
    assert implicit_gemm.implicit_gemm_fwd.launches - k2 == 2 * 8 + 8  # 1 block a stage
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
