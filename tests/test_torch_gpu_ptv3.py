"""Point Transformer V3's kernel shapes on the card against their plain
versions: K9, K9-dkv and K9-dq at head size 16 over 1024-row serialized
patches with the pad rows' own segment ids (``patch_segment_ids``), K2 and
K4 on the 5^3 stem map at C 6 -> 32 and on a 3^3 map at C 512, and a small
PTv3's forward and training step on the card against the CPU plain route.

These tests need an NVIDIA GPU with nvcc (sm_90) and skip elsewhere; they
import no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_ptv3.py -q
"""

import pytest
import torch

from tests.test_torch_gpu import (  # noqa: F401 (the cuda fixture)
    DW_TOL, K9_BWD_TOL, K9_TOL, TOL, _rel, _voxels, cuda, launches)
from warpconvnet_tpu_torch.kernels import implicit_gemm
from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.models.point_transformer_v3 import build_ptv3
from warpconvnet_tpu_torch.nn.functional.flash_attention import patch_segment_ids
from warpconvnet_tpu_torch.nn.functional.sparse_conv import generate_output_coords_and_kernel_map
from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

pytestmark = pytest.mark.gpu

TINY = dict(enc_channels=(16, 16, 32, 32, 32), enc_num_head=(1, 1, 2, 2, 2),
            dec_channels=(16, 16, 32, 32), dec_num_head=(1, 1, 2, 2))


def _patch_case(cuda, dtype, h=2, n=5000, valid=(4100, 1500)):
    """q, k, v [2, n, h, 16] and (seg_q, seg_kv) of 1024-row patches, the
    first ``valid`` rows of each scene valid (a partial last patch), the
    rest pad rows; dO zero on pad rows."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    q, k, v, do = (torch.randn((2, n, h, 16), generator=gen, device=cuda) for _ in "qkvd")
    seg_q, seg_kv = patch_segment_ids(torch.tensor(valid, device=cuda), n, 1024)
    pad = torch.arange(n, device=cuda)[None] >= torch.tensor(valid, device=cuda)[:, None]
    do = torch.where(pad[..., None, None], 0, do)
    return (q * 2).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype), seg_q, seg_kv, pad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_family_on_patches_at_head_size_16(cuda, dtype):
    """K9 against the plain forward (out and lse), K9-dkv and K9-dq (one
    launch each) against the plain backward; pad rows match no key: out 0,
    lse +inf, dq 0."""
    q, k, v, do, seg_q, seg_kv, pad = _patch_case(cuda, dtype)
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    ref, ref_lse = k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv, return_lse=True)
    before = (launches(k9.segment_attention_bwd_dkv), launches(k9.segment_attention_bwd_dq))
    got = k9.segment_attention_bwd(q, k, v, out, lse, do, seg_q, seg_kv)
    want = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg_q, seg_kv)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **K9_TOL[dtype])
    assert bool((out[pad] == 0).all()) and bool(torch.isinf(lse.transpose(1, 2)[pad]).all())
    finite = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=1e-5, atol=1e-5)
    assert (launches(k9.segment_attention_bwd_dkv), launches(k9.segment_attention_bwd_dq)) == (
        before[0] + 1, before[1] + 1)
    for g, r in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all())
        assert _rel(g, r) <= K9_BWD_TOL[dtype]
    assert bool((got[0][pad] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks,c_in,c_out", [(5, 6, 32), (3, 512, 512)])
def test_k2_and_k4_at_ptv3_conv_shapes(cuda, dtype, ks, c_in, c_out):
    """The 5^3 stem (K = 125, C 6 -> 32) and a 3^3 positional conv at level
    4's width (C 512): K2 and K4 against their plain versions."""
    vox = _voxels(ks, cuda, n=1500, c=c_in).lex_sort()
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, ks)
    kk = ks ** 3
    gen = torch.Generator(device=cuda).manual_seed(ks)
    w = (torch.randn((kk, c_in, c_out), generator=gen, device=cuda) / (kk * c_in) ** 0.5)
    x, w = vox.features.to(dtype).contiguous(), w.to(dtype)
    g = (torch.randn((2, x.shape[1], c_out), generator=gen, device=cuda)
         / x.shape[1] ** 0.5).to(dtype)
    got = implicit_gemm.implicit_gemm_fwd(x, w, sub.table)
    ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, sub.table)
    dx, dw = implicit_gemm.implicit_gemm_bwd_fused(x, g, w, sub.table, sub.offsets)
    ref_dx, ref_dw = implicit_gemm.implicit_gemm_bwd_fused_plain(x, g, w, sub.table, sub.offsets)
    torch.cuda.synchronize()
    assert sub.table.shape[1] == kk
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(dx.float(), ref_dx.float(), **TOL[dtype])
    torch.testing.assert_close(dw, ref_dw, **DW_TOL)


def test_small_ptv3_on_the_card_matches_the_cpu(cuda):
    """The published depths at small widths, fp32, 64-row patches: one
    training step's logits, loss and every gradient on the card against
    the same step on the CPU plain route."""
    vox = _voxels(5, cuda, n=2048, grid=20, c=6).lex_sort()
    labels = torch.randint(0, 5, vox.coords.shape[:2], device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        model = build_ptv3(6, 5, patch_size=64, device=dev,
                           generator=torch.Generator().manual_seed(0), **TINY)
        seen = []
        model.final.register_forward_hook(lambda m, i, o: seen.append(o[0].features.detach()))
        step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters()), 5)
        loss = step(vox.to(dev), labels.to(dev))["loss"]
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        out[str(dev)] = (seen[0].cpu(), float(loss), grads)
    (lc, loss_c, gc), (lg, loss_g, gg) = out["cpu"], out[str(cuda)]
    assert _rel(lg, lc) <= 1e-4 and abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    median = torch.stack([g.norm() for g in gc.values()]).median()
    for name, g in gc.items():
        assert float((gg[name] - g).norm() / torch.maximum(g.norm(), median)) <= 1e-3, name
