"""Port parity for the backward kernels' plain versions: K2 as dgrad, K3
(wgrad) and K4 (fused self-map backward), against the JAX Pallas kernels in
interpret mode and the JAX explicit backends, on the three table kinds of
the MinkUNet path with ragged channels (C_in 12, C_out 20).

Tolerances: fp32 rtol = atol = 1e-5 (the same products summed in another
order); a bf16 dx within one bf16 ulp of the reference (both round one fp32
sum once), a bf16-input dw (fp32 out) at the fp32 tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_implicit_gemm import _voxels, _weight
from warpconvnet_tpu.kernels import implicit_gemm as jig
from warpconvnet_tpu.nn.functional.sparse_conv import _dgrad_impl, _wgrad_impl
from warpconvnet_tpu_torch.kernels import implicit_gemm
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    generate_output_coords_and_kernel_map,
)

TOL = dict(rtol=1e-5, atol=1e-5)
C_IN, C_OUT = 12, 20
KINDS = ["submanifold", "strided", "transposed"]


def _maps():
    """name -> (x [B, N_in, C_IN], map) for the three table kinds: 3^3
    submanifold (self-map), 2^3/s2 strided (fine -> coarse) and its
    reversed map (coarse -> fine, N_in != N_out)."""
    vox = _voxels(0, c=C_IN)
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    _, _, down, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2, out_capacity=160)
    rng = np.random.default_rng(1)
    coarse = torch.from_numpy(rng.standard_normal((2, 160, C_IN)).astype(np.float32))
    return {
        "submanifold": (vox.features, sub),
        "strided": (vox.features, down),
        "transposed": (coarse, down.reversed()),
    }


def _g(seed, table, c=C_OUT):
    """An output gradient scaled as a mean loss's would be, so that the
    weight gradient's sums over ~700 rows stay O(1)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((table.shape[0], table.shape[2], c)) / np.sqrt(table.shape[2])
    return torch.from_numpy(g.astype(np.float32))


def _j(t):
    return jnp.asarray(t.numpy())


def _assert_within_one_bf16_ulp(got, ref):
    """|got - ref| <= one bf16 ulp of ref (2^(e-7) for |ref| in [2^e,
    2^(e+1))), with a floor at the smallest normal ulp we care about."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-60))) - 7)
    assert np.all(np.abs(got - ref) <= ulp + 2.0**-60), np.max(np.abs(got - ref) / ulp)


@pytest.mark.parametrize("kind", KINDS)
def test_dgrad_plain_matches_jax_pallas_and_explicit(kind):
    x, bpt = _maps()[kind]
    w = _weight(2, bpt.table.shape[1], C_IN, C_OUT)
    g = _g(3, bpt.table)
    got = implicit_gemm.implicit_gemm_dgrad(g, torch.from_numpy(w), bpt.rev)
    assert got.shape == x.shape and got.dtype == torch.float32
    jg, jw, jrev = _j(g), jnp.asarray(w), _j(bpt.rev)
    pallas = jax.jit(
        lambda g, w, r: jig.implicit_gemm_fwd(
            g, jnp.swapaxes(w, 1, 2), r, tile_m=128, window_factor=2, interpret=True
        )
    )(jg, jw, jrev)
    explicit = jax.jit(lambda *a: _dgrad_impl(*a, jnp.float32))(jg, jw, jrev)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(explicit), **TOL)
    # Input rows that no output reaches (the fine side's pad rows among
    # them; every coarse row of the transposed input is filled) get exactly 0.
    unreached = (bpt.rev < 0).all(dim=1)
    assert bool(unreached.any()) == (kind != "transposed")
    assert torch.equal(got[unreached], torch.zeros_like(got[unreached]))
    assert implicit_gemm.implicit_gemm_dgrad.launches == 0  # CPU: plain version


@pytest.mark.parametrize("kind", KINDS)
def test_wgrad_plain_matches_jax_pallas_and_explicit(kind):
    x, bpt = _maps()[kind]
    g = _g(4, bpt.table)
    got = implicit_gemm.implicit_gemm_wgrad(x, g, bpt.table)
    assert got.shape == (bpt.table.shape[1], C_IN, C_OUT) and got.dtype == torch.float32
    jx, jg, jt = _j(x), _j(g), _j(bpt.table)
    pallas = jax.jit(
        lambda *a: jig.implicit_gemm_wgrad(*a, tile_m=128, window_factor=2, interpret=True)
    )(jx, jg, jt)
    explicit = jax.jit(lambda *a: _wgrad_impl(*a, jnp.float32))(jx, jg, jt)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(explicit), **TOL)
    assert implicit_gemm.implicit_gemm_wgrad.launches == 0


def test_fused_bwd_plain_matches_jax_pallas_and_explicit_pair():
    """K4's plain version on a submanifold self-map at C_in != C_out,
    against the JAX fused kernel (interpret) and the explicit pair, called
    as tests/kernels/test_igemm_fused_bwd.py calls them."""
    x, bpt = _maps()["submanifold"]
    w = _weight(5, 27, C_IN, C_OUT)
    g = _g(6, bpt.table)
    dx, dw = implicit_gemm.implicit_gemm_bwd_fused(x, g, torch.from_numpy(w), bpt.table, bpt.offsets)
    assert dx.shape == x.shape and dw.shape == (27, C_IN, C_OUT)
    jx, jg, jw, jt = _j(x), _j(g), jnp.asarray(w), _j(bpt.table)
    pdx, pdw = jax.jit(
        lambda *a: jig.implicit_gemm_bwd_fused(*a, tile_m=128, window_factor=4, interpret=True)
    )(jx, jg, jw, jt)
    edx = _dgrad_impl(jg, jw, _j(bpt.rev), jnp.float32)
    edw = _wgrad_impl(jx, jg, jt, jnp.float32)
    for ref_dx, ref_dw in ((pdx, pdw), (edx, edw)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), **TOL)
    pad = (bpt.table < 0).all(dim=1)  # a self-map pairs every valid row with itself
    assert bool(pad.any())
    assert torch.equal(dx[pad], torch.zeros_like(dx[pad]))  # pad rows of dx are 0
    # The split route (K2-dgrad + K3) gives the same pair.
    torch.testing.assert_close(dx, implicit_gemm.implicit_gemm_dgrad(g, torch.from_numpy(w), bpt.rev), **TOL)
    torch.testing.assert_close(dw, implicit_gemm.implicit_gemm_wgrad(x, g, bpt.table), **TOL)
    assert implicit_gemm.implicit_gemm_bwd_fused.launches == 0


@pytest.mark.parametrize("kind", ["submanifold", "transposed"])
def test_bf16_dgrad_within_one_ulp_and_wgrad_matches_jax_explicit(kind):
    x, bpt = _maps()[kind]
    k = bpt.table.shape[1]
    xb = x.to(torch.bfloat16)
    gb = _g(7, bpt.table).to(torch.bfloat16)
    wb = torch.from_numpy(_weight(8, k, C_IN, C_OUT)).to(torch.bfloat16)
    jb = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    dx = implicit_gemm.implicit_gemm_dgrad(gb, wb, bpt.rev)
    dw = implicit_gemm.implicit_gemm_wgrad(xb, gb, bpt.table)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    ref_dx = _dgrad_impl(jb(gb), jb(wb), _j(bpt.rev), jnp.float32)
    ref_dw = _wgrad_impl(jb(xb), jb(gb), _j(bpt.table), jnp.float32)
    _assert_within_one_bf16_ulp(dx.float().numpy(), ref_dx)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), **TOL)
    if bpt.symmetric_self_map:
        fdx, fdw = implicit_gemm.implicit_gemm_bwd_fused(xb, gb, wb, bpt.table, bpt.offsets)
        assert fdx.dtype == torch.bfloat16
        _assert_within_one_bf16_ulp(fdx.float().numpy(), ref_dx)
        np.testing.assert_allclose(fdw.numpy(), np.asarray(ref_dw), **TOL)


def test_invalid_entries_add_exactly_zero():
    """Small integers keep every sum exact: each result equals the hand sum
    over the valid pairs alone, bit for bit, with huge values in the rows a
    -1 would alias (row 0)."""
    x = torch.tensor([[[1e30, -1e30], [1.0, 2.0], [3.0, -1.0], [2.0, 2.0]]])
    g = torch.tensor([[[1.0, 0.0, 2.0], [1e30, 1e30, 1e30], [-1.0, 1.0, 1.0]]])
    w = torch.tensor([[[1.0, 2.0, 0.0], [0.0, 1.0, 1.0]], [[2.0, 0.0, 1.0], [1.0, 1.0, 0.0]]])
    table = torch.tensor([[[1, -1, 3], [-1, -1, 2]]], dtype=torch.int32)  # [1, K=2, N_out=3]
    rev = torch.tensor([[[-1, 0, -1, 2], [-1, -1, 2, -1]]], dtype=torch.int32)  # [1, 2, N_in=4]
    dw = implicit_gemm.implicit_gemm_wgrad(x, g, table)
    want = torch.zeros(2, 2, 3)
    want[0] = torch.outer(x[0, 1], g[0, 0]) + torch.outer(x[0, 3], g[0, 2])
    want[1] = torch.outer(x[0, 2], g[0, 2])
    torch.testing.assert_close(dw, want, rtol=0, atol=0)
    dx = implicit_gemm.implicit_gemm_dgrad(g, w, rev)
    want_dx = torch.zeros(1, 4, 2)
    want_dx[0, 1] = w[0] @ g[0, 0]
    want_dx[0, 3] = w[0] @ g[0, 2]
    want_dx[0, 2] = w[1] @ g[0, 2]
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)


def test_fused_bwd_raises_off_symmetric_self_maps():
    maps = _maps()
    x, sub = maps["submanifold"]
    w = torch.zeros(27, C_IN, C_OUT)
    g = _g(9, sub.table)
    with pytest.raises(ValueError, match="self-map"):
        implicit_gemm.implicit_gemm_bwd_fused(x[:, :-1], g, w, sub.table, sub.offsets)
    with pytest.raises(ValueError, match="symmetric"):
        implicit_gemm.implicit_gemm_bwd_fused(x, g, w, sub.table, sub.offsets[::-1] + 1)
    xs, down = maps["strided"]
    with pytest.raises(ValueError, match="symmetric"):
        implicit_gemm.implicit_gemm_bwd_fused(
            xs, _g(9, down.table), torch.zeros(8, C_IN, C_OUT), down.table, down.offsets
        )
    assert sub.symmetric_self_map and not down.symmetric_self_map
    assert not maps["transposed"][1].symmetric_self_map


@pytest.mark.parametrize("fn", ["dgrad", "wgrad", "bwd_fused"])
def test_wrappers_raise_off_cpu_and_cuda(fn):
    m = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    t = torch.zeros(1, 27, 4, dtype=torch.int32, device="meta")
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets

    call = {
        "dgrad": lambda: implicit_gemm.implicit_gemm_dgrad(m(1, 4, 2), m(27, 3, 2), t),
        "wgrad": lambda: implicit_gemm.implicit_gemm_wgrad(m(1, 4, 3), m(1, 4, 2), t),
        "bwd_fused": lambda: implicit_gemm.implicit_gemm_bwd_fused(
            m(1, 4, 3), m(1, 4, 2), m(27, 3, 2), t, kernel_offsets(3)
        ),
    }[fn]
    with pytest.raises(ValueError, match="unsupported device"):
        call()
