"""Port parity: K2's plain version (the implicit-GEMM forward) against the
JAX ``implicit_gemm_fwd`` (Pallas, interpret mode) and ``_fwd_impl`` on the
same tables, fp32 at rtol = atol = 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from warpconvnet_tpu.kernels.implicit_gemm import implicit_gemm_fwd as jax_igemm_fwd
from warpconvnet_tpu.nn.functional.sparse_conv import _fwd_impl
from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import implicit_gemm
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    generate_output_coords_and_kernel_map,
)
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

TOL = dict(rtol=1e-5, atol=1e-5)


def _voxels(seed, b=2, n=384, grid=12, c=8):
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = np.zeros((b, n, c), np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, grid, size=(n - 60 * i, 3)), axis=0)
        nv[i] = len(u)
        coords[i, : len(u)] = u
        feats[i, : len(u)] = rng.standard_normal((len(u), c))
    return Voxels.create(coords, feats, nv, device="cpu").lex_sort()


def _weight(seed, k, c_in, c_out):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, c_in, c_out)) / np.sqrt(k * c_in)).astype(np.float32)


def _tables():
    """(name, x, table) for the three table kinds on the MinkUNet path:
    3^3 submanifold, 2^3/s2 strided (fine -> coarse), and its reverse
    (coarse -> fine, N_in != N_out)."""
    vox = _voxels(0, c=12)
    _, _, sub, _ = generate_output_coords_and_kernel_map(vox, 3)
    oc, onv, down, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2, out_capacity=160)
    rng = np.random.default_rng(1)
    coarse = torch.from_numpy(rng.standard_normal((2, 160, 12)).astype(np.float32))
    return [
        ("submanifold", vox.features, sub.table),
        ("strided", vox.features, down.table),
        ("transposed", coarse, down.reversed().table),
    ]


@pytest.mark.parametrize("kind", ["submanifold", "strided", "transposed"])
def test_plain_matches_jax_pallas_and_explicit(kind):
    name, x, table = next(t for t in _tables() if t[0] == kind)
    k = table.shape[1]
    w = _weight(2, k, x.shape[-1], 20)  # ragged C_out
    got = implicit_gemm.implicit_gemm_fwd(x, torch.from_numpy(w), table)
    assert got.shape == (2, table.shape[2], 20) and got.dtype == torch.float32
    jx, jw, jt = jnp.asarray(x.numpy()), jnp.asarray(w), jnp.asarray(table.numpy())
    pallas = jax.jit(
        lambda *a: jax_igemm_fwd(*a, tile_m=128, window_factor=2, interpret=True)
    )(jx, jw, jt)
    explicit = jax.jit(lambda *a: _fwd_impl(*a, jnp.float32))(jx, jw, jt)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(explicit), **TOL)
    assert tracing.counters().get("launches.implicit_gemm_fwd", 0) == 0  # CPU: plain version


def test_invalid_entries_add_exactly_zero():
    x = torch.randn(1, 6, 3)
    w = torch.randn(2, 3, 4)
    table = torch.tensor([[[0, -1, 2, -1], [-1, -1, 5, 1]]], dtype=torch.int32)
    got = implicit_gemm.implicit_gemm_fwd(x, w, table)
    assert torch.equal(got[0, 1], torch.zeros(4))
    torch.testing.assert_close(got[0, 0], x[0, 0] @ w[0], rtol=0, atol=0)
    torch.testing.assert_close(got[0, 3], x[0, 1] @ w[1], rtol=0, atol=0)


def test_bf16_plain_matches_jax_explicit():
    """bf16 inputs, fp32 accumulation, bf16 output: both sides round the
    same fp32 sums once, so they agree to one bf16 ulp (2^-8 relative)."""
    name, x, table = _tables()[0]
    w = _weight(3, 27, x.shape[-1], 16)
    xb = x.to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = implicit_gemm.implicit_gemm_fwd(xb, wb, table)
    assert got.dtype == torch.bfloat16
    ref = _fwd_impl(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16),
        jnp.asarray(table.numpy()), jnp.float32,
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=8e-3, atol=8e-3
    )


def test_wrapper_raises_off_cpu_and_cuda():
    x = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        implicit_gemm.implicit_gemm_fwd(x, torch.zeros(1, 3, 2, device="meta"),
                                        torch.zeros(1, 1, 4, dtype=torch.int32, device="meta"))
