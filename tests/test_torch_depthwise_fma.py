"""Port parity for the depthwise kernels' plain versions (K6 forward and
dgrad, K7 wgrad, K8 fused self-map backward) against the JAX explicit scans
``_depth_{fwd,dgrad,wgrad}_impl`` (fp32, rtol = atol = 1e-5) and against the
Pallas kernels in interpret mode (rtol = atol = 1e-4, as
``tests/kernels/test_depthwise_fma.py`` holds them against the scans).

Maps: 3^3 and 5^3 self-maps (identity offset included), a 3^3 map onto other
coords, and the 2^3 parity map; all built by the port and fed to both
packages as the same numpy table."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from warpconvnet_tpu.kernels import depthwise_fma as jdfma
from warpconvnet_tpu.nn.functional import sparse_conv_depth as jdepth
from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import depthwise_fma as dfma
from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
    generate_output_coords_and_kernel_map,
)
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS = dict(tile_m=128, window_factor=4, interpret=True)


def _voxels(seed, b=2, n=512, grid=14, c=8):
    """Lex-sorted random scenes (the JAX kernel tests' inputs)."""
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


def _case(kind, c=8, seed=0):
    """(x, g, weight, map) as torch tensors for one map kind."""
    vox = _voxels(seed, c=c)
    if kind == "other":
        target = _voxels(seed + 2, n=320, c=c)
        _, _, bpt, _ = generate_output_coords_and_kernel_map(vox, 3, out_coords=target)
    elif kind == "parity2":
        _, _, bpt, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2)
    else:
        _, _, bpt, _ = generate_output_coords_and_kernel_map(vox, int(kind[-1]))
    rng = np.random.default_rng(seed + 3)
    k, n_out = bpt.table.shape[1], bpt.table.shape[2]
    g = torch.from_numpy(rng.standard_normal((2, n_out, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c)) * 0.3).astype(np.float32))
    return vox.features, g, w, bpt


def _j(t):
    return jnp.asarray(t.numpy())


KINDS = ["sub3", "sub5", "other", "parity2"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_jax_scans(kind):
    x, g, w, bpt = _case(kind)
    assert bpt.symmetric_self_map == kind.startswith("sub")
    assert int((bpt.table >= 0).sum()) > 0
    out = dfma.depthwise_fma_fwd_plain(x, w, bpt.table)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jdepth._depth_fwd_impl(_j(x), _j(w), _j(bpt.table), jnp.float32)),
        **TOL,
    )
    dx = dfma.depthwise_fma_dgrad_plain(g, w, bpt.rev)
    np.testing.assert_allclose(
        dx.numpy(), np.asarray(jdepth._depth_dgrad_impl(_j(g), _j(w), _j(bpt.rev), jnp.float32)),
        **TOL,
    )
    dw = dfma.depthwise_fma_wgrad_plain(x, g, bpt.table)
    np.testing.assert_allclose(
        dw.numpy(), np.asarray(jdepth._depth_wgrad_impl(_j(x), _j(g), _j(bpt.table), jnp.float32)),
        **TOL,
    )
    if bpt.symmetric_self_map:
        fdx, fdw = dfma.depthwise_fma_bwd_fused_plain(x, g, w, bpt.table, bpt.offsets)
        torch.testing.assert_close(fdx, dx, **TOL)
        torch.testing.assert_close(fdw, dw, **TOL)


@pytest.mark.parametrize("kind", ["sub3", "parity2"])
def test_plain_versions_match_pallas_kernels(kind):
    """K6 (forward, and dgrad through the self-map's reverse), K7 and, on
    the self-map, K8 in interpret mode."""
    x, g, w, bpt = _case(kind, seed=5)
    out = jdfma.depthwise_fma_fwd(_j(x), _j(w), _j(bpt.table), **PALLAS)
    np.testing.assert_allclose(
        dfma.depthwise_fma_fwd_plain(x, w, bpt.table).numpy(), np.asarray(out), **PALLAS_TOL
    )
    dw = jdfma.depthwise_fma_wgrad(_j(x), _j(g), _j(bpt.table), **PALLAS)
    np.testing.assert_allclose(
        dfma.depthwise_fma_wgrad_plain(x, g, bpt.table).numpy(), np.asarray(dw), **PALLAS_TOL
    )
    if bpt.symmetric_self_map:
        jdx, jdw = jdfma.depthwise_fma_bwd_fused(
            _j(x), _j(g), _j(w), _j(bpt.table), zg=3, identity_k=bpt.identity_index, **PALLAS
        )
        dx, dw = dfma.depthwise_fma_bwd_fused_plain(x, g, w, bpt.table, bpt.offsets)
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **PALLAS_TOL)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **PALLAS_TOL)


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each wrapper is its plain version and counts no
    launch; bf16 features keep their dtype with an fp32 weight, dw is fp32."""
    x, g, w, bpt = _case("sub3")
    keys = [f"launches.{f.__name__}" for f in (dfma.depthwise_fma_fwd, dfma.depthwise_fma_dgrad,
                                                dfma.depthwise_fma_wgrad,
                                                dfma.depthwise_fma_bwd_fused)]
    before = [tracing.counters().get(k, 0) for k in keys]
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    out = dfma.depthwise_fma_fwd(xb, w, bpt.table)
    dx = dfma.depthwise_fma_dgrad(gb, w, bpt.rev)
    dw = dfma.depthwise_fma_wgrad(xb, gb, bpt.table)
    fdx, fdw = dfma.depthwise_fma_bwd_fused(xb, gb, w, bpt.table, bpt.offsets)
    after = [tracing.counters().get(k, 0) for k in keys]
    assert after == before
    assert out.dtype == dx.dtype == fdx.dtype == torch.bfloat16
    assert dw.dtype == fdw.dtype == torch.float32
    torch.testing.assert_close(out, dfma.depthwise_fma_fwd_plain(xb, w, bpt.table))
    torch.testing.assert_close(fdx, dx)
    torch.testing.assert_close(fdw, dw)


def test_fused_backward_refuses_what_is_not_a_symmetric_self_map():
    x, g, w, bpt = _case("parity2")
    with pytest.raises(ValueError):
        dfma.depthwise_fma_bwd_fused_plain(x, x, w, bpt.table, bpt.offsets)
    x, g, w, bpt = _case("sub3")
    with pytest.raises(ValueError, match="symmetric"):
        dfma.depthwise_fma_bwd_fused(x, g, w, bpt.table, bpt.offsets[::-1] + 1)


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    """Off the CPU, a wrapper launches its kernel or raises; it never falls
    back to the plain version (meta tensors stand in for a device here)."""
    m = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype, device="meta")  # noqa: E731
    t = m(1, 27, 4, dtype=torch.int32)
    for call in (
        lambda: dfma.depthwise_fma_fwd(m(1, 4, 8), m(27, 8), t),
        lambda: dfma.depthwise_fma_dgrad(m(1, 4, 8), m(27, 8), t),
        lambda: dfma.depthwise_fma_wgrad(m(1, 4, 8), m(1, 4, 8), t),
        lambda: dfma.depthwise_fma_bwd_fused(m(1, 4, 8), m(1, 4, 8), m(27, 8), t,
                                             np.zeros((27, 3), np.int32)),
    ):
        with pytest.raises(ValueError):
            call()


def _short_scenes(kind, n=600):
    """Two scenes of far fewer voxels than rows, so that the end of each
    holds tiles of padding rows only: random voxels ("sub3": 300 and 100 of
    a 14^3 grid) or a 6^3 cube and a quarter of it ("cube": every offset of
    a 3^3 kernel valid at the cube's interior rows)."""
    if kind == "cube":
        pts = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
        nv = np.array([len(pts), len(pts) // 4], np.int32)
    else:
        pts = np.unique(np.random.default_rng(0).integers(0, 14, (400, 3)), axis=0)
        nv = np.array([300, 100], np.int32)
    coords = np.full((2, n, 3), PAD_COORD, np.int32)
    for i in range(2):
        coords[i, : nv[i]] = pts[: nv[i]]
    return Voxels.create(coords, np.zeros((2, n, 8), np.float32), nv, device="cpu").lex_sort()


def _k8_dw_adds_brute_force(table, c, chunk_rows):
    """K8's dw flushes counted one by one: C floats for each (scene,
    offset, chunk of rows) that holds a pair."""
    t = table.numpy()
    b, k, n = t.shape
    return c * sum(bool((t[s, kk, r0:r0 + chunk_rows] >= 0).any())
                   for s in range(b) for kk in range(k) for r0 in range(0, n, chunk_rows))


@pytest.mark.parametrize("chunk_rows", [16, 100, 4096])
@pytest.mark.parametrize("kind", ["sub3", "cube", "all valid"])
def test_k8_dw_add_model_matches_a_brute_force(kind, chunk_rows):
    """bwd_fused_dw_adds (the host model of K8's own count) against a
    chunk-by-chunk count, on a map with chunks of padding rows only, on one
    whose interior rows have every offset valid, and on a table with every
    entry valid (every chunk of every offset flushes)."""
    if kind == "all valid":
        table = torch.from_numpy(np.random.default_rng(1).integers(0, 90, (2, 27, 90), np.int32))
    else:
        table = generate_output_coords_and_kernel_map(_short_scenes(kind), 3)[2].table
    n = table.shape[2]
    chunks = -(-n // chunk_rows)
    pad = torch.nn.functional.pad(table >= 0, (0, chunks * chunk_rows - n))
    met = pad.reshape(2, 27, chunks, chunk_rows).any(-1)
    if kind == "all valid":
        assert bool(met.all())
    elif chunk_rows < n:
        assert not bool(met.all())  # some chunks hold padding rows only
    if kind == "cube":
        assert bool(((table >= 0).sum(1) == 27).any())  # rows with every offset valid
    got = dfma.bwd_fused_dw_adds(table, 12, chunk_rows)
    assert got == _k8_dw_adds_brute_force(table, 12, chunk_rows) > 0
    if kind == "all valid":
        assert got == 2 * 27 * chunks * 12
