"""Row orders of the kernel maps (``ops/kernel_map.py`` ``row_order``, the
order in which K2 and K4 take their tiles) and K2's tile-work count
(``kernels/implicit_gemm.py`` ``tile_work``), on the CPU at B=2.

The order is a permutation of each scene's rows in which rows with equal
offset masks are contiguous (in index order) and rows without a pair come
last; ``reversed()`` swaps a map's two orders; a conv's map carries them,
the map builder's alone (the depthwise and pooling paths') none; the
tile-work count matches a numpy brute force on the tables JAX's map
builder makes from the same numpy coordinates; a conv through an ordered
map matches JAX's ``implicit_gemm_fwd`` (Pallas, interpret mode) and its
gradients ``jax.grad`` of the same conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpconvnet_tpu.geometry.voxels import Voxels as JVoxels
from warpconvnet_tpu.kernels.implicit_gemm import implicit_gemm_fwd as jax_igemm_fwd
from warpconvnet_tpu.nn.functional import sparse_conv as jconv
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import implicit_gemm
from warpconvnet_tpu_torch.nn.functional import sparse_conv as tconv
from warpconvnet_tpu_torch.ops import kernel_map as tkm
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

C_IN = 6


def _coords(seed=0, b=2, n=384, grid=12):
    """Two scenes of different sizes, padded to n rows: (coords, feats,
    num_valid) as numpy."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = np.zeros((b, n, C_IN), np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, grid, size=(n - 70 * i, 3)), axis=0).astype(np.int32)
        nv[i] = len(u)
        coords[i, : len(u)] = u
        feats[i, : len(u)] = rng.standard_normal((len(u), C_IN))
    return coords, feats, nv


def _port_maps():
    """name -> (port map with its row orders); the 2^3 map's reverse as its
    own entry."""
    vox = Voxels.create(*_coords(), device="cpu").lex_sort()
    maps = {ks: tconv.generate_output_coords_and_kernel_map(vox, ks)[2].with_orders()
            for ks in (3, 5, 7)}
    down = tconv.generate_output_coords_and_kernel_map(vox, 2, stride=2, out_capacity=256)[2]
    down = down.with_orders()
    return vox, {"3^3": maps[3], "5^3": maps[5], "7^3": maps[7], "2^3": down,
                 "2^3 reversed": down.reversed()}


def _masks(table):
    """[B, N] uint64 offset masks over the first MASK_BITS offsets."""
    t = np.asarray(table)[:, : tkm.MASK_BITS] >= 0
    shifts = np.arange(t.shape[1], dtype=np.uint64)[None, :, None]
    return (t.astype(np.uint64) << shifts).sum(axis=1)


@pytest.mark.parametrize("name", ["3^3", "5^3", "7^3", "2^3", "2^3 reversed"])
def test_order_is_a_permutation_grouping_equal_masks_with_pads_last(name):
    vox, maps = _port_maps()
    bpt = maps[name]
    order = bpt.order.numpy()
    masks = _masks(bpt.table.numpy())
    b, n = order.shape
    assert bpt.order.dtype == torch.int32 and order.shape == (2, bpt.table.shape[2])
    for i in range(b):
        np.testing.assert_array_equal(np.sort(order[i]), np.arange(n))
        seq = masks[i, order[i]]
        runs = 1 + np.count_nonzero(seq[1:] != seq[:-1])
        assert runs == len(np.unique(seq)), "a mask's rows are not contiguous"
        starts = np.flatnonzero(np.r_[True, seq[1:] != seq[:-1]])
        for lo, hi in zip(starts, np.r_[starts[1:], n]):
            assert np.all(np.diff(order[i, lo:hi]) > 0), "a class is not in index order"
        empty = seq == 0
        assert empty.any() and not empty[: np.argmax(empty)].any()
        assert empty[np.argmax(empty):].all(), "a row with a pair after a row without"


def test_reversed_swaps_the_orders_and_a_self_map_shares_one():
    _, maps = _port_maps()
    down, up = maps["2^3"], maps["2^3 reversed"]
    assert up.order is down.rev_order and up.rev_order is down.order
    assert up.reversed().order is down.order
    np.testing.assert_array_equal(down.rev_order.numpy(), tkm.row_order(down.rev).numpy())
    sub = maps["3^3"]
    assert sub.rev_order is sub.order and sub.with_orders() is sub


def test_depthwise_maps_carry_no_order():
    """The map builder, which the depthwise and pooling paths call, leaves
    the orders out; the map a conv builds has both."""
    vox, _ = _port_maps()
    bpt = tconv.generate_output_coords_and_kernel_map(vox, 3)[2]
    assert bpt.order is None and bpt.rev_order is None
    _, conv_map = tconv.spatially_sparse_conv(vox, torch.zeros((8, C_IN, 4)), 2, stride=2)
    assert conv_map.order is not None and conv_map.rev_order is not None
    np.testing.assert_array_equal(conv_map.rev_order.numpy(),
                                  tkm.row_order(conv_map.rev).numpy())


def _brute_tile_work(table, order, rows=implicit_gemm.TILE_ROWS):
    """tile_rows x the (tile, offset) pairs whose tile has a pair of that
    offset, tiles taken along ``order`` (None: the index order)."""
    b, k, n = table.shape
    work = 0
    for i in range(b):
        seq = np.arange(n) if order is None else order[i]
        for t0 in range(0, n, rows):
            tile = seq[t0 : t0 + rows]
            work += rows * sum(bool((table[i, kk, tile] >= 0).any()) for kk in range(k))
    return work, int((table >= 0).sum())


@pytest.mark.parametrize("name", ["3^3", "2^3", "2^3 reversed"])
def test_tile_work_matches_a_numpy_brute_force_on_jax_tables(name):
    coords, feats, nv = _coords()
    jv = JVoxels.create(coords, feats, nv).lex_sort()
    ks = 3 if name == "3^3" else 2
    kw = {} if ks == 3 else dict(stride=2, out_capacity=256)

    def build(v):
        _, _, bpt, _ = jconv.generate_output_coords_and_kernel_map(v, ks, **kw)
        return bpt.table, bpt.rev

    jt, jrev = jax.jit(build)(jv)
    ref = np.array(jrev if name == "2^3 reversed" else jt)
    _, maps = _port_maps()
    bpt = maps[name]
    np.testing.assert_array_equal(bpt.table.numpy(), ref)
    for order in (None, bpt.order):
        got = implicit_gemm.tile_work(torch.from_numpy(ref), order)
        assert got == _brute_tile_work(ref, None if order is None else order.numpy())
    ordered, pairs = implicit_gemm.tile_work(bpt.table, bpt.order)
    unordered, _ = implicit_gemm.tile_work(bpt.table)
    assert pairs <= ordered <= unordered


def _jax_table_conv(x, w, table):
    """out[b, o] = sum_k x[b, table[b, k, o]] @ w[k] in plain jnp (-1 adds
    zero): the reference that ``jax.grad`` differentiates."""
    b = jnp.arange(table.shape[0])[:, None, None]
    rows = jnp.where((table >= 0)[..., None], x[b, jnp.maximum(table, 0)], 0)
    return jnp.einsum("bknc,kcd->bnd", rows, w)


@pytest.mark.parametrize("name", ["3^3", "2^3"])
def test_conv_through_an_ordered_map_matches_jax(name):
    """``table_conv`` with the dense kernels on a map with its orders: the forward against JAX's
    Pallas forward, the gradients of sum(out^2) in x and w against
    ``jax.grad`` of the plain jnp conv. On the CPU every wrapper runs its
    plain version, which takes no order, so this checks the routing of the
    orders through ``TableConv`` (K4 for the 3^3 self-map, K2-dgrad + K3 for
    the 2^3 map), not the kernels' use of them: the card tests in
    ``tests/test_torch_gpu.py`` do that."""
    vox, maps = _port_maps()
    bpt = maps[name]
    assert bpt.order is not None
    k = bpt.table.shape[1]
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((k, C_IN, 20)) / np.sqrt(k * C_IN)).astype(np.float32)
    x = vox.features.clone().requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tconv.table_conv(x, tw, bpt, tconv.DENSE)
    got.square().sum().backward()
    jx, jw, jt = (jnp.asarray(a) for a in (vox.features.numpy(), w, bpt.table.numpy()))
    ref = jax.jit(lambda *a: jax_igemm_fwd(*a, tile_m=128, window_factor=2, interpret=True))(
        jx, jw, jt
    )
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    jdx, jdw = jax.jit(jax.grad(lambda x, w: jnp.sum(_jax_table_conv(x, w, jt) ** 2),
                                argnums=(0, 1)))(jx, jw)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk_rows", [64, 256])
def test_k4_atomic_count_matches_a_numpy_brute_force(chunk_rows):
    """bwd_fused_dw_atomics: C_in x C_out floats for every (scene, offset,
    chunk of rows) with a pair."""
    _, maps = _port_maps()
    table = maps["3^3"].table.numpy()
    b, k, n = table.shape
    flushes = sum(bool((table[i, kk, r0 : r0 + chunk_rows] >= 0).any())
                  for i in range(b) for kk in range(k) for r0 in range(0, n, chunk_rows))
    got = implicit_gemm.bwd_fused_dw_atomics(maps["3^3"].table, 12, 20, chunk_rows)
    assert got == flushes * 12 * 20 > 0
