"""Port parity: kernel maps (K1's plain version, parity partitions and
reverse tables) against the JAX package, index for index at B=2.

The JAX side runs as its own tests run it on the CPU: on lex-sorted inputs
``build_pair_tables_batched`` takes the Pallas probe in interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from warpconvnet_tpu.geometry.voxels import Voxels as JVoxels
from warpconvnet_tpu.nn.functional import sparse_conv as jconv
from warpconvnet_tpu.ops import kernel_map as jkm
from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.functional import sparse_conv as tconv
from warpconvnet_tpu_torch.ops import kernel_map as tkm
from warpconvnet_tpu_torch.ops.keys import PAD_COORD


def _pad_batch(scenes, n, c=0, seed=0):
    """List of [n_i, 3] coords -> padded coords, features, num_valid."""
    rng = np.random.default_rng(seed)
    coords = np.full((len(scenes), n, 3), PAD_COORD, np.int32)
    feats = np.zeros((len(scenes), n, max(c, 1)), np.float32)
    nv = np.array([len(s) for s in scenes], np.int32)
    for i, s in enumerate(scenes):
        coords[i, : len(s)] = s
        feats[i, : len(s)] = rng.standard_normal((len(s), feats.shape[-1]))
    return coords, feats, nv


def _random_scenes(seed, b=2, n=384, grid=12, lo=0):
    rng = np.random.default_rng(seed)
    return [
        np.unique(rng.integers(lo, grid, size=(n - 50 * i, 3)), axis=0).astype(np.int32)
        for i in range(b)
    ]


def _both(coords, feats, nv, sort=True):
    t, j = Voxels.create(coords, feats, nv, device="cpu"), JVoxels.create(coords, feats, nv)
    return (t.lex_sort(), j.lex_sort()) if sort else (t, j)


def _assert_eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_tables(in_c, in_nv, out_c, out_nv, offsets, **kwargs):
    """JAX ``build_pair_tables_batched`` under jit (offsets and flags fixed)."""
    fn = jax.jit(lambda *a: jkm.build_pair_tables_batched(*a, offsets, **kwargs))
    return fn(*(jnp.asarray(np.asarray(a)) for a in (in_c, in_nv, out_c, out_nv)))


def _jax_map(jv, kernel_size, out_coords=None, **kwargs):
    """JAX ``generate_output_coords_and_kernel_map`` under jit:
    (out coords, out num_valid, table, rev)."""

    def fn(v, o):
        oc, onv, bpt, _ = jconv.generate_output_coords_and_kernel_map(
            v, kernel_size, out_coords=o, **kwargs
        )
        return oc, onv, bpt.table, bpt.rev

    return jax.jit(fn)(jv, out_coords)


def test_kernel_offsets_match():
    for ks, dil in [(3, 1), (2, 1), (5, 2), ((3, 1, 2), 1)]:
        np.testing.assert_array_equal(tkm.kernel_offsets(ks, dil), jkm.kernel_offsets(ks, dil))
    offs = tkm.kernel_offsets(3)
    assert tkm.identity_offset_index(offs) == jkm.identity_offset_index(offs) == 13
    assert tkm.identity_offset_index(tkm.kernel_offsets(2)) == 0


@pytest.mark.parametrize("ks", [3, 5, 7])
def test_submanifold_tables_match_jax(ks):
    """Lex-sorted scenes, held against the JAX bucketed search (7^3: the
    ConvNeXt block's map); the 3^3 probe is held against the Pallas probe
    in the range-edge test."""
    coords, feats, nv = _pad_batch(_random_scenes(ks), 384)
    tv, jv = _both(coords, feats, nv)
    offs = tkm.kernel_offsets(ks)
    args = (tv.coords, tv.num_valid, tv.coords, tv.num_valid, offs)
    got = tkm.build_pair_tables_batched(*args, assume_sorted=True)
    ref = _jax_tables(
        jv.coords, jv.num_valid, jv.coords, jv.num_valid, offs,
        assume_sorted=True, use_probe=False,
    )
    _assert_eq(got, ref)
    assert (got >= 0).sum() > 3 * int(nv.sum())  # identity + neighbours hit
    assert tracing.counters().get("launches.kernel_map_probe", 0) == 0  # CPU: plain version


def test_unsorted_input_tables_match_jax():
    coords, feats, nv = _pad_batch(_random_scenes(7), 384)
    rng = np.random.default_rng(7)
    for i in range(2):
        coords[i, : nv[i]] = coords[i, rng.permutation(nv[i])]
    offs = tkm.kernel_offsets(3)
    got = tkm.build_pair_tables_batched(
        torch.from_numpy(coords), torch.from_numpy(nv),
        torch.from_numpy(coords), torch.from_numpy(nv), offs,
    )
    ref = _jax_tables(coords, nv, coords, nv, offs, assume_sorted=False, use_probe=False)
    _assert_eq(got, ref)


def _edge_scenes():
    """Voxels at the y and z ends of the valid range, next to the voxels
    that a wrapped (x, y + dy) key would alias (mirrors the JAX probe's
    range-boundary tests)."""
    top = PAD_COORD - 1
    y_edge = np.array(
        [[5, top - 2, 7], [5, top - 1, 7], [5, top, 7], [5, top, 8],
         [6, -top, 7], [6, -top + 1, 7], [6, -top + 4, 7], [4, top, 6]],
        np.int32,
    )
    z_edge = np.array(
        [[2, 3, top], [2, 3, top - 1], [2, 4, top], [2, 4, -top], [2, 5, -top],
         [2, 5, -top + 1], [3, 3, -top], [1, -top, -top], [1, -top + 1, -top]],
        np.int32,
    )
    return [s[np.lexsort((s[:, 2], s[:, 1], s[:, 0]))] for s in (y_edge, z_edge)]


@pytest.mark.parametrize("ks", [3, 5])
def test_range_edge_tables_match_jax(ks):
    """B=2: a y-edge scene and a z-edge scene joined with a random dense
    one. Held against the JAX bucketed search, and for 3^3 also against its
    Pallas probe (interpret mode)."""
    y_edge, z_edge = _edge_scenes()
    scenes = [np.concatenate([y_edge, _random_scenes(ks, b=1)[0]]), z_edge]
    scenes = [s[np.lexsort((s[:, 2], s[:, 1], s[:, 0]))] for s in scenes]
    coords, feats, nv = _pad_batch(scenes, 384)
    offs = tkm.kernel_offsets(ks)
    got = tkm.build_pair_tables_batched(
        torch.from_numpy(coords), torch.from_numpy(nv),
        torch.from_numpy(coords), torch.from_numpy(nv), offs, assume_sorted=True,
    )
    jargs = (coords, nv, coords, nv, offs)
    _assert_eq(got, _jax_tables(*jargs, assume_sorted=False, use_probe=False))
    if ks == 3:
        _assert_eq(got, _jax_tables(*jargs, assume_sorted=True, queries_sorted=True))
    # In-range dy = -1 from (5, top, 7) finds (5, top - 1, 7).
    top = PAD_COORD - 1
    k = int(np.nonzero((offs == [0, -1, 0]).all(1))[0][0])
    row = {tuple(c): i for i, c in enumerate(coords[0, : nv[0]].tolist())}
    assert got[0, k, row[(5, top, 7)]] == row[(5, top - 1, 7)]
    assert (got[0] >= 0).sum() > 3 * int(nv[0])


def test_probe_of_offsets_without_a_grid_matches_the_jax_k5_probe(monkeypatch):
    """The 7-point cross in an order that is no (dx, dy, dz) grid: JAX
    finds no offset grouping and probes each offset with its plain Pallas
    probe (``sorted_probe_batched``, run in interpret mode); the port's
    probe takes any offsets."""
    from warpconvnet_tpu.kernels import sorted_search as jss

    offs = np.array([[1, 0, 0], [0, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0], [0, 1, 0],
                     [0, 0, -1]], np.int32)
    assert jkm._yz_group(offs) is None and jkm._z_group(offs) == 1
    calls = []
    orig = jss.sorted_probe_batched

    def spy(*a, **k):
        calls.append(k.get("interpret"))
        return orig(*a, **k)

    monkeypatch.setattr(jss, "sorted_probe_batched", spy)
    coords, feats, nv = _pad_batch(_random_scenes(6, lo=-5), 384)
    tv, jv = _both(coords, feats, nv)
    args = (tv.coords, tv.num_valid, tv.coords, tv.num_valid)
    got = tkm.build_pair_tables_batched(*args, offs, assume_sorted=True)
    ref = _jax_tables(jv.coords, jv.num_valid, jv.coords, jv.num_valid, offs,
                      assume_sorted=True, queries_sorted=True, use_probe=True)
    assert calls == [True]
    _assert_eq(got, ref)
    assert (got >= 0).sum() > int(nv.sum())


def test_strided_probe_at_range_edge_matches_jax():
    """stride * out + offset with a y past the range on some offsets."""
    top = PAD_COORD - 1
    in_c = np.array([[4, top - 2, 4], [5, top, 5], [5, top - 2, 5], [6, top, 4]], np.int32)
    in_c = in_c[np.lexsort((in_c[:, 2], in_c[:, 1], in_c[:, 0]))]
    out_c = np.array([[2, 16382, 2], [2, 16383, 2]], np.int32)
    ci, _, ni = _pad_batch([in_c, in_c[:2]], 256)
    co, _, no = _pad_batch([out_c, out_c[:1]], 256)
    offs = tkm.kernel_offsets(5)
    got = tkm.build_pair_tables_batched(
        torch.from_numpy(ci), torch.from_numpy(ni), torch.from_numpy(co),
        torch.from_numpy(no), offs, stride=2, assume_sorted=True,
    )
    ref = _jax_tables(ci, ni, co, no, offs, stride=2, assume_sorted=True, use_probe=False)
    _assert_eq(got, ref)
    assert (got >= 0).sum() > 0


@pytest.mark.parametrize("cap", [None, 40])
def test_parity_maps_match_jax(cap):
    """2^3/s2 maps: out coords, num_valid, table and rev; negative coords,
    and a capacity that drops output rows."""
    coords, feats, nv = _pad_batch(_random_scenes(11, grid=20, lo=-9), 384)
    tv, jv = _both(coords, feats, nv)
    oc, onv, bpt, ts = tconv.generate_output_coords_and_kernel_map(
        tv, 2, stride=2, out_capacity=cap
    )
    joc, jonv, jtable, jrev = _jax_map(jv, 2, stride=2, out_capacity=cap)
    assert ts == (2, 2, 2)
    _assert_eq(oc, joc)
    _assert_eq(onv, jonv)
    _assert_eq(bpt.table, jtable)
    _assert_eq(bpt.rev, jrev)
    np.testing.assert_array_equal(bpt.offsets, jkm.kernel_offsets(2))
    # Reversed: the transposed conv's map swaps the tables, negates offsets.
    r = bpt.reversed()
    _assert_eq(r.table, jrev)
    _assert_eq(r.rev, jtable)
    np.testing.assert_array_equal(r.offsets, -jkm.kernel_offsets(2))


def test_submanifold_map_reverse_and_reversed_match_jax():
    coords, feats, nv = _pad_batch(_random_scenes(5), 384)
    tv, _ = _both(coords, feats, nv)
    # Rows are already sorted; without the flag JAX uses its bucketed search.
    jv = JVoxels.create(coords, feats, nv)
    _, _, bpt, _ = tconv.generate_output_coords_and_kernel_map(tv, 3)
    _, _, jtable, jrev = _jax_map(jv, 3)
    assert bpt.self_map and bpt.identity_index == 13
    _assert_eq(bpt.table, jtable)
    _assert_eq(bpt.rev, jrev)  # free K-flip
    _assert_eq(bpt.reversed().table, jrev)
    # The scatter reverse gives the same table as the K-flip.
    _assert_eq(tkm.reverse_tables(bpt.table, tv.max_num_points), jrev)


def test_map_onto_other_coords_with_reverse_matches_jax():
    """Stride-1 map onto a different coordinate set: no K-flip; the reverse
    comes from the scatter (``with_reverse``), N_in != N_out."""
    scenes = _random_scenes(9)
    ci, fi, ni = _pad_batch(scenes, 384)
    co, fo, no = _pad_batch([s[::3] + 1 for s in scenes], 160)
    tv, jv = _both(ci, fi, ni)
    to, _ = _both(co, fo, no)
    # Rows are already sorted; without the flag JAX uses its bucketed search.
    jo = JVoxels.create(co, fo, no)
    _, _, bpt, _ = tconv.generate_output_coords_and_kernel_map(tv, 3, out_coords=to)
    _, _, jtable, jrev = _jax_map(jv, 3, out_coords=jo)
    assert not bpt.self_map
    _assert_eq(bpt.table, jtable)
    _assert_eq(bpt.rev, jrev)
    assert bpt.rev.shape == (2, 27, 384)


def test_pair_table_reverse_matches_jax():
    coords, feats, nv = _pad_batch(_random_scenes(4, b=1), 384)
    offs = tkm.kernel_offsets(3)
    t = tkm.build_pair_tables_batched(
        torch.from_numpy(coords), torch.from_numpy(nv),
        torch.from_numpy(coords[:, ::2]).contiguous(), torch.from_numpy((nv + 1) // 2), offs,
    )[0]
    got = tkm.PairTable(t, offs, 384).reverse()
    ref = jkm.PairTable(jnp.asarray(t.numpy()), offs, 384).reverse()
    _assert_eq(got.table, ref.table)
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    assert got.num_in == ref.num_in == 192
