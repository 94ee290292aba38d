"""Port parity: sort keys and ``Voxels.lex_sort`` against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from warpconvnet_tpu.geometry.voxels import Voxels as JVoxels
from warpconvnet_tpu.ops import keys as jkeys
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.ops import keys as tkeys


def _scenes(seed, b=2, n=384, grid=28, c=4):
    """Shuffled unique coords per scene, PAD rows after num_valid."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), tkeys.PAD_COORD, np.int32)
    feats = np.zeros((b, n, c), np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(-grid // 2, grid, size=(n - 40 * i, 3)), axis=0)
        u = u[rng.permutation(len(u))].astype(np.int32)
        nv[i] = len(u)
        coords[i, : len(u)] = u
        feats[i, : len(u)] = rng.standard_normal((len(u), c))
    return coords, feats, nv


def test_pad_coord_matches():
    assert tkeys.PAD_COORD == jkeys.PAD_COORD


def test_pack_coords_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.integers(-32767, 32768, size=(500, 3)).astype(np.int32)
    hi, lo = tkeys.pack_coords(torch.from_numpy(c))
    jhi, jlo = jkeys.pack_coords(jnp.asarray(c))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_int64_key_order_is_lexicographic():
    rng = np.random.default_rng(1)
    c = rng.integers(-32767, 32768, size=(2000, 3)).astype(np.int32)
    c[:500, 0] = 7  # ties on x and (x, y) exercise the lower words
    c[:250, 1] = -3
    _, perm = tkeys.argsort_keys(tkeys.coord_keys(torch.from_numpy(c)))
    np.testing.assert_array_equal(
        perm.numpy(), np.lexsort((c[:, 2], c[:, 1], c[:, 0]))
    )


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_and_lookup_match_jax(side):
    rng = np.random.default_rng(2)
    keys_c = np.unique(rng.integers(0, 12, size=(300, 3)), axis=0).astype(np.int32)
    q = rng.integers(-1, 13, size=(400, 3)).astype(np.int32)
    q[:50] = keys_c[:50]
    sk = tkeys.coord_keys(torch.from_numpy(keys_c))
    qk = tkeys.coord_keys(torch.from_numpy(q))
    jsk = jkeys.pack_coords(jnp.asarray(keys_c))
    jqk = jkeys.pack_coords(jnp.asarray(q))
    np.testing.assert_array_equal(
        tkeys.searchsorted_keys(sk, qk, side=side).numpy(),
        np.asarray(jkeys.searchsorted_keys(jsk, jqk, side=side)),
    )
    np.testing.assert_array_equal(
        tkeys.lookup_in_sorted(sk, qk).numpy(),
        np.asarray(jkeys.lookup_in_sorted(jsk, jqk)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_lex_sort_matches_jax_exactly(seed):
    coords, feats, nv = _scenes(seed)
    got = Voxels.create(coords, feats, nv).lex_sort()
    ref = JVoxels.create(coords, feats, nv).lex_sort()
    assert got.lex_sorted and ref.lex_sorted
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(ref.features))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(ref.num_valid))
    np.testing.assert_array_equal(got.valid_mask().numpy(), np.asarray(ref.valid_mask()))


def test_voxels_metadata_and_replace():
    coords, feats, nv = _scenes(3, c=2)
    v = Voxels.create(coords, feats, nv, voxel_size=0.5, tensor_stride=2)
    assert v.voxel_size == (0.5, 0.5, 0.5) and v.tensor_stride == (2, 2, 2)
    assert (v.batch_size, v.max_num_points, v.num_channels) == (2, 384, 2)
    assert v.coords.dtype == torch.int32 and v.num_valid.dtype == torch.int32
    w = v.replace_features(torch.zeros(2, 384, 5))
    assert w.num_channels == 5 and w.coords is v.coords
    with pytest.raises(ValueError):
        v.replace_features(torch.zeros(2, 10, 5))
