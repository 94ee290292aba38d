"""K1's host-side offset grouping (``probe_groups``): every offset in exactly
one (dx, dy) group with its slot k, dz ascending within a group, groups in
lexicographic (dx, dy) order, and, where the JAX package's ``_yz_group``
finds a (dy, dz) grid, the same deltas as that grid."""

import numpy as np
import pytest

from warpconvnet_tpu.ops import kernel_map as jkm
from warpconvnet_tpu_torch.kernels.sorted_search import probe_groups
from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets

CROSS = np.array([[1, 0, 0], [0, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0], [0, 1, 0],
                  [0, 0, -1]], np.int32)

OFFSETS = {
    "3^3": kernel_offsets(3),
    "5^3": kernel_offsets(5),
    "7^3": kernel_offsets(7),
    "3^3 dilation 2": kernel_offsets(3, 2),
    "2^3": kernel_offsets(2),
    "3x1x2": kernel_offsets((3, 1, 2)),
    "cross": CROSS,
    "negated 3^3": -kernel_offsets(3),
    "reversed 5^3": kernel_offsets(5)[::-1],
    "permuted 3^3": kernel_offsets(3)[np.random.default_rng(0).permutation(27)],
    "permuted 5^3 dilation 2": kernel_offsets(5, 2)[np.random.default_rng(1).permutation(125)],
}


@pytest.mark.parametrize("name", list(OFFSETS))
def test_every_offset_in_one_group_with_its_slot(name):
    offs = np.asarray(OFFSETS[name])
    groups, slots = probe_groups(offs)
    assert groups.dtype == slots.dtype == np.int32
    assert slots.shape == (len(offs), 2)
    # Groups tile the slot list in order, each non-empty.
    assert groups[0, 2] == 0 and (groups[:, 3] > 0).all()
    np.testing.assert_array_equal(groups[1:, 2], groups[:-1, 2] + groups[:-1, 3])
    assert groups[-1, 2] + groups[-1, 3] == len(offs)
    # Each slot k once, and each (dx, dy, dz) back at its slot.
    np.testing.assert_array_equal(np.sort(slots[:, 1]), np.arange(len(offs)))
    for dx, dy, first, count in groups:
        dz, k = slots[first:first + count].T
        np.testing.assert_array_equal(offs[k], np.stack([np.full_like(dz, dx),
                                                         np.full_like(dz, dy), dz], 1))
        assert (np.diff(dz) > 0).all()
    # (dx, dy) distinct and in lexicographic order: the kernel's targets rise.
    key = groups[:, 0].astype(np.int64) * (1 << 20) + groups[:, 1]
    assert (np.diff(key) > 0).all()


def test_cross_gives_groups_of_one_to_three():
    groups, slots = probe_groups(CROSS)
    np.testing.assert_array_equal(groups[:, :2], [[-1, 0], [0, -1], [0, 0], [0, 1], [1, 0]])
    np.testing.assert_array_equal(groups[:, 3], [1, 1, 3, 1, 1])
    np.testing.assert_array_equal(slots[2:5], [[-1, 6], [0, 1], [1, 3]])


def test_repeated_offsets_keep_every_slot():
    offs = np.concatenate([CROSS, CROSS[:3]])
    groups, slots = probe_groups(offs)
    np.testing.assert_array_equal(np.sort(slots[:, 1]), np.arange(len(offs)))
    assert (np.diff(slots[:, 0])[groups[2, 2]:groups[2, 2] + groups[2, 3] - 1] >= 0).all()


@pytest.mark.parametrize("name", ["3^3", "5^3", "7^3", "3^3 dilation 2", "2^3", "3x1x2",
                                  "negated 3^3", "reversed 5^3"])
def test_groups_agree_with_jax_yz_group(name):
    offs = np.asarray(OFFSETS[name])
    grid = jkm._yz_group(offs)
    assert grid is not None
    y_deltas, z_deltas = grid
    groups, slots = probe_groups(offs)
    dxs = sorted(set(offs[:, 0].tolist()))
    for dx in dxs:
        mine = groups[groups[:, 0] == dx]
        np.testing.assert_array_equal(mine[:, 1], sorted(y_deltas))
        for _, _, first, count in mine:
            np.testing.assert_array_equal(slots[first:first + count, 0], sorted(z_deltas))
    assert len(groups) == len(dxs) * len(y_deltas)


@pytest.mark.parametrize("name", ["cross", "permuted 3^3"])
def test_offsets_without_a_jax_grid_still_group(name):
    offs = np.asarray(OFFSETS[name])
    assert jkm._yz_group(offs) is None
    groups, _ = probe_groups(offs)
    assert len(groups) == len({(int(x), int(y)) for x, y, _ in offs})
