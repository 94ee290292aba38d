"""Synthetic voxel scenes (the generator of ``bench.py:43-56``, copied so
the port does not import the JAX benchmark)."""

from __future__ import annotations

import numpy as np


def make_surface_scene(rng, n_cap, coord_range=512, n_points=120_000):
    """Surface-like voxel scene: sample (x, y) columns of a smooth
    heightfield with jitter, for ScanNet-like local density. Returns at most
    ``n_cap`` unique int32 coords [n, 3]: all of them in lexicographic
    order, or a random subset in random order."""
    xy = rng.integers(0, coord_range, size=(n_points, 2))
    z = (
        coord_range // 2
        + 60.0 * np.sin(xy[:, 0] / 37.0) * np.cos(xy[:, 1] / 29.0)
        + rng.normal(0, 1.5, n_points)
    ).astype(np.int32)
    coords = np.concatenate([xy, z[:, None]], axis=1).astype(np.int32)
    coords = np.unique(coords, axis=0)
    if len(coords) > n_cap:
        coords = coords[rng.permutation(len(coords))[:n_cap]]
    return coords
