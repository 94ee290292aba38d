"""The one traffic generator: it reads a mix's parameters
(``benchmark/traffic/<mix>.json``) and makes, from the seed, a pool of
scene batches and the feed of augmented batches that steps or requests
consume.

A mix file holds: ``kind`` (``train``: training steps back to back;
``infer``: forward requests, closed loop, one client), ``batch`` (scenes a
step or request), ``pairs`` (batches in the pool), ``n_points`` ([low, high]: the pool's ``batch * pairs`` scenes
take evenly spaced surface sample counts in this range, in a seeded
order), ``coord_range`` (the scenes' x and y extent, a power of two) and
``augment`` (``translate_step``, ``translate_max``); a train mix also
``label_skew`` (see ``labels``). The padded rows a scene, ``n_cap``, are
the configuration's.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (any int up to 2**63)."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 1 << 62)))
    return g


def make_surface_scene(rng, n_cap, coord_range=512, n_points=120_000):
    """Surface-like voxel scene: sample (x, y) columns of a smooth
    heightfield with jitter, for ScanNet-like local density. Returns at most
    ``n_cap`` unique int32 coords [n, 3]: all of them in lexicographic
    order, or a random subset in random order.

    Copied from ``warpconvnet_tpu_torch/utils/scenes.py`` (itself the
    generator of ``bench.py:43-56``)."""
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


def labels(gen: torch.Generator, batch: int, n_cap: int, classes: int, skew: float,
           device) -> torch.Tensor:
    """[batch, n_cap] class labels of one step: each scene draws its own
    class frequencies, ``E ** skew`` normalised (E exponential; 0 gives
    every class alike), and each row's label from them, as the rooms of a
    scan differ in what they hold. Scenes whose frequencies differ pull the
    update apart, so that a step which learns from part of its batch shows."""
    w = torch.empty(batch, classes, device=device).exponential_(generator=gen) ** skew
    return torch.multinomial(w, n_cap, replacement=True, generator=gen)


class Pool(NamedTuple):
    """``pairs`` batches on the device: coords [P, B, n_cap, 3] int32 (rows
    past ``num_valid`` are 0), features [P, B, n_cap, C] fp32, num_valid
    [P, B] int32; ``sizes`` the valid rows on the host."""

    coords: torch.Tensor
    features: torch.Tensor
    num_valid: torch.Tensor
    sizes: List[List[int]]


def make_pool(mix: dict, channels: int, seed: int, device, n_cap: int) -> Pool:
    b, pairs = mix["batch"], mix["pairs"]
    lo, hi = mix["n_points"]
    r = rng(seed, 1)
    counts = np.linspace(lo, hi, b * pairs).round().astype(int)[r.permutation(b * pairs)]
    coords = np.zeros((pairs, b, n_cap, 3), np.int32)
    feats = np.zeros((pairs, b, n_cap, channels), np.float32)
    nv = np.zeros((pairs, b), np.int32)
    for i, n_points in enumerate(counts):
        p, s = divmod(i, b)
        c = make_surface_scene(r, n_cap, mix["coord_range"], int(n_points))
        nv[p, s] = len(c)
        coords[p, s, : len(c)] = c
        feats[p, s, : len(c)] = r.standard_normal((len(c), channels))
    return Pool(torch.from_numpy(coords).to(device), torch.from_numpy(feats).to(device),
                torch.from_numpy(nv).to(device), nv.tolist())


class Item(NamedTuple):
    """One step's or request's input: ``entry`` is its pool batch."""

    entry: int
    coords: torch.Tensor  # [B, n_cap, 3] int32, augmented
    features: torch.Tensor  # [B, n_cap, C]
    num_valid: torch.Tensor  # [B]


class Feed:
    """Item i takes pool batch ``order[i % pairs]`` (a seeded order) and
    augments each scene on the device: x -> R-1-x and y -> R-1-y (R the
    coordinate range, a power of two), an x/y swap, and a translation of x
    and y by a multiple of ``translate_step`` below ``translate_max``, each
    drawn from the seed. With R and the step powers of two at least 16,
    every stride-2**l level (l <= 4) and every 4^3 patch keep their cells
    up to relabelling, so the pool's work counts hold for each item (where
    no capacity drops a cell, as set-up makes sure). Windows anchored at
    the minimum of a level's cells (``window_attn``) keep their partition
    under the translation and the swap; under a flip only where the scene
    spans [0, R-1] in that axis, as the heightfield scenes do: set-up
    counts each window sum flipped too and refuses a pool on which a flip
    changes one (``work.flip_dependent``)."""

    def __init__(self, pool: Pool, mix: dict, seed: int):
        self.pool = pool
        self.mix = mix
        self.seed = seed
        self.order = rng(seed, 2).permutation(len(pool.sizes)).tolist()

    def entry(self, i: int) -> int:
        return self.order[i % len(self.order)]

    def __call__(self, i: int) -> Item:
        p = self.pool
        e = self.entry(i)
        aug = self.mix["augment"]
        b = p.coords.shape[1]
        r = rng(self.seed, 3, i)
        flips = r.integers(0, 2, size=(b, 2))
        swap = r.integers(0, 2, size=b)
        step = aug["translate_step"]
        shift = r.integers(0, aug["translate_max"] // step, size=(b, 2)) * step
        dev = p.coords.device
        c = p.coords[e]
        top = self.mix["coord_range"] - 1
        flips_t = torch.as_tensor(flips, device=dev, dtype=torch.bool)[:, None, :]
        xy = torch.where(flips_t, top - c[..., :2], c[..., :2])
        swap_t = torch.as_tensor(swap, device=dev, dtype=torch.bool)[:, None, None]
        xy = torch.where(swap_t, xy.flip(-1), xy)
        xy = xy + torch.as_tensor(shift, device=dev, dtype=torch.int32)[:, None, :]
        coords = torch.cat([xy, c[..., 2:]], dim=-1)
        return Item(e, coords, p.features[e], p.num_valid[e])


def scenes_of(item: Item) -> List[tuple]:
    """The item's scenes for a reference: (coords, features) of the valid
    rows, in lexicographic order (sorted by the benchmark itself)."""
    from benchmark.models.sparse import lex_order

    out = []
    for s in range(item.coords.shape[0]):
        n = int(item.num_valid[s])
        c = item.coords[s, :n].to(torch.int64)
        perm = lex_order(c)
        out.append((c[perm], item.features[s, :n][perm].float()))
    return out
