"""Port parity for Point Transformer V3: a small model (three levels, heads
of 16 channels, 64-row patches, pad rows in every scene) against the JAX
model in logits, its variables carried over by
``ptv3_variables_to_state_dict``; the Morton order against JAX's
``serialize_patches`` index for index; the port against the benchmark's
plain reference (``benchmark/models/ptv3.py``) at a CPU scale, forward and
one training step; the pad rows' segment ids, which keep K9's visited kv
tiles to those of the valid rows; the orders' cycle and the serialization
counter; and the PTv3 path's independence from JAX."""

import math
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import jax
import pytest
import torch

from benchmark.harness import program, spec, traffic, weights
from benchmark.models import ptv3 as reference
from warpconvnet_tpu.geometry.voxels import Voxels as JVoxels
from warpconvnet_tpu.models.point_transformer_v3 import PointTransformerV3 as JPTv3
from warpconvnet_tpu.nn.modules.attention import serialize_patches as jserialize
from warpconvnet_tpu_torch import tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.models import point_transformer_v3 as ptv3_module
from warpconvnet_tpu_torch.models.convert import ptv3_variables_to_state_dict
from warpconvnet_tpu_torch.models.point_transformer_v3 import PointTransformerV3, build_ptv3
from warpconvnet_tpu_torch.nn.functional.flash_attention import patch_segment_ids
from warpconvnet_tpu_torch.nn.modules.attention import PatchAttention, serialize_patches
from warpconvnet_tpu_torch.ops.keys import PAD_COORD
from warpconvnet_tpu_torch.ops.morton import MORTON_ORDERINGS, ORDER_PERMS
from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(enc_depths=(1, 2, 1), enc_channels=(16, 32, 32), enc_num_head=(1, 2, 2),
             enc_patch_size=(64, 64, 64), dec_depths=(1, 1), dec_channels=(16, 32),
             dec_num_head=(1, 2), dec_patch_size=(64, 64))
# The published depths (22 blocks, five levels) at widths a CPU runs at once.
TINY = dict(enc_channels=(16, 16, 32, 32, 32), enc_num_head=(1, 1, 2, 2, 2),
            dec_channels=(16, 16, 32, 32), dec_num_head=(1, 1, 2, 2))
# The level of each of those 22 blocks, in the order a forward runs them.
LEVELS = (0, 0, 1, 1, 2, 2, 3, 3, 3, 3, 3, 3, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share the cores,
    and these tests run many small ops, which more threads only slow."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(seed, b=2, n=512, grid=10, c=6):
    """Lex-sorted scenes with pad rows (PAD_COORD, features left nonzero,
    so a layer that forgot to mask them would show it)."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, grid, size=(n - 60 * i, 3)), axis=0)
        nv[i] = len(u)
        coords[i, :len(u)] = u
    return coords, feats, nv


def _jax_variables(jmodel, jv, seed):
    """Variables of the JAX model's shapes drawn from numpy (no init
    compile): kernels scaled by their fan-in, biases, LayerNorm and BN
    scales and BN statistics away from their inits, so that a wrong
    mapping shows."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jv, train=False))

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan = math.prod(s.shape[:-1]) if len(s.shape) > 2 else s.shape[0]
            return (rng.standard_normal(s.shape) / math.sqrt(fan)).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.2, s.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)  # scale, var

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_logits_match_jax():
    coords, feats, nv = _scenes(60)
    jv = JVoxels.create(coords, feats, nv)
    tv = Voxels.create(coords, feats, nv, device="cpu").replace(lex_sorted=True)
    jmodel = JPTv3(in_channels=6, out_channels=5, **SMALL)
    variables = _jax_variables(jmodel, jv, 61)
    model = PointTransformerV3(6, 5, **SMALL, device="cpu",
                               generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(ptv3_variables_to_state_dict(variables, model))
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jv)
    with torch.inference_mode():
        got = model(tv)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    mask = got.valid_mask().numpy()
    g, r = got.features.numpy(), np.asarray(ref.features)
    assert g.dtype == r.dtype == np.float32 and g.shape == r.shape == (2, 512, 5)
    assert np.all(g[~mask] == 0) and mask.sum(1).min() > 4 * 64
    scale = np.abs(r[mask]).max()
    assert scale > 0.1
    # fp32 on both sides; sums in other orders over eight blocks and three levels.
    np.testing.assert_allclose(g[mask], r[mask], rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("order", range(6))
def test_morton_order_matches_jax(order):
    """Index for index, valid rows in Morton order and pad rows last in
    their own order, on coordinates with negatives and scenes of
    different sizes."""
    rng = np.random.default_rng(order)
    coords = rng.integers(-40, 300, size=(3, 700, 3)).astype(np.int32)
    nv = np.array([700, 451, 3], np.int32)
    for b, n in enumerate(nv):
        coords[b, n:] = PAD_COORD
    jperm, jinv = jserialize(coords, nv, MORTON_ORDERINGS[order])
    perm, inv = serialize_patches(torch.from_numpy(coords), torch.from_numpy(nv),
                                  ORDER_PERMS[order])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def _small_cell(n_cap=2048):
    cfg = {**spec.config("ptv3"), **{k: list(v) for k, v in TINY.items()}, "patch": 64,
           "n_cap": n_cap}
    mix = {**spec.traffic("train"), "n_points": [500, 900], "pairs": 2, "coord_range": 64}
    pool = traffic.make_pool(mix, 6, 2 ** 31 + 17, "cpu", n_cap)
    feed = traffic.Feed(pool, mix, 2 ** 31 + 17)
    return cfg, feed


def test_matches_the_reference_forward_and_one_training_step():
    """The benchmark's seeded weights in both; the program in fp32 on the
    CPU (plain kernels), the reference in fp32 on the valid cells alone."""
    cfg, feed = _small_cell()
    item = feed(0)
    labels = traffic.labels(torch.Generator().manual_seed(5), 2, cfg["n_cap"], 20, 2.0, "cpu")
    model = build_ptv3(6, 20, patch_size=64, device="cpu", **TINY)
    w = weights.make(reference.param_spec(cfg), 7, "cpu")
    weights.load_into(model, w)
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), 20)
    vox = program.voxels(item, "cpu")
    seen = []
    hook = model.final.register_forward_hook(lambda m, i, o: seen.append(o[0].features.detach()))
    loss = float(step(vox, labels)["loss"])
    hook.remove()

    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    scenes = traffic.scenes_of(item)
    logits = reference.forward(params, scenes, cfg, cfg["n_cap"], True)
    lab = torch.cat([labels[s, :x.shape[0]] for s, x in enumerate(logits)])
    ref_loss = torch.nn.functional.cross_entropy(torch.cat(logits), lab)
    ref_loss.backward()
    # Logits: the same fp32 sums in other orders through 22 blocks.
    for s, x in enumerate(logits):
        x = x.detach()
        torch.testing.assert_close(seen[0][s, :x.shape[0]], x, rtol=0,
                                   atol=1e-5 * float(x.abs().max()))
        assert bool((seen[0][s, x.shape[0]:] == 0).all())
    assert loss == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    # Gradients leaf by leaf, each gap over the larger of the leaf's norm and
    # the median leaf's: the backward sums over every row in another order,
    # and some leaves (biases before a BN, BN's affine leaves) are sums that
    # cancel to near zero, whose own norm would measure rounding alone.
    grads = {k: p.grad for k, p in model.named_parameters()}
    norms = {k: float(p.grad.norm()) for k, p in params.items()}
    median = float(np.median(list(norms.values())))
    gaps = {k: float((grads[k] - p.grad).norm()) / max(norms[k], median)
            for k, p in params.items()}
    assert max(gaps.values()) <= 1e-4, max(gaps, key=gaps.get)


def test_pad_rows_keep_k9_to_the_tiles_of_the_valid_rows():
    """A scene of 100k valid rows padded to 262144 in 1024-row patches:
    K9's visited kv tiles within 1.1x those of the valid rows alone; a pad
    query matches no key."""
    nv, n = 100_000, 262_144
    seg_q, seg_kv = patch_segment_ids(torch.tensor([nv]), n, 1024)
    padded, _ = k9.kv_tiles_visited(seg_q, seg_kv)
    alone, _ = k9.kv_tiles_visited(seg_q[:, :nv], seg_kv[:, :nv])
    assert alone <= padded <= 1.1 * alone, (padded, alone)
    assert torch.equal(seg_q[0, :nv], torch.arange(nv, dtype=torch.int32) // 1024)
    assert not bool(torch.isin(seg_q[0, nv:], seg_kv[0]).any())
    assert int(seg_q[0, nv:].min()) > int(seg_q[0, :nv].max())


def test_each_serialization_is_sorted_once_a_forward():
    """At the published depths, 22 blocks ask for 18 distinct (level,
    order) pairs; each is sorted once."""
    coords, feats, nv = _scenes(3, n=2048, grid=24)
    vox = Voxels.create(coords, feats, nv, device="cpu").replace(lex_sorted=True)
    model = build_ptv3(6, 5, patch_size=64, device="cpu", **TINY).eval()
    assert len({(lv, i % 6) for i, lv in enumerate(LEVELS)}) == 18
    tracing.reset_counters()
    with torch.inference_mode():
        model(vox)
    assert tracing.counters()["serialize.sorts"] == 18


def test_block_i_takes_the_order_i_mod_6():
    """Block i attends in the axis order ``ORDER_PERMS[i % 6]`` of its
    level's coordinates, as the JAX model does without ``order_rng``; the
    first block to ask for a (level, order) pair sorts it, and the later
    ones take that same serialization."""
    coords, feats, nv = _scenes(5, n=2048, grid=24)
    vox = Voxels.create(coords, feats, nv, device="cpu").replace(lex_sorted=True)
    model = build_ptv3(6, 5, patch_size=64, device="cpu", **TINY).eval()
    sorts, used = [], []
    real_sort, real_attn = ptv3_module.serialize_patches, PatchAttention.forward

    def sort(c, num_valid, order):
        out = real_sort(c, num_valid, order)
        sorts.append(((c.shape[1], tuple(order)), out))
        return out

    def attn(self, geometry, serialization):
        used.append(next(key for key, out in sorts if out is serialization))
        return real_attn(self, geometry, serialization)

    with mock.patch.object(ptv3_module, "serialize_patches", sort), \
            mock.patch.object(PatchAttention, "forward", attn), torch.inference_mode():
        model(vox)
    want = [(2048 >> lv, tuple(ORDER_PERMS[i % 6])) for i, lv in enumerate(LEVELS)]
    assert used == want
    assert [key for key, _ in sorts] == list(dict.fromkeys(want))


def test_ptv3_path_imports_no_jax():
    """Importing the PTv3 modules and taking one training step of a tiny
    PTv3 on the CPU (serialization, patch attention and its backward,
    pooling, Adam) load neither jax nor the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "from warpconvnet_tpu_torch.geometry.voxels import Voxels\n"
        "from warpconvnet_tpu_torch.models.point_transformer_v3 import build_ptv3\n"
        "from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step\n"
        "rng = np.random.default_rng(0)\n"
        "c = np.unique(rng.integers(0, 12, (300, 3)), axis=0).astype(np.int32)[None]\n"
        "vox = Voxels.create(c, rng.standard_normal((1, c.shape[1], 6)).astype(np.float32),"
        " [c.shape[1]], device='cpu').lex_sort()\n"
        "model = build_ptv3(6, 5, patch_size=64, enc_depths=(1, 1), enc_channels=(16, 16),"
        " enc_num_head=(1, 1), dec_depths=(1,), dec_channels=(16,), dec_num_head=(1,),"
        " device='cpu')\n"
        "step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters()), 5)\n"
        "step(vox, torch.zeros(c.shape[:2], dtype=torch.long))\n"
        "assert model.enc[0][0].attn.attn.qkv.weight.grad is not None\n"
        "assert 'jax' not in sys.modules and 'warpconvnet_tpu' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)
