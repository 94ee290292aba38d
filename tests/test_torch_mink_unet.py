"""Port parity for the slice: a small MinkUNetBase, eval mode, with the JAX
parameters and batch statistics carried over by ``variables_to_state_dict``.

The JAX model runs under ``jax.jit`` on the same lex-sorted rows, left
unflagged so that its maps come from the bucketed search rather than the
slower interpret-mode probe; tests/test_torch_kernel_map.py holds the port's
tables against both."""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from warpconvnet_tpu import constants as jconstants
from warpconvnet_tpu.geometry.voxels import Voxels as JVoxels
from warpconvnet_tpu.models.mink_unet import MinkUNetBase as JMinkUNetBase
from warpconvnet_tpu_torch import constants
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.models.convert import variables_to_state_dict
from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18, MinkUNetBase
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Narrow widths as in tests/models/test_mink_unet.py; two blocks in the
# first and last stages so a stage also reuses its map inside itself.
CONFIG = dict(
    in_channels=3, out_channels=5, planes=(8, 16, 16, 16, 16, 16, 8, 8),
    layers=(2, 1, 1, 1, 1, 1, 1, 2), init_dim=8,
)


def _scenes(seed=0, b=2, n=384, grid=16):
    """Unique coords per scene in random order, PAD rows after num_valid."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = np.zeros((b, n, 3), np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, grid, size=(n - 64 * i, 3)), axis=0)
        u = u[rng.permutation(len(u))]
        nv[i] = len(u)
        coords[i, : len(u)] = u
        feats[i, : len(u)] = rng.standard_normal((len(u), 3))
    return coords, feats, nv


def _seeded_variables(model, jvox, seed=1):
    """Seeded params and non-trivial batch statistics in the JAX tree
    layout (shapes from ``eval_shape``, values from numpy)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), jvox
    )

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.2, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        k, c_in, _ = s.shape
        return (rng.uniform(-1, 1, s.shape) * np.sqrt(6 / (k * c_in))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    coords, feats, nv = _scenes()
    jvox = JVoxels.create(coords, feats, nv).lex_sort().replace(lex_sorted=False)
    jmodel = JMinkUNetBase(**CONFIG)
    variables = _seeded_variables(jmodel, jvox)
    model = MinkUNetBase(**CONFIG, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables, model))
    return model.eval(), Voxels.create(coords, feats, nv, device="cpu"), jmodel, variables, jvox


def _run_both(pair, dtype):
    model, vox, jmodel, variables, jvox = pair
    try:
        constants.set_compute_dtype(dtype)
        jconstants.set_compute_dtype(dtype)
        # A fresh jit per dtype: the compute dtype is read while tracing.
        ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jvox)
        with torch.inference_mode():
            got = model(vox.lex_sort())
    finally:
        constants.set_compute_dtype(None)
        jconstants.set_compute_dtype(None)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    mask = got.valid_mask().numpy()
    g = got.features.float().numpy()
    assert np.all(g[~mask] == 0)
    return g[mask], np.asarray(ref.features, np.float32)[mask]


def test_fp32_logits_match_jax(pair):
    """fp32 on both sides: the same sums in a different order, through
    ~20 conv and BN layers; 1e-4 relative to the largest logit."""
    got, ref = _run_both(pair, None)
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


def test_bf16_logits_match_jax(pair):
    """bf16 compute on both sides: each framework rounds conv, BN and
    residual results to bf16 at different places (XLA fuses elementwise
    chains in fp32), so one-ulp (2^-8) differences compound over the
    layers; bound the relative Frobenius error at 2e-2."""
    got, ref = _run_both(pair, "bfloat16")
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 2e-2, rel


def test_compute_dtype_restored():
    assert constants.get_compute_dtype() is None
    assert jconstants.get_compute_dtype() is None


def test_convert_raises_on_leftover_keys(pair):
    model, _, _, variables, _ = pair
    extra = {**variables, "params": {**variables["params"], "head": {"kernel": np.zeros(3)}}}
    with pytest.raises(KeyError, match="unmapped"):
        variables_to_state_dict(extra)
    short = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "final"}}
    with pytest.raises(KeyError, match="missing"):
        variables_to_state_dict(short, model)


def test_minkunet18_names_follow_the_jax_scopes():
    """Every MinkUNet18 entry is named by a JAX scope the converter maps
    (round trip: port name -> flax path -> port name)."""
    model = MinkUNet18(3, 20, device="cpu")
    names = set(model.state_dict())
    assert len(names) == len(set(model.state_dict(keep_vars=True)))
    inverse = {
        "conv": "SparseConv3d_0", "norm": "BatchNorm_0", "conv1": "SparseConv3d_0",
        "norm1": "BatchNorm_0", "conv2": "SparseConv3d_1", "norm2": "BatchNorm_1",
        "proj": "SparseConv3d_2", "proj_norm": "BatchNorm_2",
    }
    tree = {}
    for name in names:
        *scope, mod, leaf = name.split(".")
        if mod == "final":
            path = ["params", "final", {"weight": "kernel", "bias": "bias"}[leaf]]
        else:
            coll = "batch_stats" if leaf in ("mean", "var") else "params"
            flax_leaf = {"weight": "scale" if "norm" in mod else "kernel"}.get(leaf, leaf)
            path = [coll, "_".join(scope), inverse[mod], flax_leaf]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.zeros(tuple(model.state_dict()[name].shape), np.float32)
    assert set(variables_to_state_dict(tree, model)) == names


def test_port_imports_no_jax():
    code = (
        "import sys, warpconvnet_tpu_torch.models.mink_unet, warpconvnet_tpu_torch.parallel.train, "
        "warpconvnet_tpu_torch.models.convert, warpconvnet_tpu_torch.nn.modules.blocks, "
        "warpconvnet_tpu_torch.nn.functional.sparse_conv_depth, "
        "warpconvnet_tpu_torch.kernels.depthwise_fma; "
        "assert 'jax' not in sys.modules and 'warpconvnet_tpu' not in sys.modules"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)
