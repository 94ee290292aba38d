"""Port parity for Volt: small models (volt-s's shape at dim 32, 2 heads,
depth 2, stem 8; volt-blockattn's convblock tokenizer with a token conv
before attention; the interleaved ConvNeXt blocks; LayerScale), eval mode,
with the JAX variables carried over by ``volt_variables_to_state_dict``.
Logits within 1e-4 of JAX's largest logit (fp32), pad rows zero. Also the
variant table, the converter's refusals and the default device."""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from tests.test_torch_attention import _perturbed
from tests.test_torch_sparse_conv import _inputs
from warpconvnet_tpu import constants as jconstants
from warpconvnet_tpu.models import volt as jvolt
from warpconvnet_tpu_torch.models import volt
from warpconvnet_tpu_torch.models.convert import volt_variables_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dim=32, num_heads=2, depth=2, stem_dim=8)


@pytest.fixture(autouse=True)
def jax_explicit(monkeypatch):
    monkeypatch.setattr(jconstants, "WCT_DEPTH_ALGO_MODE", "explicit")


def _pair(variant, seed=50, **overrides):
    cfg = dict(SMALL, **overrides)
    tv, jv = _inputs(seed, n=320, grid=14, c=3)
    jmodel = jvolt.build_volt(variant, 3, 5, **cfg)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jv, train=False))
    variables = _perturbed(variables, seed + 1)
    model = volt.build_volt(variant, 3, 5, **cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(volt_variables_to_state_dict(variables, model))
    return model, tv, jmodel, variables, jv


@pytest.mark.parametrize("variant,overrides", [
    ("volt-s", {}),
    ("volt-blockattn", {}),
    ("volt-s", dict(use_conv_blocks=True, conv_every=1, layer_scale=0.5)),
    ("volt-s", dict(token_capacity=40)),
])
def test_logits_match_jax(variant, overrides):
    model, tv, jmodel, variables, jv = _pair(variant, **overrides)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jv)
    with torch.inference_mode():
        got = model(tv)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    mask = got.valid_mask().numpy()
    g, r = got.features.numpy(), np.asarray(ref.features)
    assert g.dtype == r.dtype == np.float32 and g.shape == r.shape == (2, 320, 5)
    assert np.all(g[~mask] == 0)
    scale = np.abs(r[mask]).max()
    assert scale > 0.1
    np.testing.assert_allclose(g[mask], r[mask], rtol=0, atol=1e-4 * scale)


def test_variant_table_matches_jax():
    assert volt.VOLT_VARIANTS == jvolt.VOLT_VARIANTS


def test_drop_path_is_the_identity_unless_training():
    dp = volt.DropPath(0.5, torch.Generator().manual_seed(0))
    x = torch.ones(8, 3, 2)
    assert torch.equal(dp.eval()(x), x)
    y = dp.train()(x)
    kept = y[:, 0, 0] != 0
    assert 0 < int(kept.sum()) < 8 and bool((y[kept] == 2).all())


def test_converter_refuses_unmapped_and_missing_variables():
    model, _, _, variables, _ = _pair("volt-s")
    params = dict(variables["params"])
    with pytest.raises(KeyError, match="unmapped"):
        volt_variables_to_state_dict({"params": {**params, "extra": {"bias": np.zeros(2)}}}, model)
    del params["fuse"]
    with pytest.raises(KeyError, match="missing"):
        volt_variables_to_state_dict({"params": params}, model)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places tensors on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        volt.build_volt("volt-s", 3, 20, **SMALL)


def test_volt_path_imports_no_jax():
    """Importing the Volt modules and taking one training step of a tiny
    Volt on the CPU (forward, the segment-attention backward, Adam) load
    neither jax nor the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "import warpconvnet_tpu_torch.models.convert, warpconvnet_tpu_torch.kernels.segment_attention\n"
        "from warpconvnet_tpu_torch.geometry.voxels import Voxels\n"
        "from warpconvnet_tpu_torch.models.volt import build_volt\n"
        "from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step\n"
        "rng = np.random.default_rng(0)\n"
        "c = np.unique(rng.integers(0, 12, (300, 3)), axis=0).astype(np.int32)[None]\n"
        "vox = Voxels.create(c, rng.standard_normal(c.shape).astype(np.float32), [c.shape[1]],"
        " device='cpu')\n"
        "model = build_volt('volt-s', 3, 5, dim=16, num_heads=1, depth=1, stem_dim=8,"
        " device='cpu')\n"
        "step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters()), 5)\n"
        "step(vox, torch.zeros(c.shape[:2], dtype=torch.long))\n"
        "assert model.blocks[0].attn.qkv.weight.grad is not None\n"
        "assert 'jax' not in sys.modules and 'warpconvnet_tpu' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)
