"""Port parity for ``SparseConvNeXtBlock``: the JAX block's variables,
carried over by ``convnext_block_variables_to_state_dict``, give the same
output (fp32: relative Frobenius error <= 1e-5, and the same dtype; bf16
features: <= 2e-2) and the same gradients of ``sum(out ** 2)`` for every
parameter and the input (fp32: within 1e-4 of each tensor's largest
value), at C=16 with kernel 3 and 7. Also the default device and the
converter's refusals."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_sparse_conv import _inputs
from warpconvnet_tpu import constants as jconstants
from warpconvnet_tpu.nn.modules.blocks import SparseConvNeXtBlock as JBlock
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.models.convert import convnext_block_variables_to_state_dict
from warpconvnet_tpu_torch.nn.modules.blocks import SparseConvNeXtBlock

C = 16


@pytest.fixture(autouse=True)
def jax_explicit(monkeypatch):
    monkeypatch.setattr(jconstants, "WCT_DEPTH_ALGO_MODE", "explicit")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _pair(kernel_size, seed=40):
    """Port block and JAX block with the same seeded variables. The layer
    scale is overwritten with values of order 0.5 (its init of 1e-6 would
    hide the MLP branch's gradients), LayerNorm and Dense biases too."""
    tv, jv = _inputs(seed, c=C)
    jblock = JBlock(channels=C, kernel_size=kernel_size)
    variables = jax.device_get(jblock.init(jax.random.PRNGKey(0), jv))
    rng = np.random.default_rng(seed + 1)
    params = dict(variables["params"])
    params["layer_scale"] = rng.uniform(0.3, 0.7, C).astype(np.float32)
    params["LayerNorm_0"] = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                             "bias": rng.normal(0, 0.2, C).astype(np.float32)}
    for name in ("Dense_0", "Dense_1"):
        d = dict(params[name])
        d["bias"] = rng.normal(0, 0.2, d["bias"].shape).astype(np.float32)
        params[name] = d
    variables = {"params": params}
    block = SparseConvNeXtBlock(C, kernel_size, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    block.load_state_dict(convnext_block_variables_to_state_dict(variables, block))
    return block, tv, jblock, variables, jv


@pytest.mark.parametrize("kernel_size", [3, 7])
def test_block_forward_and_grads_match_jax(kernel_size):
    block, tv, jblock, variables, jv = _pair(kernel_size)

    def jax_loss(v, f):
        out = jblock.apply(v, jv.replace(features=f))
        return jnp.sum(out.features.astype(jnp.float32) ** 2), out.features

    (_, jout), (jgrads, jdx) = jax.jit(
        jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)
    )(variables, jv.features)
    x = tv.features.clone().requires_grad_(True)
    out = block(tv.replace(features=x))
    (out.features.float() ** 2).sum().backward()

    assert str(jout.dtype) == str(out.features.dtype).removeprefix("torch.")
    assert _rel(out.features.detach().numpy(), jout) <= 1e-5
    assert np.all(out.features.detach().numpy()[~tv.valid_mask().numpy()] == 0)
    ref = convnext_block_variables_to_state_dict(jgrads, block)
    ref["input"] = torch.from_numpy(np.array(jdx))
    got = {n: p.grad for n, p in block.named_parameters()}
    got["input"] = x.grad
    assert set(got) == set(ref)
    for name, g in got.items():
        want = ref[name].numpy()
        assert g is not None and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kernel_size", [3, 7])
def test_block_bf16_features_match_jax(kernel_size):
    """bf16 features: the depthwise conv stays bf16, LayerNorm onwards runs
    in fp32 as flax promotes it, and both outputs are fp32."""
    block, tv, jblock, variables, jv = _pair(kernel_size, seed=42)
    xb = tv.features.to(torch.bfloat16)
    jf = jnp.asarray(tv.features.numpy()).astype(jnp.bfloat16)
    ref = jax.jit(lambda v, f: jblock.apply(v, jv.replace(features=f)).features)(variables, jf)
    with torch.no_grad():
        out = block(tv.replace(features=xb)).features
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
    assert _rel(out.numpy(), ref) <= 2e-2


def test_converter_refuses_unmapped_and_missing_variables():
    block, _, _, variables, _ = _pair(3)
    extra = {"params": {**variables["params"], "Dense_2": {"bias": np.zeros(C, np.float32)}}}
    with pytest.raises(KeyError, match="unmapped"):
        convnext_block_variables_to_state_dict(extra, block)
    short = {"params": {k: v for k, v in variables["params"].items() if k != "layer_scale"}}
    with pytest.raises(KeyError, match="missing"):
        convnext_block_variables_to_state_dict(short, block)


def test_entry_points_default_to_the_card():
    """Without a device argument the entry points ask for CUDA: with no card
    they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places tensors on it")
    coords = np.zeros((1, 4, 3), np.int32)
    feats = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Voxels.create(coords, feats, [4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseConvNeXtBlock(C, 3)
    assert Voxels.create(coords, feats, [4], device="cpu").features.device.type == "cpu"

