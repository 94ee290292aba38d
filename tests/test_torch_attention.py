"""Port parity for the attention layers: ``masked_sdpa``, ``rope_3d_phases``,
``apply_rope``, ``BatchedLinear``, and ``Attention``, ``FeedForward`` and
``TransformerBlock`` with the JAX variables carried over, against the JAX
package in fp32 within 1e-5 (rtol and atol)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from warpconvnet_tpu.nn.functional import attention as jattn
from warpconvnet_tpu.nn.modules import attention as jmod
from warpconvnet_tpu.nn.modules.mlp import BatchedLinear as JBatchedLinear
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.models import convert
from warpconvnet_tpu_torch.nn.functional import attention as tattn
from warpconvnet_tpu_torch.nn.modules.attention import Attention, FeedForward, TransformerBlock
from warpconvnet_tpu_torch.nn.modules.mlp import BatchedLinear, Linear

TOL = dict(rtol=1e-5, atol=1e-5)
C, H = 24, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturbed(params, seed):
    """JAX params with biases, LayerNorm scales drawn from numpy (their
    inits, zeros and ones, would hide a wrong mapping)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def _load(module, params, scope):
    """Carry a JAX Attention / FeedForward / TransformerBlock's params onto
    the port module through the converter's VoltBlock table, ``scope``
    being the module's place in a block ("attn", "mlp" or none)."""
    state = {}
    for path, value in convert._flatten(params["params"]):
        name, transpose = convert._VOLT_BLOCK[tuple(p for p in (scope,) if p) + path]
        state[name.removeprefix(f"{scope}.") if scope else name] = convert._leaf(value, transpose)
    module.load_state_dict(state)
    return module


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_masked_sdpa_matches_jax():
    q, k, v = (_x(i, (2, 12, H, 8)) for i in range(3))
    rv = np.arange(12)[None, :] < np.array([[9], [12]])
    pair = (np.arange(12)[:, None] // 4 == np.arange(12)[None, :] // 4)[None].repeat(2, 0)
    pair[0, 5] = False  # a query row with no valid key gives 0
    ref = jattn.masked_sdpa(*map(jnp.asarray, (q, k, v, rv, rv, pair)))
    got = tattn.masked_sdpa(*map(_t, (q, k, v, rv, rv, pair)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert np.all(got.numpy()[0, 5] == 0)


@pytest.mark.parametrize("head_dim", [8, 10, 16])
def test_rope_matches_jax(head_dim):
    coords = np.random.default_rng(head_dim).integers(-40, 40, (2, 7, 3)).astype(np.int32)
    jcos, jsin = jattn.rope_3d_phases(jnp.asarray(coords), head_dim)
    cos, sin = tattn.rope_3d_phases(_t(coords), head_dim)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    x = _x(1, (2, 7, head_dim))
    ref = jattn.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(tattn.apply_rope(_t(x), cos, sin).numpy(), np.asarray(ref), **TOL)


def test_batched_linear_matches_jax():
    x = _x(2, (2, 5, C))
    jlin = JBatchedLinear(3, 16)
    params = _perturbed(jlin.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    lin = BatchedLinear(3, C, 16, device="cpu")
    lin.load_state_dict({"weight": _t(params["params"]["kernel"]),
                         "bias": _t(params["params"]["bias"])})
    ref = jlin.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(lin(_t(x)).detach().numpy(), np.asarray(ref), **TOL)


def test_linear_masks_pad_rows():
    vox = Voxels.create(np.zeros((1, 4, 3), np.int32), _x(4, (1, 4, 6)), [3], device="cpu")
    out = Linear(6, 5, device="cpu", generator=torch.Generator().manual_seed(0))(vox)
    assert tuple(out.features.shape) == (1, 4, 5) and bool((out.features[0, 3] == 0).all())
    assert not bool((out.features[0, :3] == 0).all())
    assert bool((vox.mask_features().features[0, 3] == 0).all())


def _attention_inputs(case):
    rng = np.random.default_rng(7)
    x = _x(8, (2, 3, 16, C) if case == "patches" else (2, 20, C))
    lead = x.shape[:-1]
    rv = rng.random(lead) < 0.8
    rv[..., 0] = True
    coords = rng.integers(-9, 9, lead + (3,)).astype(np.int32)
    kw = {"row_valid": rv, "coords": coords}
    if case == "pair_mask":
        grp = np.arange(lead[-1]) // 5
        kw["pair_mask"] = np.broadcast_to(grp[:, None] == grp[None, :], lead + lead[-1:]).copy()
    elif case == "segment_ids":
        kw["segment_ids"] = np.broadcast_to(np.arange(lead[-1]) // 6, lead).astype(np.int32)
    elif case == "all_rows":
        kw = {"coords": coords}
    return x, kw


@pytest.mark.parametrize("case", ["row_valid", "pair_mask", "segment_ids", "all_rows", "patches"])
def test_attention_matches_jax(case):
    x, kw = _attention_inputs(case)
    jatt = jmod.Attention(C, H, rope_base=100.0)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = _perturbed(jatt.init(jax.random.PRNGKey(1), jnp.asarray(x), **jkw), 9)
    ref = jatt.apply(params, jnp.asarray(x), **jkw)
    att = _load(Attention(C, H, rope_base=100.0, device="cpu"), params, "attn")
    got = att(_t(x), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_feed_forward_matches_jax():
    x = _x(10, (2, 9, C))
    jff = jmod.FeedForward(C)
    params = _perturbed(jff.init(jax.random.PRNGKey(2), jnp.asarray(x)), 11)
    ff = _load(FeedForward(C, device="cpu"), params, "mlp")
    np.testing.assert_allclose(ff(_t(x)).detach().numpy(), np.asarray(jff.apply(params, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("rope", [None, 100.0])
def test_transformer_block_matches_jax(rope):
    x, kw = _attention_inputs("row_valid")
    jblock = jmod.TransformerBlock(C, H, rope_base=rope)
    args = (jnp.asarray(x), jnp.asarray(kw["row_valid"]), jnp.asarray(kw["coords"]))
    params = _perturbed(jblock.init(jax.random.PRNGKey(3), *args), 12)
    block = _load(TransformerBlock(C, H, rope_base=rope, device="cpu"), params, None)
    got = block(_t(x), _t(kw["row_valid"]), _t(kw["coords"])).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jblock.apply(params, *args)), **TOL)
    assert np.all(got[~kw["row_valid"]] == 0)


@pytest.mark.parametrize("r", [10.0, 1000.0])
def test_layer_norm_variance_against_float64(r):
    """The port's LayerNorm on fp32 rows r + N(0, 1) (C 384) against a
    float64 LayerNorm of the same fp32 inputs, within a bound: 1e-5 at
    r = 10 (measured 1.9e-6); 2e-4 at r = 1000 (measured 8.7e-5), where
    the fp32 mean of rows near 1000 rounds by about that much on its own.
    A one-pass fp32 variance, E[x^2] - E[x]^2, reads 5.6e-5 at r = 10 and
    4.0e-4 already at r = 30 (0.38 at r = 1000), so each bound rejects it.
    flax 0.12.3's ``nn.LayerNorm``, which the JAX models use, takes the
    variance that way and cancels: its gap, recorded here, is 7.1e-5 at
    r = 10 and 0.78 at r = 1000 (0.87 on other rows). The port keeps the
    two-pass variance, so the JAX models and the port part beyond fp32
    tolerance once a row's mean is about 10x its std."""
    from flax import linen as nn

    from warpconvnet_tpu_torch.nn.modules.norms import LayerNorm

    bound = {10.0: 1e-5, 1000.0: 2e-4}[r]
    x = (r + np.random.default_rng(0).standard_normal((64, 384))).astype(np.float32)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)
    with torch.no_grad():
        got = LayerNorm(384, device="cpu")(_t(x)).numpy()
    mean = x.mean(-1, keepdims=True, dtype=np.float32)
    one_pass_var = np.maximum((x * x).mean(-1, keepdims=True, dtype=np.float32) - mean * mean, 0)
    one_pass = (x - mean) / np.sqrt(one_pass_var + np.float32(1e-6))
    flax_ln = nn.LayerNorm(epsilon=1e-6)
    flax_out = np.asarray(flax_ln.apply(flax_ln.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                        jnp.asarray(x)))
    port_gap = np.abs(got - want).max()
    flax_gap = np.abs(flax_out - want).max()
    assert port_gap <= bound < np.abs(one_pass - want).max()
    assert flax_gap > port_gap
    assert r < 1000 or flax_gap > 0.1
