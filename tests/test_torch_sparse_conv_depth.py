"""Port parity for the depthwise conv functional and the grouped conv:
``spatially_sparse_depthwise_conv`` forward and ``torch.autograd``
gradients against ``jax.grad`` of the JAX function (its explicit scans on
the CPU), relative Frobenius error <= 1e-5 in fp32 and <= 2e-2 with bf16
features; ``TableConv`` with the depthwise kernels under ``gradcheck``; a spy on the route each map
takes (K8 for a symmetric self-map, K6-dgrad plus K7 otherwise); and
``spatially_sparse_conv(groups=2)`` and the grouped ``SparseConv3d`` against
the JAX grouped conv, fp32 at rtol = atol = 1e-5."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_sparse_conv import _inputs, _w
from warpconvnet_tpu import constants as jconstants
from warpconvnet_tpu.nn.functional import sparse_conv as jconv
from warpconvnet_tpu.nn.functional import sparse_conv_depth as jdepth
from warpconvnet_tpu.nn.modules.sparse_conv import SparseConv3d as JSparseConv3d
from warpconvnet_tpu.nn.modules.sparse_conv import SparseDepthwiseConv3d as JDepthwise
from warpconvnet_tpu_torch.kernels import depthwise_fma
from warpconvnet_tpu_torch.models.convert import conv_variables_to_state_dict
from warpconvnet_tpu_torch.nn.functional import sparse_conv as tconv
from warpconvnet_tpu_torch.nn.functional import sparse_conv_depth as tdepth
from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseConv3d, SparseDepthwiseConv3d

TOL = dict(rtol=1e-5, atol=1e-5)
REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
KINDS = ["sub3", "sub5", "strided", "other"]


@pytest.fixture(autouse=True)
def jax_explicit(monkeypatch):
    """The JAX depthwise conv on its explicit scans (no benchmark-cache
    winner may send it to the Pallas kernels in interpret mode)."""
    monkeypatch.setattr(jconstants, "WCT_DEPTH_ALGO_MODE", "explicit")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _conv_args(kind):
    """(kernel size, stride, port kwargs, JAX kwargs) for one map kind."""
    if kind == "strided":
        return 2, 2, dict(out_capacity=96), dict(out_capacity=96)
    if kind == "other":
        to, jo = _inputs(31, n=200)
        return 3, 1, dict(out_coords=to), dict(out_coords=jo)
    return int(kind[-1]), 1, {}, {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_depthwise_forward_and_grads_match_jax(kind, dtype):
    """d(sum(out * r))/d(features, weight, bias) through both packages."""
    tv, jv = _inputs(21, c=8)
    ks, st, tkw, jkw = _conv_args(kind)
    rng = np.random.default_rng(22)
    w = (rng.standard_normal((ks ** 3, 8)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    feats = tv.features.to(dtype)

    def jax_loss(f, w, b):
        out, _ = jdepth.spatially_sparse_depthwise_conv(
            jv.replace(features=f), w, ks, stride=st, bias=b, **jkw
        )
        return jnp.sum(out.features.astype(jnp.float32) * r), out.features

    x = feats.clone().requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    out, table = tdepth.spatially_sparse_depthwise_conv(
        tv.replace(features=x), tw, ks, stride=st, bias=tb, **tkw
    )
    r = rng.standard_normal(tuple(out.features.shape)).astype(np.float32)
    (out.features.float() * torch.from_numpy(r)).sum().backward()

    jf = jnp.asarray(feats.float().numpy()).astype(JDTYPE[dtype])
    (_, jout), (jdx, jdw, jdb) = jax.jit(
        jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)
    )(jf, jnp.asarray(w), jnp.asarray(bias))
    # An fp32 bias promotes bf16 conv outputs to fp32 in both packages.
    assert str(jout.dtype) == str(out.features.dtype).removeprefix("torch.") == "float32"
    assert table.symmetric_self_map == kind.startswith("sub")
    tol = REL[dtype]
    for got, ref in ((out.features.float(), jout), (x.grad.float(), jdx), (tw.grad, jdw),
                     (tb.grad, jdb)):
        assert _rel(got.detach().numpy(), np.asarray(ref, np.float32)) <= tol
    assert x.grad.dtype == dtype
    if kind in ("strided", "other"):
        want = jdepth.spatially_sparse_depthwise_conv(jv, jnp.asarray(w), ks, stride=st, **jkw)[0]
        np.testing.assert_array_equal(out.coords.numpy(), np.asarray(want.coords))
        np.testing.assert_array_equal(out.num_valid.numpy(), np.asarray(want.num_valid))
        assert out.tensor_stride == tuple(want.tensor_stride)
    assert np.all(out.features.detach().numpy()[~out.valid_mask().numpy()] == 0)


@pytest.mark.parametrize("route", ["fused", "split"])
def test_depthwise_fma_gradcheck_float64(route):
    tv, _ = _inputs(23, n=80, grid=4, c=3)
    vox = tv.replace(features=tv.features.double())
    ks, st = (3, 1) if route == "fused" else (2, 2)
    _, _, bpt, _ = tconv.generate_output_coords_and_kernel_map(vox, ks, stride=st)
    assert bpt.symmetric_self_map == (route == "fused")
    x = vox.features.clone().requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(24).standard_normal((ks ** 3, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w: tconv.table_conv(x, w, bpt, tdepth.DEPTHWISE, torch.float64), (x, w), eps=1e-6, atol=1e-8
    )


@pytest.fixture
def spy(monkeypatch):
    calls = []
    for name in ("depthwise_fma_bwd_fused", "depthwise_fma_dgrad", "depthwise_fma_wgrad"):
        orig = getattr(depthwise_fma, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(depthwise_fma, name, wrapped)
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_backward_route_per_map(spy, kind):
    """A symmetric self-map takes the fused route; strided maps and maps
    onto other coords take K6 as dgrad through rev plus K7."""
    tv, _ = _inputs(25, c=4)
    ks, st, tkw, _ = _conv_args(kind)
    x = tv.features.clone().requires_grad_(True)
    w = torch.from_numpy(_w(1, (ks ** 3, 4))).requires_grad_(True)
    out, _ = tdepth.spatially_sparse_depthwise_conv(tv.replace(features=x), w, ks, stride=st, **tkw)
    assert out.features.grad_fn is not None
    spy.clear()
    out.features.square().sum().backward()
    fused = kind.startswith("sub")
    assert spy == (["depthwise_fma_bwd_fused"] if fused else
                   ["depthwise_fma_dgrad", "depthwise_fma_wgrad"])
    assert bool(torch.isfinite(x.grad).all()) and bool(torch.isfinite(w.grad).all())


def test_no_graph_under_inference_mode_and_strides_not_ported():
    tv, _ = _inputs(26, c=4)
    w = torch.from_numpy(_w(1, (27, 4))).requires_grad_(True)
    with torch.inference_mode():
        out, _ = tdepth.spatially_sparse_depthwise_conv(tv, w, 3)
    assert out.features.grad_fn is None and not out.features.requires_grad
    with pytest.raises(NotImplementedError):
        tdepth.spatially_sparse_depthwise_conv(tv, w, 3, stride=2)


def test_depthwise_module_with_carried_weights_matches_jax():
    tv, jv = _inputs(27, c=8)
    jmod = JDepthwise(channels=8, kernel_size=3, use_bias=True)
    variables = jmod.init(jax.random.PRNGKey(0), jv)
    variables = jax.tree.map(
        lambda a: np.random.default_rng(28).standard_normal(a.shape).astype(np.float32), variables
    )
    mod = SparseDepthwiseConv3d(8, 3, use_bias=True, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    bound = math.sqrt(6.0 / (27 * 8))
    assert 0.9 * bound < float(mod.weight.detach().abs().max()) <= bound
    mod.load_state_dict(conv_variables_to_state_dict(variables, mod))
    with torch.no_grad():
        out, _ = mod(tv)
    ref, _ = jmod.apply(variables, jv)
    np.testing.assert_allclose(out.features.numpy(), np.asarray(ref.features), **TOL)


@pytest.mark.parametrize("flagged", [False, True])
@pytest.mark.parametrize("kind", ["submanifold", "strided"])
def test_grouped_conv_and_grads_match_jax(kind, flagged):
    """groups=2, 6 -> 8 channels, against JAX's grouped scan (its route for
    input not flagged lex-sorted) and its dense conv with the block-diagonal
    weight (the JAX fast path's embedding). The port takes one route for
    flagged and unflagged input."""
    tv, jv = _inputs(29)
    tv = tv.replace(lex_sorted=flagged)
    ks, st = (3, 1) if kind == "submanifold" else (2, 2)
    k = ks ** 3
    wg = _w(30, (k, 2, 3, 4))
    wfull = np.zeros((k, 6, 8), np.float32)
    wfull[:, :3, :4], wfull[:, 3:, 4:] = wg[:, 0], wg[:, 1]
    kw = dict(out_capacity=96) if kind == "strided" else {}
    rng = np.random.default_rng(31)

    x = tv.features.clone().requires_grad_(True)
    tw = torch.from_numpy(wg).requires_grad_(True)
    out, _ = tconv.spatially_sparse_conv(tv.replace(features=x), tw, ks, stride=st, groups=2, **kw)
    r = rng.standard_normal(tuple(out.features.shape)).astype(np.float32)
    (out.features * torch.from_numpy(r)).sum().backward()

    def jax_loss(f, w, groups):
        o, _ = jconv.spatially_sparse_conv(jv.replace(features=f), w, ks, stride=st,
                                           groups=groups, **kw)
        return jnp.sum(o.features * r), o.features

    (_, jout), (jdx, jdw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jv.features, jnp.asarray(wg), 2
    )
    dense = jax.value_and_grad(jax_loss, argnums=0, has_aux=True)(
        jv.features, jnp.asarray(wfull), 1
    )
    np.testing.assert_allclose(out.features.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(out.features.detach().numpy(), np.asarray(dense[0][1]), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)
    assert tuple(tw.grad.shape) == wg.shape


def test_grouped_module_with_carried_weights_matches_jax():
    """``SparseConv3d(groups=2)``: weight [K, G, C_in/G, C_out/G] with the
    per-group kaiming bound, and the JAX variables carried over give the
    JAX module's output."""
    tv, jv = _inputs(32)
    jmod = JSparseConv3d(in_channels=6, out_channels=8, kernel_size=3, groups=2, use_bias=True)
    variables = jmod.init(jax.random.PRNGKey(0), jv)
    variables = jax.tree.map(
        lambda a: np.random.default_rng(33).standard_normal(a.shape).astype(np.float32) * 0.3,
        variables,
    )
    mod = SparseConv3d(6, 8, 3, groups=2, use_bias=True, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert tuple(mod.weight.shape) == (27, 2, 3, 4)
    bound = math.sqrt(6.0 / (27 * 3))
    assert 0.9 * bound < float(mod.weight.detach().abs().max()) <= bound
    mod.load_state_dict(conv_variables_to_state_dict(variables, mod))
    with torch.no_grad():
        out, _ = mod(tv)
    ref, _ = jmod.apply(variables, jv)
    np.testing.assert_allclose(out.features.numpy(), np.asarray(ref.features), **TOL)
    with pytest.raises(KeyError, match="unmapped"):
        conv_variables_to_state_dict({"params": {"scale": np.zeros(8)}})
