"""Port parity for the conv backward: ``TableConv`` with the dense kernels
(the counterpart of the JAX ``conv_gemm`` custom_vjp) under
``torch.autograd.gradcheck``, and the
gradients of ``spatially_sparse_conv`` against ``jax.grad`` of the JAX
``spatially_sparse_conv`` (explicit backends on the CPU), fp32 at rtol =
atol = 1e-5. A spy shows which backward each map takes: the fused K4 for a
symmetric self-map, K2-dgrad plus K3 for every other map."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_sparse_conv import _inputs, _w
from warpconvnet_tpu.nn.functional import sparse_conv as jconv
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import implicit_gemm
from warpconvnet_tpu_torch.nn.functional import sparse_conv as tconv
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny_maps():
    """A 3^3 self-map and a 2^3/s2 map over two small float64 scenes."""
    rng = np.random.default_rng(0)
    b, n = 2, 24
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(0, 4, size=(n - 4 * i, 3)), axis=0)
        nv[i] = len(u)
        coords[i, : len(u)] = u
    feats = rng.standard_normal((b, n, 3))
    vox = Voxels.create(coords, feats, nv, device="cpu").lex_sort()
    _, _, sub, _ = tconv.generate_output_coords_and_kernel_map(vox, 3)
    _, _, down, _ = tconv.generate_output_coords_and_kernel_map(vox, 2, stride=2)
    return vox, {"fused": sub, "split": down}


@pytest.mark.parametrize("route", ["fused", "split"])
def test_conv_gemm_gradcheck_float64(route):
    vox, maps = _tiny_maps()
    bpt = maps[route]
    assert bpt.symmetric_self_map == (route == "fused")
    k = bpt.table.shape[1]
    rng = np.random.default_rng(1)
    x = vox.features.clone().requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((k, 3, 4)) / math.sqrt(k * 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w: tconv.table_conv(x, w, bpt, tconv.DENSE, torch.float64), (x, w), eps=1e-6, atol=1e-8
    )


@pytest.mark.parametrize("kind", ["submanifold", "strided", "transposed"])
def test_conv_grads_match_jax_grad(kind):
    """d(sum(out * r))/d(features, weight, bias) for a 3^3 submanifold conv, a
    2^3/s2 conv (capacity below the unique count) and the transposed conv
    back onto the fine coords through the reversed map."""
    tv, jv = _inputs(11)
    rng = np.random.default_rng(12)
    wd = _w(2, (8, 6, 7))
    k, c_in, c_out = {"submanifold": (27, 6, 10), "strided": (8, 6, 7), "transposed": (8, 7, 5)}[kind]
    w = _w(3, (k, c_in, c_out))
    bias = rng.standard_normal(c_out).astype(np.float32)

    if kind == "transposed":
        down, table = tconv.spatially_sparse_conv(tv, torch.from_numpy(wd), 2, stride=2, out_capacity=96)
        coarse = rng.standard_normal((2, 96, c_in)).astype(np.float32)
        src = down.replace(features=torch.from_numpy(coarse))
        n_out = tv.max_num_points
    else:
        src, n_out = tv, (tv.max_num_points if kind == "submanifold" else 96)
    r = rng.standard_normal((2, n_out, c_out)).astype(np.float32)

    def jax_loss(feats, w, b):
        if kind == "transposed":
            d, t = jconv.spatially_sparse_conv(jv, jnp.asarray(wd), 2, stride=2, out_capacity=96)
            out, _ = jconv.spatially_sparse_conv(
                d.replace(features=feats), w, 2, stride=2, transposed=True,
                out_coords=jv, pair_table=t.reversed(), bias=b,
            )
        elif kind == "strided":
            out, _ = jconv.spatially_sparse_conv(
                jv.replace(features=feats), w, 2, stride=2, out_capacity=96, bias=b
            )
        else:
            out, _ = jconv.spatially_sparse_conv(jv.replace(features=feats), w, 3, bias=b)
        return jnp.sum(out.features * r)

    jfeats = jnp.asarray(coarse) if kind == "transposed" else jv.features
    jdx, jdw, jdb = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jfeats, jnp.asarray(w), jnp.asarray(bias)
    )

    x = src.features.clone().requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    kw = {}
    if kind == "transposed":
        kw = dict(transposed=True, out_coords=tv, pair_table=table.reversed())
    elif kind == "strided":
        kw = dict(out_capacity=96)
    out, _ = tconv.spatially_sparse_conv(
        src.replace(features=x), tw, 3 if kind == "submanifold" else 2,
        stride=1 if kind == "submanifold" else 2, bias=tb, **kw,
    )
    (out.features * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **TOL)


@pytest.fixture
def spy(monkeypatch):
    calls = []
    for name in ("implicit_gemm_bwd_fused", "implicit_gemm_dgrad", "implicit_gemm_wgrad"):
        orig = getattr(implicit_gemm, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(implicit_gemm, name, wrapped)
    return calls


@pytest.mark.parametrize("kind", ["submanifold", "strided", "transposed"])
def test_backward_route_per_map(spy, kind):
    """The self-map conv takes the fused route, strided and transposed
    convs the split route, and every conv's output keeps a grad_fn."""
    tv, _ = _inputs(13)
    w = lambda seed, shape: torch.from_numpy(_w(seed, shape)).requires_grad_(True)  # noqa: E731
    x = tv.features.clone().requires_grad_(True)
    src = tv.replace(features=x)
    if kind == "submanifold":
        out, _ = tconv.spatially_sparse_conv(src, w(1, (27, 6, 4)), 3)
        want = ["implicit_gemm_bwd_fused"]
    else:
        out, table = tconv.spatially_sparse_conv(src, w(1, (8, 6, 4)), 2, stride=2)
        want = ["implicit_gemm_dgrad", "implicit_gemm_wgrad"]
        if kind == "transposed":
            src = out.replace(features=out.features.detach().requires_grad_(True))
            x = src.features
            out, _ = tconv.spatially_sparse_conv(
                src, w(2, (8, 4, 6)), 2, stride=2, transposed=True,
                out_coords=tv, pair_table=table.reversed(),
            )
    assert out.features.grad_fn is not None
    spy.clear()
    out.features.square().sum().backward()
    assert spy == want
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_no_graph_under_inference_mode():
    tv, _ = _inputs(14)
    w = torch.from_numpy(_w(1, (27, 6, 4))).requires_grad_(True)
    with torch.inference_mode():
        out, _ = tconv.spatially_sparse_conv(tv, w, 3)
    assert out.features.grad_fn is None and not out.features.requires_grad
    with torch.no_grad():
        ref, _ = tconv.spatially_sparse_conv(tv, w, 3)
    assert torch.equal(out.features, ref.features)
