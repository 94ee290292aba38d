"""Port parity: ``spatially_sparse_conv``, ``BatchNorm`` and ``SparseConv3d``
against the JAX package, fp32 at rtol = atol = 1e-5."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from warpconvnet_tpu.geometry.voxels import Voxels as JVoxels
from warpconvnet_tpu.nn.functional import normalizations as jnorm
from warpconvnet_tpu.nn.functional import sparse_conv as jconv
from warpconvnet_tpu.nn.modules.norms import BatchNorm as JBatchNorm
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.nn.functional import normalizations as tnorm
from warpconvnet_tpu_torch.nn.functional import sparse_conv as tconv
from warpconvnet_tpu_torch.nn.modules.norms import BatchNorm
from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseConv3d
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b=2, n=320, grid=12, c=6):
    """Lex-sorted scenes (np.unique order) with pad features left nonzero,
    so a conv that forgot to mask them would show it."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), PAD_COORD, np.int32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    nv = np.zeros((b,), np.int32)
    for i in range(b):
        u = np.unique(rng.integers(-3, grid, size=(n - 70 * i, 3)), axis=0)
        nv[i] = len(u)
        coords[i, : len(u)] = u
    t = Voxels.create(coords, feats, nv, device="cpu").replace(lex_sorted=True)
    j = JVoxels.create(coords, feats, nv)  # unflagged: JAX's bucketed search
    return t, j


def _w(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) / math.sqrt(shape[0] * shape[1])).astype(np.float32)


def _table_of(result):
    """(voxels, table array or None) from a JAX conv result, for jit."""
    out, bpt = result
    return out, None if bpt is None else bpt.table


def _check(got, ref, valid):
    g = got.features.numpy()
    np.testing.assert_allclose(g, np.asarray(ref.features), **TOL)
    assert np.all(g[~valid.numpy()] == 0)  # pad rows exactly zero
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(ref.num_valid))
    assert got.tensor_stride == tuple(ref.tensor_stride)


@pytest.mark.parametrize("ks", [1, 3])
def test_unit_stride_conv_with_bias_matches_jax(ks):
    tv, jv = _inputs(ks)
    w = _w(1, (ks**3, 6, 10))
    bias = np.linspace(-1, 1, 10).astype(np.float32)
    got, table = tconv.spatially_sparse_conv(
        tv, torch.from_numpy(w), ks, bias=torch.from_numpy(bias)
    )
    ref, jtable = jax.jit(
        lambda v, w, b: _table_of(jconv.spatially_sparse_conv(v, w, ks, bias=b))
    )(jv, jnp.asarray(w), jnp.asarray(bias))
    _check(got, ref, tv.valid_mask())
    if ks == 1:
        assert table is None and jtable is None
    else:
        np.testing.assert_array_equal(table.table.numpy(), np.asarray(jtable))


def test_strided_then_transposed_with_reused_map_matches_jax():
    """2^3/s2 down (capacity below the unique count) and the transposed
    conv back onto the fine coords through the reversed map."""
    tv, jv = _inputs(2)
    wd, wu = _w(2, (8, 6, 12)), _w(3, (8, 12, 5))
    down, table = tconv.spatially_sparse_conv(tv, torch.from_numpy(wd), 2, stride=2, out_capacity=96)
    def jax_down_up(v, wd, wu):
        d, t = jconv.spatially_sparse_conv(v, wd, 2, stride=2, out_capacity=96)
        u, _ = jconv.spatially_sparse_conv(
            d, wu, 2, stride=2, transposed=True, out_coords=v, pair_table=t.reversed()
        )
        return d, u

    jdown, jup = jax.jit(jax_down_up)(jv, jnp.asarray(wd), jnp.asarray(wu))
    _check(down, jdown, down.valid_mask())
    assert down.lex_sorted and down.max_num_points == 96
    up, _ = tconv.spatially_sparse_conv(
        down, torch.from_numpy(wu), 2, stride=2, transposed=True,
        out_coords=tv, pair_table=table.reversed(),
    )
    _check(up, jup, tv.valid_mask())
    assert up.tensor_stride == (1, 1, 1)


def test_transposed_without_map_is_not_ported():
    tv, _ = _inputs(0)
    with pytest.raises(NotImplementedError):
        tconv.spatially_sparse_conv(tv, torch.zeros(8, 6, 4), 2, stride=2, transposed=True)


def test_masked_batch_stats_match_jax():
    tv, jv = _inputs(4)
    mean, var = tnorm.masked_batch_stats(tv.features, tv.valid_mask())
    jmean, jvar = jnorm.masked_batch_stats(jv.features, jv.valid_mask())
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **TOL)


def test_batch_norm_train_and_eval_match_jax():
    """Train: masked batch statistics, running stats updated with momentum
    0.9; eval: the running statistics. Pad rows out of both."""
    tv, jv = _inputs(5)
    rng = np.random.default_rng(5)
    gamma, beta = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    mean0, var0 = rng.normal(size=6).astype(np.float32), rng.uniform(0.5, 2, 6).astype(np.float32)
    jbn = JBatchNorm(6)
    variables = {
        "params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
        "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)},
    }
    bn = BatchNorm(6, device="cpu")
    bn.load_state_dict({"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta),
                        "mean": torch.from_numpy(mean0), "var": torch.from_numpy(var0)})
    jtrain, upd = jbn.apply(variables, jv, use_running_average=False, mutable=["batch_stats"])
    with torch.no_grad():
        train = bn.train()(tv)
    np.testing.assert_allclose(train.features.numpy(), np.asarray(jtrain.features), **TOL)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), **TOL)
    variables["batch_stats"] = upd["batch_stats"]
    jeval = jbn.apply(variables, jv, use_running_average=True)
    with torch.no_grad():
        evl = bn.eval()(tv)
    np.testing.assert_allclose(evl.features.numpy(), np.asarray(jeval.features), **TOL)
    assert np.all(evl.features.numpy()[~tv.valid_mask().numpy()] == 0)


@pytest.mark.parametrize("transposed", [False, True])
def test_sparse_conv3d_init_bounds_match_jax(transposed):
    """Kaiming-uniform bound sqrt(6 / fan), fan = K * C_in (C_out when
    transposed), as the JAX ``_kaiming_uniform``."""
    from warpconvnet_tpu.nn.modules.sparse_conv import _kaiming_uniform

    conv = SparseConv3d(6, 40, 2, stride=2, transposed=transposed, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    jw = _kaiming_uniform(transposed)(jax.random.PRNGKey(0), (8, 6, 40))
    assert tuple(conv.weight.shape) == jw.shape == (8, 6, 40)
    bound = math.sqrt(6.0 / (8 * (40 if transposed else 6)))
    for w in (conv.weight.detach().numpy(), np.asarray(jw)):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    again = SparseConv3d(6, 40, 2, device="cpu", generator=torch.Generator().manual_seed(0)).weight
    if not transposed:
        assert torch.equal(conv.weight, again)  # seeded: reproducible


def test_bf16_accumulation_flag_matches_jax():
    """bf16 compute with bf16 accumulation on both sides (the plain path;
    the CUDA kernel refuses it): each offset's product and each running sum
    round to bf16, so allow a few bf16 ulps (2^-8 relative each)."""
    from warpconvnet_tpu import constants as jconstants
    from warpconvnet_tpu_torch import constants

    tv, jv = _inputs(7)
    w = _w(7, (27, 6, 10))
    try:
        for c in (constants, jconstants):
            c.set_compute_dtype("bfloat16")
            c.set_low_precision_accum(True)
        assert constants.accum_dtype() == torch.bfloat16
        got, _ = tconv.spatially_sparse_conv(tv, torch.from_numpy(w), 3)
        ref, _ = jax.jit(lambda v, w: _table_of(jconv.spatially_sparse_conv(v, w, 3)))(
            jv, jnp.asarray(w)
        )
    finally:
        for c in (constants, jconstants):
            c.set_compute_dtype(None)
            c.set_low_precision_accum(False)
    assert got.features.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.features.float().numpy(), np.asarray(ref.features, np.float32), rtol=3e-2, atol=3e-2
    )
