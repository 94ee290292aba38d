"""Port parity for sparse pooling: ``sparse_reduce`` (max, min, sum, mean)
on the 4^3 / stride-4 parity map (Volt's patch tokenizer), the 2^3 /
stride-2 map and a 3^3 stride-1 map, ``sparse_unpool`` with
``concat_features``, and ``global_pool``, against the JAX package. Tables,
reverse tables, coordinates and counts equal index for index; features
within 1e-6 (rtol and atol)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_sparse_conv import _inputs
from warpconvnet_tpu.nn.functional import sparse_pool as jpool
from warpconvnet_tpu_torch.nn.functional import sparse_pool as tpool

TOL = dict(rtol=1e-6, atol=1e-6)


def _reduce_both(ks, stride, reduction, out_capacity=None, seed=0):
    tv, jv = _inputs(seed, n=320, grid=12, c=5)
    got, table = tpool.sparse_reduce(tv, ks, stride, reduction, out_capacity)
    ref, jtable = jax.jit(
        lambda v: jpool.sparse_reduce(v, ks, stride, reduction, out_capacity)
    )(jv)
    return tv, jv, got, table, ref, jtable


@pytest.mark.parametrize("reduction", ["max", "min", "sum", "mean"])
@pytest.mark.parametrize("ks,stride", [(4, 4), (2, 2), (3, 1)])
def test_sparse_reduce_matches_jax(ks, stride, reduction):
    tv, _, got, table, ref, jtable = _reduce_both(ks, stride, reduction)
    np.testing.assert_array_equal(table.table.numpy(), np.asarray(jtable.table))
    np.testing.assert_array_equal(table.rev.numpy(), np.asarray(jtable.rev))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(ref.coords))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(ref.num_valid))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features), **TOL)
    assert got.tensor_stride == tuple(ref.tensor_stride)
    assert got.lex_sorted == (stride != 1 or tv.lex_sorted)
    assert np.all(got.features.numpy()[~got.valid_mask().numpy()] == 0)


def test_token_capacity_drops_like_jax():
    """An output capacity below the unique count keeps the first outputs
    in lexicographic order, as the JAX package does."""
    _, _, got, table, ref, jtable = _reduce_both(4, 4, "mean", out_capacity=24, seed=1)
    assert int(got.num_valid.max()) == 24
    np.testing.assert_array_equal(table.table.numpy(), np.asarray(jtable.table))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(ref.num_valid))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features), **TOL)


@pytest.mark.parametrize("ks,concat", [(4, True), (2, False), (3, True)])
def test_sparse_unpool_matches_jax(ks, concat):
    stride = 1 if ks == 3 else ks
    tv, jv, pooled, table, jpooled, jtable = _reduce_both(ks, stride, "max", seed=2)
    got = tpool.sparse_unpool(pooled, tv, table, tv.features if concat else None)
    ref = jax.jit(lambda p, v, t: jpool.sparse_unpool(p, v, t, v.features if concat else None))(
        jpooled, jv, jtable)
    assert got.features.shape[-1] == (10 if concat else 5)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features), **TOL)
    assert np.all(got.features.numpy()[~tv.valid_mask().numpy()] == 0)


@pytest.mark.parametrize("reduction", ["max", "sum", "mean"])
def test_global_pool_matches_jax(reduction):
    tv, jv = _inputs(3, c=4)
    ref = jpool.global_pool(jv, reduction)
    np.testing.assert_allclose(tpool.global_pool(tv, reduction).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_max_and_avg_pool_default_the_stride_to_the_kernel():
    tv, _ = _inputs(4, c=3)
    for fn, red in ((tpool.sparse_max_pool, "max"), (tpool.sparse_avg_pool, "mean")):
        a, _ = fn(tv, 2)
        b, _ = tpool.sparse_reduce(tv, 2, 2, red)
        assert torch.equal(a.features, b.features) and a.tensor_stride == (2, 2, 2)
    with pytest.raises(ValueError, match="reduction"):
        tpool.sparse_reduce(tv, 2, 2, "median")
