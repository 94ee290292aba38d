"""The arithmetic of the fp32 segment-attention kernels (K9, K9-dkv,
K9-dq), held here on the CPU: each fp32 operand split into two TF32 values
(``tf32_split``, the kernels' ``cvt.rna.tf32.f32``) and each product formed
from three TF32 products (``tf32_matmul``, 3xTF32). The split against an
independent float64 rounding; the 3xTF32 product against float64, beside
an fp32 product and a single TF32 product; a backward whose six products
run as emulated 3xTF32 against JAX's fp32 backward, at the fp32 tolerance
of ``tests/test_torch_segment_attention_bwd.py``; and a forward whose two
products do (the fp32 K9's arithmetic) against JAX's fp32 forward, at the
fp32 tolerance of ``tests/test_torch_segment_attention.py``."""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_segment_attention import TOL as FWD_TOL
from tests.test_torch_segment_attention import _jax_ref, _layouts, _qkv, _t
from tests.test_torch_segment_attention_bwd import TOL, _case, _jax_grads
from warpconvnet_tpu_torch.kernels import segment_attention as k9


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits (TF32), to nearest with ties away
    from zero, in float64; subnormals on TF32's grid of 2^-136."""
    ax = np.abs(x.astype(np.float64))
    _, e = np.frexp(ax)  # ax = m 2^e, m in [0.5, 1)
    ulp = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -136)
    return np.sign(x) * np.floor(ax / ulp + 0.5) * ulp


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


def test_tf32_split_rounds_to_nearest_away_and_keeps_the_remainder():
    rng = np.random.default_rng(0)
    normal = (rng.standard_normal(4096) * 2.0 ** rng.integers(-100, 100, 4096)).astype(np.float32)
    # Ties: a TF32 value plus half its last place.
    base = _rna_reference(rng.standard_normal(512).astype(np.float32)).astype(np.float32)
    _, e = np.frexp(np.abs(base).astype(np.float64))
    ties = (base + np.sign(base) * np.ldexp(1.0, e - 12)).astype(np.float32)
    sub = (rng.standard_normal(512) * 2.0 ** -135).astype(np.float32)  # subnormal fp32
    x = np.concatenate([normal, ties, sub, [0.0, -0.0]]).astype(np.float32)
    hi, lo = k9.tf32_split(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    assert bool((_low_bits(hi) == 0).all()) and bool((_low_bits(lo) == 0).all())
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(x).astype(np.float32))
    ties_hi = hi.numpy()[4096:4608]
    assert bool((np.abs(ties_hi) > np.abs(base)).all())  # ties go away from zero
    x64 = x.astype(np.float64)
    rest = np.abs(x64 - hi.numpy().astype(np.float64) - lo.numpy().astype(np.float64))
    assert bool((rest <= np.maximum(2.0 ** -22 * np.abs(x64), 2.0 ** -137)).all())
    assert bool((rest[:4608] <= 2.0 ** -22 * np.abs(x64[:4608])).all())
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    s_hi, s_lo = k9.tf32_split(special)
    assert s_hi[0] == float("inf") and s_hi[1] == -float("inf") and bool(torch.isnan(s_hi[2]))
    assert bool((s_lo == 0).all())


# Largest error of a [64 x K] @ [K x 96] product of N(0, 1) values against
# float64, over |a| @ |b| (seed K). Measured: 3xTF32 1.01x to 1.17x the
# fp32 product's; one TF32 product 812x to 2540x.
X3_FACTOR, X1_FACTOR = 2.0, 100.0


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_3xtf32_product_keeps_fp32_accuracy(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((64, k)).astype(np.float32)
    b = rng.standard_normal((k, 96)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def err(c):
        return float(np.max(np.abs(c.double().numpy() - ref) / mag))

    fp32 = err(ta @ tb)
    assert err(k9.tf32_matmul(ta, tb)) <= X3_FACTOR * fp32
    assert err(k9.tf32_matmul(ta, tb, terms=1)) >= X1_FACTOR * fp32


def test_3xtf32_backward_matches_jax_fp32_backward():
    """The plain backward with its six products as emulated 3xTF32 matches
    JAX's fp32 backward within the fp32 2e-5; with one TF32 product each it
    does not (grouped layout, B 2, S 100, H 3, D 64)."""
    q, k, v, do, sq_ids, skv_ids = _case("grouped", 64)
    ref = _jax_grads(q, k, v, do, sq_ids, skv_ids, torch.float32)
    tq, tk, tv, tdo = (_t(x, torch.float32) for x in (q, k, v, do))
    seg_q, seg_kv = _t(sq_ids, torch.int32), _t(skv_ids, torch.int32)
    o, lse = k9.segment_attention_fwd_plain(tq, tk, tv, seg_q, seg_kv, return_lse=True)
    args = (tq, tk, tv, o, lse, tdo, seg_q, seg_kv)
    got = k9.segment_attention_bwd_plain(*args, matmul=k9.tf32_matmul)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    one = k9.segment_attention_bwd_plain(*args, matmul=functools.partial(k9.tf32_matmul, terms=1))
    assert not all(np.allclose(g.numpy(), r, **TOL) for g, r in zip(one, ref))


@pytest.mark.parametrize("layout", ["grouped", "unmatched_rows"])
def test_3xtf32_forward_matches_jax_fp32_forward(layout):
    """The plain forward with its two products (S = Q K^T, P V) as emulated
    3xTF32, the fp32 K9's arithmetic, matches JAX's fp32 forward within
    the fp32 1e-5 of ``tests/test_torch_segment_attention.py``; with one
    TF32 product each it does not (B 2, H 3, D 64; S 100, or Sq 70 and
    Skv 130 with query rows that match nothing)."""
    sq, skv = (100, 100) if layout == "grouped" else (70, 130)
    q, k, v = _qkv(64, 2, sq, skv, 3, 64)
    sq_ids, skv_ids = _layouts(sq, skv, seed=64)[layout]
    ref = _jax_ref(q, k, v, sq_ids, skv_ids, torch.float32)
    args = (_t(q), _t(k), _t(v), _t(sq_ids, torch.int32), _t(skv_ids, torch.int32))
    got = k9.segment_attention_fwd_plain(*args, matmul=k9.tf32_matmul)
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL[torch.float32])
    one = k9.segment_attention_fwd_plain(*args, matmul=functools.partial(k9.tf32_matmul, terms=1))
    assert not np.allclose(one.numpy(), ref, **FWD_TOL[torch.float32])
