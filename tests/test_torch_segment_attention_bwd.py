"""Port parity for segment attention's backward: the plain backward
(``segment_attention_bwd_plain``, K9-dkv and K9-dq's plain versions) and
the ``SegmentAttention`` autograd Function against ``jax.vjp`` of JAX
``segment_attention(..., impl="xla")``, the way JAX's own tests
differentiate it on the CPU. Layouts: global attention with pads, grouped
(patch) segments, cross attention with separate ids, rows that match no kv
row. Tolerances: fp32 2e-5 (rtol and atol, as the JAX tests use); bf16 by
relative Frobenius error (see ``BF16_TOL``). Also a float64 gradcheck of
the Function's plain route, the routing, and a spy showing that an
``Attention`` backward goes through the Function once per layer. The plain
backward is also held against ``jax.vjp`` of ``impl="flash"``: the stock
Pallas TPU backward kernels themselves, run in TPU interpret mode, whose
rounding of P and dS it follows (see ``STOCK_TOL``)."""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.experimental.pallas import tpu as pltpu
import torch

from tests.test_torch_attention import C, H, _attention_inputs, _load, _perturbed
from tests.test_torch_attention import _t as _as_tensor
from tests.test_torch_segment_attention import _JDTYPE, _layouts, _qkv, _t
from warpconvnet_tpu.nn.functional import flash_attention as jfa
from warpconvnet_tpu.nn.modules import attention as jmod
from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.models import convert
from warpconvnet_tpu_torch.nn.functional import flash_attention as tfa
from warpconvnet_tpu_torch.nn.modules.attention import Attention

TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: JAX's xla path rounds the probabilities, dP and dS to bf16 inside
# its backward; the port's plain backward rounds P and scale * dS as the
# stock TPU kernels do and keeps dP in fp32. Relative Frobenius error of
# each gradient against JAX's: measured at most 3.6e-3 (3.2e-3 before P
# and dS were rounded; about one bf16 ulp, 2^-8 = 3.9e-3), held to 1e-2.
BF16_TOL = 1e-2
# Against the stock Pallas backward (interpret mode), relative Frobenius
# error of each gradient on valid rows. bf16: both round P and scale * dS
# to bf16 before the products, so only the order of fp32 sums and exp
# against the stock's exp(S - m) / l differ: measured at most 1.5e-4
# (B 2, S 300, H 2, D 64; a backward that keeps P and dS in fp32 is off by
# 2.7e-3 to 2.8e-3 there), held to 1e-3. fp32: measured 3.2e-7, held to
# 1e-5.
STOCK_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
LAYOUTS = ["global_with_pads", "grouped", "cross", "unmatched_rows"]
PAD = int(jfa._PAD_SEGMENT)


def _case(layout, d, seed=0):
    """(q, k, v, do, seg_q, seg_kv) as numpy for B = 2, H = 3; do is zero on
    pad query rows, as a caller that masks pad outputs gives it."""
    sq, skv = (100, 100) if layout in ("global_with_pads", "grouped") else (70, 130)
    q, k, v = _qkv(seed + d, 2, sq, skv, 3, d)
    sq_ids, skv_ids = _layouts(sq, skv, seed=d)[layout]
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    do = np.where((sq_ids == PAD)[..., None, None], 0, do).astype(np.float32)
    return q, k, v, do, sq_ids, skv_ids


def _jax_grads(q, k, v, do, sq_ids, skv_ids, dtype, scale=None):
    jd = _JDTYPE[dtype]

    def f(q_, k_, v_):
        return jfa.segment_attention(q_, k_, v_, jnp.asarray(sq_ids), jnp.asarray(skv_ids),
                                     scale=scale, impl="xla")

    out, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jd))]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _check(got, ref, dtype):
    for g, r in zip(got, ref):
        g = g.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, r, **TOL)
        else:
            assert _rel(g, r) <= BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_backward_matches_jax(layout, d, dtype):
    q, k, v, do, sq_ids, skv_ids = _case(layout, d)
    ref = _jax_grads(q, k, v, do, sq_ids, skv_ids, dtype)
    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    seg_q, seg_kv = _t(sq_ids, torch.int32), _t(skv_ids, torch.int32)
    o, lse = k9.segment_attention_fwd_plain(tq, tk, tv, seg_q, seg_kv, chunk=32, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 3, q.shape[1])
    got = k9.segment_attention_bwd_plain(tq, tk, tv, o, lse, tdo, seg_q, seg_kv, chunk=32)
    assert all(g.dtype == dtype and g.is_contiguous() for g in got)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["global", "grouped"])
def test_plain_backward_matches_the_stock_pallas_backward(layout, dtype):
    """The plain backward against ``jax.vjp`` of ``segment_attention(...,
    impl="flash")`` in TPU interpret mode: the stock K9-dkv / K9-dq Pallas
    kernels (jax ``flash_attention.py`` ``_flash_attention_dkv_kernel`` and
    ``_flash_attention_dq_kernel``), with their bf16 rounding of P and dS.
    B 2, S 300 (280 and 170 valid rows), H 2, D 64; global attention over
    the valid rows, or segments of 64 rows. Compared on valid rows: the
    stock pads the sequence with rows of its own."""
    b, s, h, d = 2, 300, 2, 64
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4))
    valid = np.arange(s)[None] < np.array([[280], [170]])
    group = np.arange(s)[None] // 64 if layout == "grouped" else np.zeros((1, s), np.int64)
    seg = np.where(valid, group, PAD).astype(np.int32)
    do = np.where(valid[..., None, None], do, 0).astype(np.float32)
    jd = _JDTYPE[dtype]

    def f(q_, k_, v_):
        return jfa.segment_attention(q_, k_, v_, jnp.asarray(seg), impl="flash")

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (2 * q, k, v)))
        ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jd))]
    tq, tk, tv, tdo = (_t(x, dtype) for x in (2 * q, k, v, do))
    tseg = _t(seg, torch.int32)
    o, lse = k9.segment_attention_fwd_plain(tq, tk, tv, tseg, tseg, return_lse=True)
    got = k9.segment_attention_bwd_plain(tq, tk, tv, o, lse, tdo, tseg, tseg)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        assert _rel(g.float().numpy()[valid], r[valid]) <= STOCK_TOL[dtype]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_plain_versions_split_the_backward(layout):
    """K9-dkv's and K9-dq's plain versions, fed di = rowsum(o * do), give
    the one-pass plain backward's dk, dv and dq."""
    q, k, v, do, sq_ids, skv_ids = (_t(x) if x.dtype != np.int32 else _t(x, torch.int32)
                                    for x in _case(layout, 16, seed=3))
    o, lse = k9.segment_attention_fwd_plain(q, k, v, sq_ids, skv_ids, return_lse=True)
    dq, dk, dv = k9.segment_attention_bwd_plain(q, k, v, o, lse, do, sq_ids, skv_ids)
    di = k9.rowsum_o_do(o, do)
    assert tuple(di.shape) == tuple(lse.shape)
    got_dk, got_dv = k9.segment_attention_bwd_dkv(q, k, v, do, lse, di, sq_ids, skv_ids)
    got_dq = k9.segment_attention_bwd_dq(q, k, v, do, lse, di, sq_ids, skv_ids)
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lse_and_zero_gradients_on_pad_and_empty_rows(layout):
    """lse is the masked log-sum-exp of the scaled scores and +inf exactly
    on the rows that match nothing; those rows, and pad rows whose output
    gradient is zero, get zero gradients, as do kv rows no query attends."""
    q, k, v, do, sq_ids, skv_ids = _case(layout, 16, seed=5)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    seg_q, seg_kv = _t(sq_ids, torch.int32), _t(skv_ids, torch.int32)
    o, lse = k9.segment_attention_fwd_plain(tq, tk, tv, seg_q, seg_kv, chunk=16, return_lse=True)
    pair = sq_ids[:, :, None] == skv_ids[:, None, :]  # [B, Sq, Skv]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    s = np.where(pair[:, None], s, -np.inf)
    with np.errstate(divide="ignore"):
        want = np.log(np.exp(s - s.max(-1, keepdims=True, initial=-1e30)).sum(-1)) + s.max(
            -1, initial=-1e30)
    empty = ~pair.any(-1)  # [B, Sq]
    want = np.where(empty[:, None], np.inf, want)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.isposinf(lse.numpy()).sum() == 3 * empty.sum()
    dq, dk, dv = k9.segment_attention_bwd_plain(tq, tk, tv, o, lse, tdo, seg_q, seg_kv)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    zero_q = empty | (sq_ids == PAD)
    assert bool((dq[torch.from_numpy(zero_q)] == 0).all())
    if layout == "global_with_pads":
        assert zero_q.any() and bool((dk[torch.from_numpy(skv_ids == PAD)] == 0).all())
    unattended = torch.from_numpy(~pair.any(1))  # kv rows no query attends
    assert bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())
    if layout == "unmatched_rows":
        assert empty.any()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_function_matches_jax(layout):
    """``segment_attention`` on CPU tensors that require grad: the
    Function's plain route, differentiated by ``torch.autograd.grad``, with
    a scale given."""
    q, k, v, do, sq_ids, skv_ids = _case(layout, 16, seed=7)
    ref = _jax_grads(q, k, v, do, sq_ids, skv_ids, torch.float32, scale=0.3)
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    with mock.patch.object(tfa.SegmentAttention, "apply", wraps=tfa.SegmentAttention.apply) as spy:
        out = tfa.segment_attention(tq, tk, tv, _t(sq_ids, torch.int32), _t(skv_ids, torch.int32),
                                    scale=0.3)
    assert spy.call_count == 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    _check(got, ref, torch.float32)


def test_gradcheck_float64_plain_route():
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
               for shape in ((2, 9, 2, 4), (2, 11, 2, 4), (2, 11, 2, 4)))
    seg_q = torch.from_numpy(rng.integers(0, 3, (2, 9)).astype(np.int32))
    seg_q[:, ::4] = 7  # rows that match nothing
    seg_kv = torch.from_numpy(rng.integers(0, 3, (2, 11)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.SegmentAttention.apply(a, b, c, seg_q, seg_kv, 0.7), (q, k, v))


def test_routing():
    """No gradient recorded: the bare forward, no Function. A gradient
    recorded: through the Function. impl="xla": masked_sdpa under autograd,
    no Function."""
    q, k, v, _, sq_ids, _ = _case("global_with_pads", 16, seed=9)
    seg = _t(sq_ids, torch.int32)
    tq, tk, tv = map(_t, (q, k, v))
    with mock.patch.object(tfa.SegmentAttention, "apply", wraps=tfa.SegmentAttention.apply) as spy:
        assert tfa.segment_attention(tq, tk, tv, seg).grad_fn is None
        with torch.no_grad():
            tfa.segment_attention(tq, tk, tv.requires_grad_(True), seg)
        assert spy.call_count == 0
        out = tfa.segment_attention(tq, tk, tv, seg, impl="xla")
        assert out.grad_fn is not None and spy.call_count == 0
        out = tfa.segment_attention(tq, tk, tv, seg)
        assert out.grad_fn is not None and spy.call_count == 1


@pytest.mark.parametrize("case", ["row_valid", "segment_ids", "patches"])
def test_attention_backward_goes_through_the_function(case):
    """An Attention (fused QKV, RoPE) backward runs the segment-attention
    backward once a call, and its parameter and input gradients match
    ``jax.grad`` of the JAX Attention: q and k reach the QKV projection
    through RoPE, v as a strided slice of its output."""
    x, kw = _attention_inputs(case)
    jatt = jmod.Attention(C, H, rope_base=100.0)
    jkw = {key: jnp.asarray(val) for key, val in kw.items()}
    params = _perturbed(jatt.init(jax.random.PRNGKey(1), jnp.asarray(x), **jkw), 9)
    r = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jatt.apply(p, xx, **jkw) * r)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    att = _load(Attention(C, H, rope_base=100.0, device="cpu"), params, "attn")
    tx = _t(x).requires_grad_(True)
    with mock.patch.object(k9, "segment_attention_bwd", wraps=k9.segment_attention_bwd) as spy:
        (att(tx, **{key: _as_tensor(val) for key, val in kw.items()}) * _t(r)).sum().backward()
    assert spy.call_count == 1
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    want = {}
    for path, value in convert._flatten(jgp["params"]):
        name, transpose = convert._VOLT_BLOCK[("attn",) + path]
        want[name.removeprefix("attn.")] = np.asarray(value).T if transpose else np.asarray(value)
    got = {n: p.grad for n, p in att.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    for name, g in got.items():
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("d,own,step", [(16, 128, 32), (32, 128, 32), (64, 128, 32),
                                        (128, 64, 16)])
def test_bwd_own_tile_and_step_follow_the_kernels(d, own, step):
    """fp32 K9-dkv and K9-dq: two warpgroups of 64 own rows and 32-row
    visited steps, one warpgroup and 16-row steps at D 128."""
    assert (k9.bwd_own_tile(d), k9.bwd_step(d)) == (own, step)


def test_bwd_split_bytes_counts_each_step_image():
    """A step's image: hi and lo of two operands row-major, of two (K9-dkv)
    or one (K9-dq) transposed, then ids (and lse, di); a last partial step
    whole. The Volt-s trunk (Sq = Skv = 40960, 2 scenes, 6 heads, D 64)
    splits about 0.94 GiB in K9-dkv and 0.70 GiB in K9-dq."""
    assert k9.bwd_split_bytes(40960, 64, True) == 1280 * (8 * 64 + 3) * 32 * 4
    assert k9.bwd_split_bytes(40960, 64, False) == 1280 * (6 * 64 + 1) * 32 * 4
    assert k9.bwd_split_bytes(4097, 128, True) == 257 * (8 * 128 + 3) * 16 * 4
    assert k9.bwd_split_bytes(4097, 16, False) == 129 * (6 * 16 + 1) * 32 * 4
    assert round(12 * k9.bwd_split_bytes(40960, 64, True) / 2 ** 30, 2) == 0.94
    assert round(12 * k9.bwd_split_bytes(40960, 64, False) / 2 ** 30, 2) == 0.70


@pytest.mark.parametrize("rows,h,d,dkv,per_pass", [
    (40960, 6, 64, True, 3), (40960, 6, 64, False, 3),   # the Volt-s trunk: 3 + 3 heads
    (262144, 2, 16, True, 1), (262144, 2, 16, False, 2),  # PTv3's level 0
    (16384, 32, 16, True, 16), (40, 6, 64, True, 6),     # PTv3's level 4; a short walk
    (1 << 20, 2, 128, True, 1)])                         # one head over the cap
def test_bwd_split_scratch_keeps_each_pass_under_the_cap(rows, h, d, dkv, per_pass):
    """A pass is one scene and a group of its heads: no pass over
    ``SPLIT_SCRATCH_BYTES`` unless one head alone is, at least one head a
    pass, the heads spread evenly over the fewest passes."""
    one = k9.bwd_split_bytes(rows, d, dkv)
    got, nbytes = k9.bwd_split_scratch(one, h)
    assert got == per_pass and nbytes == per_pass * one
    assert nbytes <= k9.SPLIT_SCRATCH_BYTES or per_pass == 1
    passes = -(-h // per_pass)
    most = k9.SPLIT_SCRATCH_BYTES // one
    assert passes == (h if most == 0 else -(-h // min(h, most)))
    assert per_pass * (passes - 1) < h <= per_pass * passes


def test_bwd_rows_staged_counts_each_visited_step():
    """Both kernels' blocks copy in ``step`` rows a step of every tile they
    visit, pad rows included, and skip a step wholly past the end. One
    segment over 4097 rows: each own tile visits all 65 tiles, whose last
    holds one row (one step). Aligned 64-row segments: each own tile of 128
    its own two tiles. Cross attention, 100 query rows of segment 0 over 300
    kv rows (64 of segment 0): K9-dkv's first kv tile visits both query
    tiles (four steps of 32; at 16-row steps 4 + 3, the last past Sq
    skipped), K9-dq's query tiles the first kv tile (two steps; 2 x 4)."""
    seg = torch.zeros((1, 4097), dtype=torch.int32)
    assert k9.bwd_rows_staged(seg, seg, 128, 32) == 2 * 33 * (64 * 64 + 32)
    assert k9.bwd_rows_staged(seg, seg, 64, 16) == 2 * 65 * (64 * 64 + 16)
    seg = torch.arange(256, dtype=torch.int32).reshape(1, 256) // 64
    assert k9.bwd_rows_staged(seg, seg, 128, 32) == 2 * 2 * 2 * 64
    seg_q = torch.zeros((1, 100), dtype=torch.int32)
    seg_kv = (torch.arange(300, dtype=torch.int32) >= 64).to(torch.int32).reshape(1, 300)
    assert k9.bwd_rows_staged(seg_q, seg_kv, 128, 32) == 4 * 32 + 2 * 32
    assert k9.bwd_rows_staged(seg_q, seg_kv, 64, 16) == 7 * 16 + 2 * 4 * 16
