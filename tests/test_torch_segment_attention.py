"""Port parity for segment attention: K9's plain version
(``segment_attention_fwd_plain``) and the port's ``segment_attention``
against JAX ``segment_attention(..., impl="xla")``, the path JAX's own tests
run on the CPU. Layouts: global attention with pads, grouped (patch)
segments, cross attention with separate ids, rows that match no kv row.
Tolerances: fp32 1e-5 (rtol and atol), bf16 2e-2. The plain version's out
and lse are also held against ``impl="flash"``: the stock Pallas TPU forward
kernel itself, run in TPU interpret mode (see ``STOCK_TOL``)."""

from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as stock

from warpconvnet_tpu.nn.functional import flash_attention as jfa
from warpconvnet_tpu_torch.kernels import segment_attention as k9
from warpconvnet_tpu_torch.nn.functional import flash_attention as tfa

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# The plain forward against the stock Pallas forward (interpret mode),
# relative Frobenius error on valid rows (B 2, S 300, H 2, D 64). out: fp32
# measured 1.3e-7, held to 1e-5; bf16 measured 7.0e-5 (global) and 1.4e-6
# (segments of 64 rows), held to 1e-3: the stock rounds the unnormalised
# probabilities to bf16 before P V, the plain version the normalised ones;
# a forward that keeps them in fp32 is 2.7e-3 away. lse (fp32 for both
# dtypes): measured 3.7e-8 at most, held to 1e-5.
STOCK_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
STOCK_LSE_TOL = 1e-5
_JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    return q, k, v


def _valid_segments(n, num_valid):
    valid = np.arange(n)[None, :] < np.asarray(num_valid)[:, None]
    return np.where(valid, 0, jfa._PAD_SEGMENT).astype(np.int32)


def _layouts(sq, skv, seed):
    """name -> (seg_q, seg_kv) for B = 2."""
    rng = np.random.default_rng(seed)
    grouped = np.broadcast_to(np.arange(sq) // 16, (2, sq)).astype(np.int32)
    grouped = np.where(np.arange(sq)[None, :] < np.array([[sq - 5], [sq - 40]]), grouped,
                       jfa._PAD_SEGMENT).astype(np.int32)
    unmatched = rng.integers(0, 4, size=(2, sq)).astype(np.int32)
    unmatched[:, ::7] = 9  # kv ids are 0..3: these query rows match nothing
    return {
        "global_with_pads": (_valid_segments(sq, [sq - 9, sq // 2]),
                             _valid_segments(skv, [skv - 9, skv // 2])),
        "grouped": (grouped, grouped) if sq == skv else None,
        "cross": (rng.integers(0, 3, size=(2, sq)).astype(np.int32),
                  rng.integers(0, 3, size=(2, skv)).astype(np.int32)),
        "unmatched_rows": (unmatched, rng.integers(0, 4, size=(2, skv)).astype(np.int32)),
    }


def _jax_ref(q, k, v, sq_ids, skv_ids, dtype):
    jd = _JDTYPE[dtype]
    out = jfa.segment_attention(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                                jnp.asarray(sq_ids), jnp.asarray(skv_ids), impl="xla")
    return np.asarray(out.astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("layout", ["global_with_pads", "grouped", "cross", "unmatched_rows"])
def test_plain_matches_jax(layout, d, dtype):
    sq, skv = (100, 100) if layout in ("global_with_pads", "grouped") else (70, 130)
    q, k, v = _qkv(d, 2, sq, skv, 3, d)
    sq_ids, skv_ids = _layouts(sq, skv, seed=d)[layout]
    ref = _jax_ref(q, k, v, sq_ids, skv_ids, dtype)
    got = k9.segment_attention_fwd_plain(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                         _t(sq_ids, torch.int32), _t(skv_ids, torch.int32),
                                         chunk=32)
    assert got.dtype == dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])
    if layout == "unmatched_rows":
        assert np.all(got.float().numpy()[:, ::7] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["global", "grouped"])
def test_plain_matches_the_stock_pallas_forward(layout, dtype):
    """The plain forward's out and lse against ``segment_attention(...,
    impl="flash")`` in TPU interpret mode: the stock K9 Pallas kernel (jax
    ``flash_attention.py`` ``_flash_attention_kernel``), whose lse is read
    from the residuals it saves for the backward (m + log l). B 2, S 300
    (280 and 170 valid rows), H 2, D 64; global attention over the valid
    rows, or segments of 64 rows. Compared on valid rows: the stock pads
    the sequence with rows of its own."""
    b, s, h, d = 2, 300, 2, 64
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    q = 2 * q
    valid = np.arange(s)[None] < np.array([[280], [170]])
    group = np.arange(s)[None] // 64 if layout == "grouped" else np.zeros((1, s), np.int64)
    seg = np.where(valid, group, int(jfa._PAD_SEGMENT)).astype(np.int32)
    saved = {}

    def with_lse(q_, k_, v_, ab=None, segment_ids=None, *, causal=False, sm_scale=1.0,
                 block_sizes=None, debug=False):
        o, l, m = stock._flash_attention(q_, k_, v_, ab, segment_ids, True, causal, sm_scale,
                                         block_sizes, debug)
        saved["lse"] = m + jnp.log(l)
        return o

    jd = _JDTYPE[dtype]
    with pltpu.force_tpu_interpret_mode(), mock.patch.object(stock, "flash_attention", with_lse):
        ref = jfa.segment_attention(*(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(seg),
                                    impl="flash")
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(saved["lse"])[:, :, :s].transpose(0, 2, 1)  # [B, S, H]
    tseg = _t(seg, torch.int32)
    out, lse = k9.segment_attention_fwd_plain(_t(q, dtype), _t(k, dtype), _t(v, dtype), tseg,
                                              tseg, return_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32

    def rel(got, want):
        got, want = np.asarray(got, np.float64)[valid], np.asarray(want, np.float64)[valid]
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    assert rel(out.float().numpy(), ref) <= STOCK_TOL[dtype]
    assert rel(lse.numpy().transpose(0, 2, 1), ref_lse) <= STOCK_LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_equals_unchunked(dtype):
    """Each query row's softmax is its own, so the chunk only changes the
    shapes of the products: within 1e-6 (fp32) or one bf16 ulp."""
    q, k, v = _qkv(3, 2, 90, 90, 2, 32)
    sq_ids, skv_ids = _layouts(90, 90, seed=3)["global_with_pads"]
    args = (_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(sq_ids, torch.int32),
            _t(skv_ids, torch.int32))
    whole = k9.segment_attention_fwd_plain(*args, chunk=4096)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    for chunk in (1, 7, 64):
        torch.testing.assert_close(k9.segment_attention_fwd_plain(*args, chunk=chunk).float(),
                                   whole.float(), **tol)


@pytest.mark.parametrize("impl", [None, "xla"])
def test_segment_attention_routes_match_jax(impl):
    """The functional entry point on CPU tensors (plain version, or the
    score-matrix path on request), with a scale given and seg_kv defaulted."""
    q, k, v = _qkv(5, 2, 80, 80, 2, 16)
    row_valid = np.arange(80)[None, :] < np.array([[71], [33]])
    seg = tfa.segment_ids_from_valid(torch.from_numpy(row_valid))
    jseg = jfa.segment_ids_from_valid(jnp.asarray(row_valid))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    ref = jfa.segment_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg,
                                scale=0.3, impl="xla")
    got = tfa.segment_attention(_t(q), _t(k), _t(v), seg, scale=0.3, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL[torch.float32])


def test_segment_ids_from_groups_matches_jax():
    group = np.arange(40).reshape(2, 20) // 3
    valid = np.arange(20)[None, :] < np.array([[17], [5]])
    got = tfa.segment_ids_from_groups(torch.from_numpy(group), torch.from_numpy(valid))
    ref = jfa.segment_ids_from_groups(jnp.asarray(group), jnp.asarray(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="impl"):
        tfa.segment_attention(torch.zeros(1, 4, 1, 16), torch.zeros(1, 4, 1, 16),
                              torch.zeros(1, 4, 1, 16), got[:1, :4], impl="flash")


def test_kv_tiles_visited_follows_the_segment_ranges():
    """Segments of 64 rows aligned to the kv tiles: each 128-query tile
    visits its own two kv tiles only. One global segment with pads: a valid
    query tile visits the kv tiles holding valid rows, a mixed one all
    tiles, an all-pad one the tiles holding pads."""
    seg = torch.arange(256, dtype=torch.int32).reshape(1, 256) // 64
    assert k9.kv_tiles_visited(seg, seg) == (4, 8)
    valid = torch.from_numpy(_valid_segments(300, [200]))
    # Query tiles: rows 0-127 valid, 128-255 mixed, 256-299 pad; kv tiles
    # 0-2 valid, 3 mixed, 4 pad: 4 + 5 + 2 visits.
    assert k9.kv_tiles_visited(valid, valid) == (11, 15)


# Own rows a block of each kernel: K9 fp32 128 (64 at D 128) and bf16 192
# (128), K9-dkv / K9-dq fp32 128 (64) and bf16 192 (64).
_OWN_TILES = (64, 128, 192)


def _assert_visit_rule(seg_own, seg_oth):
    """At every kernel's own tile, both ways: the scenes are sorted and the
    visit pre-pass's rule (``visit_ranges``) marks exactly the tiles the
    scan marks (``_visited_tiles``, ``kv_tiles_visited``)."""
    for own in _OWN_TILES:
        for mine, other in ((seg_own, seg_oth), (seg_oth, seg_own)):
            ranges, sorted_ = k9.visit_ranges(mine, other, own)
            assert bool(sorted_.all())
            scan = k9._visited_tiles(mine, other, own)
            tile = torch.arange(scan.shape[2])
            assert torch.equal((tile >= ranges[..., :1]) & (tile <= ranges[..., 1:]), scan), own
            tiles = int((ranges[..., 1] - ranges[..., 0] + 1).clamp(min=0).sum())
            assert tiles == k9.kv_tiles_visited(mine, other, own)[0]
            assert k9.visit_blocks(mine, other, own) == (scan.shape[0] * scan.shape[1], 0)


@pytest.mark.parametrize("level", range(5))
def test_visit_ranges_are_the_scan_on_ptv3_patch_ids(level):
    """PTv3's five level shapes scaled down by 8 (32768 >> level rows a
    scene, 1024-row patches), the bench pair's valid shares (30% and 44%,
    odd, so the last patch is partial; level 4 fits in two patches)."""
    n = 32768 >> level
    num_valid = torch.tensor([int(0.297 * n) | 1, int(0.439 * n) | 1])
    _assert_visit_rule(*tfa.patch_segment_ids(num_valid, n, 1024))


def test_visit_ranges_are_the_scan_on_validity_ids():
    """Volt's ids (``segment_ids_from_valid`` over a valid prefix): scenes
    of 300 rows with 200, 0 (all pad) and 300 valid, self and cross (Sq 70
    over the same scenes' kv rows)."""
    valid = torch.arange(300)[None] < torch.tensor([[200], [0], [300]])
    seg = tfa.segment_ids_from_valid(valid)
    _assert_visit_rule(seg, seg)
    _assert_visit_rule(tfa.segment_ids_from_valid(valid[:, :70]), seg)


def test_visit_ranges_are_the_scan_on_partial_and_all_pad_patches():
    """Patch ids of 5000 rows (not a multiple of a tile) with a partial
    last patch (4100 valid) and an all-pad scene (0 valid)."""
    _assert_visit_rule(*tfa.patch_segment_ids(torch.tensor([4100, 0]), 5000, 1024))


def test_visit_ranges_report_the_scan_on_interleaved_sentinels():
    """The range skip's worst case, every 7th row's id far below or above
    the rest (-1, 1000): not sorted, so every block scans. One sorted scene
    beside it is taken on its own."""
    seg = (torch.arange(600) // 24).to(torch.int32).repeat(2, 1)
    seg[1, ::14], seg[1, 7::14] = -1, 1000
    ranges, sorted_ = k9.visit_ranges(seg, seg, 128)
    assert sorted_.tolist() == [True, False]
    assert ranges.shape == (2, 5, 2)
    assert k9.visit_blocks(seg, seg, 128) == (5, 5)
    assert k9.visit_blocks(seg[1:], seg[1:], 64) == (0, 10)


@pytest.mark.parametrize("dtype,d,qt,step", [
    (torch.float32, 16, 128, 64), (torch.float32, 64, 128, 64), (torch.float32, 128, 64, 32),
    (torch.bfloat16, 64, 192, 64), (torch.bfloat16, 128, 128, 64)])
def test_query_tile_and_kv_step_follow_the_kernels(dtype, d, qt, step):
    """The forward's query rows a block and kv rows a step: fp32 takes
    whole 64-row kv tiles but 32-row steps at D 128, bf16 whole tiles."""
    assert (k9.query_tile(dtype, d), k9.kv_step(dtype, d)) == (qt, step)


def test_kv_rows_staged_counts_each_visited_step():
    """A visited tile stages its steps of ``step`` rows, pad rows included,
    and skips a step wholly past Skv: Skv 4097 (tiles 0-63 whole, tile 64
    one row) in one segment, every query tile visits all 65 tiles."""
    seg = torch.zeros((1, 4097), dtype=torch.int32)
    assert k9.kv_tiles_visited(seg, seg) == (33 * 65, 33 * 65)
    assert k9.kv_rows_staged(seg, seg, 128, 64) == 33 * 65 * 64
    assert k9.kv_rows_staged(seg, seg, 64, 32) == 65 * (64 * 64 + 32)
    # Aligned 64-row segments: each query tile its own two tiles.
    seg = torch.arange(256, dtype=torch.int32).reshape(1, 256) // 64
    assert k9.kv_rows_staged(seg, seg, 128, 64) == 4 * 64
    assert k9.kv_rows_staged(seg, seg, 64, 32) == 4 * 64
