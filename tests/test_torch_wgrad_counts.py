"""Host models of the weight-gradient kernels' own counts on maps whose
input and output rows differ, on the CPU at B=2.

K3 and K4 add C_in x C_out floats into dw, K7 and K8 C floats, for every
(scene, offset, chunk of output rows) that holds a pair
(``implicit_gemm.bwd_fused_dw_atomics``, ``depthwise_fma.bwd_fused_dw_adds``;
the card tests hold the kernels' counts to them). Here both models are held
against a chunk-by-chunk numpy count on the port's strided 2^3 map (fine
rows in, coarse rows out) and its reverse (the transposed conv's map,
coarse in, fine out: one valid offset of eight a row), at the chunk
lengths K3 takes (from 4096 rows down to 256) and a short one."""

import functools

import numpy as np
import pytest
import torch

from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.kernels import depthwise_fma, implicit_gemm
from warpconvnet_tpu_torch.nn.functional.sparse_conv import generate_output_coords_and_kernel_map
from warpconvnet_tpu_torch.ops.keys import PAD_COORD

N_FINE, N_COARSE = 5000, 3000  # rows a scene: padding rows at each end of both sides


@functools.cache
def _maps():
    """{kind: (table [2, 8, n_out], n_in)} of the strided map and its reverse."""
    rng = np.random.default_rng(3)
    coords = np.full((2, N_FINE, 3), PAD_COORD, np.int32)
    nv = np.zeros((2,), np.int32)
    for i, n in enumerate((4600, 1500)):
        u = np.unique(rng.integers(0, 30, size=(n, 3)), axis=0).astype(np.int32)
        nv[i] = len(u)
        coords[i, : len(u)] = u
    vox = Voxels.create(coords, np.zeros((2, N_FINE, 1), np.float32), nv, device="cpu").lex_sort()
    _, onv, down, _ = generate_output_coords_and_kernel_map(vox, 2, stride=2,
                                                            out_capacity=N_COARSE)
    assert int(onv.max()) < N_COARSE
    return {"strided": (down.table, N_FINE), "transposed": (down.reversed().table, N_COARSE)}


def _chunks_with_a_pair(table, chunk_rows):
    t = table.numpy()
    b, k, n = t.shape
    return sum(bool((t[s, kk, r0:r0 + chunk_rows] >= 0).any())
               for s in range(b) for kk in range(k) for r0 in range(0, n, chunk_rows))


@pytest.mark.parametrize("chunk_rows", [16, 256, 4096])
@pytest.mark.parametrize("kind", ["strided", "transposed"])
@pytest.mark.parametrize("model", ["k3", "k7"])
def test_wgrad_dw_count_models_match_a_brute_force(model, kind, chunk_rows):
    """The model of K3's (C_in 12, C_out 20) or K7's (C 20) dw floats
    against the chunk-by-chunk count, on a map with chunks of padding rows
    only and a ragged last chunk."""
    table, n_in = _maps()[kind]
    n_out = table.shape[2]
    assert n_in != n_out and n_out % chunk_rows != 0
    assert int(table.max()) < n_in
    if kind == "transposed":  # each fine row takes one offset of eight
        assert int((table >= 0).sum(1).max()) == 1
    met = _chunks_with_a_pair(table, chunk_rows)
    if chunk_rows < 4096:
        assert met < 2 * 8 * -(-n_out // chunk_rows)  # some chunks hold padding rows only
    if model == "k3":
        got = implicit_gemm.bwd_fused_dw_atomics(table, 12, 20, chunk_rows)
        assert got == met * 12 * 20 > 0
    else:
        got = depthwise_fma.bwd_fused_dw_adds(table, 20, chunk_rows)
        assert got == met * 20 > 0
