"""GPU smoke run of the PyTorch port: MinkUNet18 inference and training
on an H100.

    python3 chip_smoke.py                  # the smoke run below
    python3 chip_smoke.py --profile DIR    # profile one bench-scale train step

Phases (any failure exits non-zero):
  1. device: needs CUDA and an sm_90 card; prints the card's name and
     power limit as nvidia-smi reports them.
  2. build: compiles the CUDA kernels from ``warpconvnet_tpu_torch/csrc``.
  3. K1: the L0 3^3 kernel map of one bench scene pair (B=2,
     n_cap=131072), CUDA kernel against its plain version: equal tables.
  4. K2: the implicit-GEMM forward on that map at C 32->32 and 256->256 in
     fp32 and bf16, CUDA kernel against its plain version.
  5. slice: MinkUNet18 (3 -> 20 classes, bf16 compute, fp32 params, seeded
     weights, eval mode) answers 3 requests, each a fresh scene pair whose
     maps are built inside the forward. Checks finite logits, 5 K1 and 40
     K2 launches per forward, and agreement with the plain path on the
     card; a small fp32 forward checks the kernels tightly.
  6. backward kernels: K2 as dgrad and K3 on the L0 -> L1 2^3 parity map
     and its reverse, K4 on the L0 3^3 map (also timed against the K2-dgrad
     + K3 pair), each against its plain version at C 32 fp32 and at the
     bf16 shapes 128 -> 96 and 96 -> 96.
  7. train: MinkUNet18 (bf16 compute, fp32 params, seeded weights and
     labels, Adam 1e-3) takes 5 steps on one bench scene pair on the kernel
     path and 5 from the same state on the plain path. Checks 5 K1, 40 K2,
     8 K2-dgrad, 8 K3 and 32 K4 launches per step, a finite loss and a
     finite grad on every parameter, a falling loss, and step 1's loss,
     gradients and parameters against the plain path; a small fp32 step
     checks the kernels tightly. Logs step ms, points/s and peak memory.
Prints one JSON line of per-kernel results, then the ok line last.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from unittest import mock

import numpy as np
import torch

B = 2
N_CAP = 1 << 17
NUM_CLASSES = 20
REQUESTS = 3
K1_PER_FORWARD = 5
K2_PER_FORWARD = 40
# bf16 rounds each conv output to 8 mantissa bits; the kernel and the plain
# version sum in different orders, so one output may differ by an ulp.
K2_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# Relative Frobenius error of the logits, kernel path against plain path:
# bf16 one-ulp differences compound over ~20 conv + BN layers.
SLICE_TOL_BF16 = 2e-2
SLICE_TOL_FP32 = 1e-4
# dw comes back in fp32 from exact products (bf16 inputs) summed in another
# order, with fp32 atomics: relative Frobenius error against the plain sum.
DW_TOL = 1e-4
TRAIN_STEPS = 5
LR = 1e-3
ADAM_EPS = 1e-8
PER_STEP = dict(k1=5, fwd=40, dgrad=8, wgrad=8, fused=32)
# Step 1 on the kernel path against the plain path, same card, same state.
# fp32: the same sums in another order (measured: loss 6.3e-8, gradients
# 1.2e-4, the worst being BN biases, sums that nearly cancel). bf16: both
# paths round at the same places, but a one-ulp flip where a kernel sums in
# another order compounds through ~40 BN layers into the cancelling sums
# (measured: loss 4.0e-5, gradients 0.135, worst tensors BN biases at
# 0.42; the 5-step losses stay within 1e-3). Bounds are 2-3x those values
# (H100 80GB HBM3, 700 W).
TRAIN_TOL = {
    torch.float32: dict(loss=2e-7, grads=4e-4),
    torch.bfloat16: dict(loss=1.5e-4, grads=0.3),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_batch(seed: int, n_cap: int, device):
    """The bench's input: B surface scenes, 3 random feature channels."""
    from warpconvnet_tpu_torch.geometry.voxels import Voxels
    from warpconvnet_tpu_torch.ops.keys import PAD_COORD
    from warpconvnet_tpu_torch.utils.scenes import make_surface_scene

    rng = np.random.default_rng(seed)
    coords = np.full((B, n_cap, 3), PAD_COORD, np.int32)
    feats = np.zeros((B, n_cap, 3), np.float32)
    nv = np.zeros((B,), np.int32)
    for i in range(B):
        c = make_surface_scene(rng, n_cap)
        nv[i] = len(c)
        coords[i, : len(c)] = c
        feats[i, : len(c)] = rng.standard_normal((len(c), 3)).astype(np.float32)
    return Voxels.create(coords, feats, nv, device=device)


@functools.cache
def wrappers():
    """Every kernel wrapper on the path, keyed as in ``PER_STEP``; taken
    once, so that counts can be read while ``plain_kernels`` patches them."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig, sorted_search

    return dict(k1=sorted_search.kernel_map_probe, fwd=ig.implicit_gemm_fwd,
                dgrad=ig.implicit_gemm_dgrad, wgrad=ig.implicit_gemm_wgrad,
                fused=ig.implicit_gemm_bwd_fused)


@contextmanager
def plain_kernels():
    """Route the conv path through the kernels' plain versions, also on
    CUDA tensors: the reference for the kernel path on the same card."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig, sorted_search

    wrappers()
    with mock.patch.object(
        sorted_search, "kernel_map_probe", sorted_search.kernel_map_probe_plain
    ), mock.patch.object(
        ig, "implicit_gemm_fwd", ig.implicit_gemm_fwd_plain
    ), mock.patch.object(
        ig, "implicit_gemm_dgrad", ig.implicit_gemm_dgrad_plain
    ), mock.patch.object(
        ig, "implicit_gemm_wgrad", ig.implicit_gemm_wgrad_plain
    ), mock.patch.object(
        ig, "implicit_gemm_bwd_fused", ig.implicit_gemm_bwd_fused_plain
    ):
        yield


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def counts():
    return wrappers()["k1"].launches, wrappers()["fwd"].launches


def all_counts():
    return {key: fn.launches for key, fn in wrappers().items()}


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def phase_k1(vox):
    from warpconvnet_tpu_torch.kernels import sorted_search
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets
    from warpconvnet_tpu_torch.ops.keys import PAD_COORD, coord_keys

    keys = coord_keys(torch.where(vox.valid_mask()[..., None], vox.coords, PAD_COORD))
    args = (keys, vox.num_valid, vox.coords, vox.num_valid, kernel_offsets(3), (1, 1, 1))
    got = sorted_search.kernel_map_probe(*args)
    ref = sorted_search.kernel_map_probe_plain(*args)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    err = int((got.long() - ref.long()).abs().max())
    check(mismatches == 0, f"K1: {mismatches} table entries differ from the plain version")
    hits = int((got >= 0).sum())
    ms = cuda_ms(lambda: sorted_search.kernel_map_probe(*args))
    plain_ms = cuda_ms(lambda: sorted_search.kernel_map_probe_plain(*args))
    log(f"K1 table {tuple(got.shape)}: equal to plain, {hits} pairs; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return got, dict(
        name="kernel_map_probe", route="cuda",
        source="warpconvnet_tpu_torch/csrc/sorted_search.cu",
        replaces="warpconvnet_tpu/kernels/sorted_search.py:288",
        shape=f"B={B} K=27 M={got.shape[2]} (L0 3^3 submanifold map)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
    )


def phase_k2(vox, table):
    from warpconvnet_tpu_torch.kernels import implicit_gemm

    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = vox.valid_mask()[..., None]
    n = vox.max_num_points
    entry = None
    for c in (32, 256):
        x32 = torch.randn((B, n, c), generator=gen, device="cuda") * mask
        w32 = torch.randn((27, c, c), generator=gen, device="cuda") / np.sqrt(27 * c)
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            got = implicit_gemm.implicit_gemm_fwd(x, w, table)
            ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, table)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            torch.testing.assert_close(got.float(), ref.float(), **K2_TOL[dtype])
            ms = cuda_ms(lambda: implicit_gemm.implicit_gemm_fwd(x, w, table))
            plain_ms = cuda_ms(lambda: implicit_gemm.implicit_gemm_fwd_plain(x, w, table))
            flops = 2.0 * int((table >= 0).sum()) * c * c
            log(f"K2 C {c}->{c} {str(dtype)[6:]}: max_abs_err {err:.3e}; kernel "
                f"{ms:.4f} ms ({flops / ms / 1e9:.2f} useful TFLOP/s), plain {plain_ms:.4f} ms")
            if c == 256 and dtype == torch.bfloat16:
                entry = dict(
                    name="implicit_gemm_fwd", route="cuda",
                    source="warpconvnet_tpu_torch/csrc/implicit_gemm.cu",
                    replaces="warpconvnet_tpu/kernels/implicit_gemm.py:546",
                    shape=f"B={B} K=27 N={n} C 256->256 bf16 (L0 map)",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                )
    return entry


def forward_ms(model, vox):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = model(vox.lex_sort())
    end.record()
    torch.cuda.synchronize()
    return out.features, start.elapsed_time(end)


def phase_slice(device):
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18

    model = MinkUNet18(3, NUM_CLASSES, generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    # Tight check first: a small fp32 forward, kernel path against plain path.
    small = make_batch(100, 4096, device)
    with torch.inference_mode():
        got, _ = forward_ms(model, small)
        with plain_kernels():
            ref, _ = forward_ms(model, small)
    err = rel_err(got, ref)
    check(err <= SLICE_TOL_FP32, f"fp32 slice: relative error {err:.3e} > {SLICE_TOL_FP32}")
    log(f"slice fp32 (n_cap 4096): relative error vs plain {err:.3e}")

    constants.set_compute_dtype(torch.bfloat16)
    requests = [make_batch(seed, N_CAP, device) for seed in range(1, REQUESTS + 1)]
    logits, kernel_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        for i, vox in enumerate(requests):
            before = counts()
            out, ms = forward_ms(model, vox)
            k1, k2 = (a - b for a, b in zip(counts(), before))
            check((k1, k2) == (K1_PER_FORWARD, K2_PER_FORWARD),
                  f"request {i}: {k1} K1 and {k2} K2 launches, want "
                  f"{K1_PER_FORWARD} and {K2_PER_FORWARD}")
            logits.append(out)
            kernel_ms.append(ms)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    plain_ms = []
    with torch.inference_mode(), plain_kernels():
        for i, vox in enumerate(requests):
            ref, ms = forward_ms(model, vox)
            plain_ms.append(ms)
            mask = vox.valid_mask()
            got = logits[i]
            check(tuple(got.shape) == (B, N_CAP, NUM_CLASSES), f"logits shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"request {i}: non-finite logits")
            check(bool((got[~mask] == 0).all()), f"request {i}: pad rows not zero")
            err = rel_err(got[mask], ref[mask])
            check(err <= SLICE_TOL_BF16,
                  f"request {i}: relative error {err:.3e} > {SLICE_TOL_BF16}")
            log(f"request {i}: {int(vox.num_valid.sum())} voxels, kernel path "
                f"{kernel_ms[i]:.3f} ms, plain path {ms:.3f} ms, relative error {err:.3e}")
    constants.set_compute_dtype(None)
    log(f"slice bf16: forward ms kernel {kernel_ms}, plain {plain_ms}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches K1 {launches[0]}, K2 {launches[1]}")
    return launches



def phase_bwd(vox, table3):
    """K2-dgrad and K3 on the L0 -> L1 parity map and its reverse, K4 on the
    L0 3^3 map, against their plain versions; returns the JSON entries."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets

    _, _, down, _ = generate_output_coords_and_kernel_map(
        vox, 2, stride=2, out_capacity=N_CAP // 2
    )
    up = down.reversed()
    offsets3 = kernel_offsets(3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    n0, n1 = vox.max_num_points, down.table.shape[2]
    entries = {}

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def dw_err(got, ref):
        err = rel_err(got, ref)
        check(err <= DW_TOL, f"dw relative error {err:.3e} > {DW_TOL}")
        return err

    for c_in, c_out, dtype in ((32, 32, torch.float32), (128, 96, torch.bfloat16),
                               (96, 96, torch.bfloat16)):
        tag = f"C {c_in}->{c_out} {str(dtype)[6:]}"
        # 2^3 maps: the encoder conv (fine L0 -> coarse L1) and the decoder's
        # transposed conv (L1 -> L0) through the reversed map.
        for name, bpt, n_in, n_out in (("strided L0->L1", down, n0, n1),
                                       ("transposed L1->L0", up, n1, n0)):
            x = rand((B, n_in, c_in)).to(dtype)
            g = rand((B, n_out, c_out), n_out ** -0.5).to(dtype)
            w = rand((8, c_in, c_out), (8 * c_in) ** -0.5).to(dtype)
            rev = bpt.rev.contiguous()
            dx = ig.implicit_gemm_dgrad(g, w, rev)
            ref_dx = ig.implicit_gemm_dgrad_plain(g, w, rev)
            dw = ig.implicit_gemm_wgrad(x, g, bpt.table)
            ref_dw = ig.implicit_gemm_wgrad_plain(x, g, bpt.table)
            torch.cuda.synchronize()
            torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dtype])
            dx_err = float((dx.float() - ref_dx.float()).abs().max())
            w_err = dw_err(dw, ref_dw)
            w_abs = float((dw - ref_dw).abs().max())
            t = dict(
                dgrad=cuda_ms(lambda: ig.implicit_gemm_dgrad(g, w, rev)),
                dgrad_plain=cuda_ms(lambda: ig.implicit_gemm_dgrad_plain(g, w, rev)),
                wgrad=cuda_ms(lambda: ig.implicit_gemm_wgrad(x, g, bpt.table)),
                wgrad_plain=cuda_ms(lambda: ig.implicit_gemm_wgrad_plain(x, g, bpt.table)),
            )
            pairs = int((bpt.table >= 0).sum())
            log(f"{name} {tag} ({pairs} pairs): K2-dgrad max_abs_err {dx_err:.3e}, "
                f"{t['dgrad']:.4f} ms, plain {t['dgrad_plain']:.4f} ms; K3 rel err "
                f"{w_err:.3e} (max_abs {w_abs:.3e}), {t['wgrad']:.4f} ms, "
                f"plain {t['wgrad_plain']:.4f} ms")
            if name.startswith("transposed") and (c_in, c_out) == (96, 96):
                shape = f"B={B} K=8 N_in={n_in} N_out={n_out} C 96->96 bf16 ({name} 2^3 map)"
                entries["dgrad"] = dict(
                    name="implicit_gemm_dgrad", route="cuda",
                    source="warpconvnet_tpu_torch/csrc/implicit_gemm.cu",
                    replaces="warpconvnet_tpu/kernels/implicit_gemm.py:546",
                    shape=shape, max_abs_err=dx_err, ms=t["dgrad"], plain_ms=t["dgrad_plain"],
                )
                entries["wgrad"] = dict(
                    name="implicit_gemm_wgrad", route="cuda",
                    source="warpconvnet_tpu_torch/csrc/implicit_gemm_wgrad.cu",
                    replaces="warpconvnet_tpu/kernels/implicit_gemm.py:683",
                    shape=shape, max_abs_err=w_abs, ms=t["wgrad"], plain_ms=t["wgrad_plain"],
                )
        # The L0 3^3 self-map: K4, its plain version, and the split pair.
        x = rand((B, n0, c_in)).to(dtype)
        g = rand((B, n0, c_out), n0 ** -0.5).to(dtype)
        w = rand((27, c_in, c_out), (27 * c_in) ** -0.5).to(dtype)
        rev3 = table3.flip(1).contiguous()
        dx, dw = ig.implicit_gemm_bwd_fused(x, g, w, table3, offsets3)
        ref_dx, ref_dw = ig.implicit_gemm_bwd_fused_plain(x, g, w, table3, offsets3)
        torch.cuda.synchronize()
        torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dtype])
        dx_err = float((dx.float() - ref_dx.float()).abs().max())
        w_err = dw_err(dw, ref_dw)
        ms = cuda_ms(lambda: ig.implicit_gemm_bwd_fused(x, g, w, table3, offsets3))
        plain_ms = cuda_ms(lambda: ig.implicit_gemm_bwd_fused_plain(x, g, w, table3, offsets3))
        pair_ms = cuda_ms(lambda: (ig.implicit_gemm_dgrad(g, w, rev3),
                                   ig.implicit_gemm_wgrad(x, g, table3)))
        log(f"L0 3^3 self-map {tag}: K4 dx max_abs_err {dx_err:.3e}, dw rel err "
            f"{w_err:.3e}; K4 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"K2-dgrad + K3 pair {pair_ms:.4f} ms")
        if (c_in, c_out) == (128, 96):
            entries["fused"] = dict(
                name="implicit_gemm_bwd_fused", route="cuda",
                source="warpconvnet_tpu_torch/csrc/implicit_gemm_bwd_fused.cu",
                replaces="warpconvnet_tpu/kernels/implicit_gemm.py:801",
                shape=f"B={B} K=27 N={n0} C 128->96 bf16 (L0 3^3 map)",
                max_abs_err=dx_err, ms=ms, plain_ms=plain_ms, pair_ms=pair_ms,
            )
    return entries


def train_steps(model, state0, batch, labels, steps, plain):
    """Run ``steps`` train steps from ``state0`` with a fresh Adam. Returns
    (losses, step ms, launches per step, step 1's (loss, grads, params))."""
    from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

    model.load_state_dict(state0)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=ADAM_EPS)
    step = make_segmentation_train_step(model, opt, NUM_CLASSES)
    losses, times, launches, first = [], [], [], None
    with plain_kernels() if plain else nullcontext():
        for i in range(steps):
            before = all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, labels)["loss"]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: v - before[k] for k, v in all_counts().items()})
            losses.append(float(loss))
            check(np.isfinite(losses[-1]), f"step {i}: loss {losses[-1]}")
            for name, p in model.named_parameters():
                check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                      f"step {i}: {name} has no finite grad")
            if i == 0:
                first = (losses[0],
                         {n: p.grad.detach().float().clone() for n, p in model.named_parameters()},
                         {n: p.detach().clone() for n, p in model.named_parameters()})
    return losses, times, launches, first


def grad_err(a, b):
    """Relative Frobenius error of all gradients of ``a`` against ``b``, and
    the three tensors with the largest relative error of their own."""
    names = sorted(b)
    total = rel_err(torch.cat([a[n].flatten() for n in names]),
                    torch.cat([b[n].flatten() for n in names]))
    worst = sorted(((rel_err(a[n], b[n]), n) for n in names), reverse=True)[:3]
    return total, ", ".join(f"{n} {e:.2e}" for e, n in worst)


def compare_first_steps(got, ref, again, state0, dtype, label):
    """Step 1 on the kernel path against the plain path: loss, all
    gradients (relative Frobenius error) and the post-step parameters.
    ``again`` is a second kernel-path step 1, whose spread from the first
    (fp32 atomics add in a varying order) is logged beside the error."""
    tol = TRAIN_TOL[dtype]
    loss_err = abs(got[0] - ref[0]) / abs(ref[0])
    g_err, g_worst = grad_err(got[1], ref[1])
    spread, _ = grad_err(again[1], got[1])
    check(loss_err <= tol["loss"], f"{label}: loss relative error {loss_err:.3e} > {tol['loss']}")
    check(g_err <= tol["grads"], f"{label}: gradient relative error {g_err:.3e} > {tol['grads']}")
    # Adam's first step moves each parameter by lr * g / (|g| + eps). Where
    # the two gradients share a sign and both are >= 1e4 eps, the two moves
    # differ by at most lr * 1e-4; elsewhere they are at most 2 lr apart.
    firm = total = 0
    worst = worst_firm = 0.0
    for n in sorted(ref[1]):
        diff = (got[2][n] - ref[2][n]).abs()
        agree = (torch.sign(got[1][n]) == torch.sign(ref[1][n])) & (
            torch.minimum(got[1][n].abs(), ref[1][n].abs()) >= 1e4 * ADAM_EPS)
        worst = max(worst, float(diff.max()))
        if bool(agree.any()):
            worst_firm = max(worst_firm, float(diff[agree].max()))
        firm += int(agree.sum())
        total += diff.numel()
        check(not torch.equal(got[2][n], state0[n]), f"{label}: step 1 left {n} unchanged")
    check(worst <= 2 * LR * (1 + 1e-3), f"{label}: parameters {worst:.3e} apart > 2 lr")
    check(worst_firm <= 3e-7, f"{label}: parameters {worst_firm:.3e} apart where the grads agree")
    log(f"{label} step 1 vs plain: loss {got[0]:.6f} / {ref[0]:.6f} (rel err {loss_err:.3e}), "
        f"gradient rel err {g_err:.3e} (worst: {g_worst}), kernel path run-to-run "
        f"{spread:.3e}; params max diff {worst:.3e} ({worst_firm:.3e} on the "
        f"{firm / total:.4%} of entries with firm, agreeing grads)")


def phase_train(device):
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18

    model = MinkUNet18(3, NUM_CLASSES, generator=torch.Generator().manual_seed(0)).to(device)
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}

    def labels_for(vox, seed):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(
            rng.integers(0, NUM_CLASSES, size=tuple(vox.coords.shape[:2])).astype(np.int64)
        ).to(device)

    # Tight check first: one small fp32 step, kernel path against plain path.
    small = make_batch(200, 4096, device).lex_sort()
    small_labels = labels_for(small, 201)
    _, _, _, got = train_steps(model, state0, small, small_labels, 1, plain=False)
    _, _, _, again = train_steps(model, state0, small, small_labels, 1, plain=False)
    _, _, _, ref = train_steps(model, state0, small, small_labels, 1, plain=True)
    compare_first_steps(got, ref, again, params0, torch.float32, "train fp32 (n_cap 4096)")

    constants.set_compute_dtype(torch.bfloat16)
    batch = make_batch(7, N_CAP, device).lex_sort()
    labels = labels_for(batch, 8)
    points = int(batch.num_valid.sum())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, ms, launches, got = train_steps(model, state0, batch, labels, TRAIN_STEPS, plain=False)
    totals = all_counts()
    peak = torch.cuda.max_memory_allocated()
    p_losses, p_ms, p_launches, ref = train_steps(
        model, state0, batch, labels, TRAIN_STEPS, plain=True
    )
    _, _, _, again = train_steps(model, state0, batch, labels, 1, plain=False)
    constants.set_compute_dtype(None)
    for i, per in enumerate(launches):
        check(per == PER_STEP, f"step {i}: launches {per}, want {PER_STEP}")
    check(all(sum(per.values()) == 0 for per in p_launches), "the plain path launched a kernel")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    compare_first_steps(got, ref, again, params0, torch.bfloat16, "train bf16 (bench scale)")
    steady, p_steady = ms[1:], p_ms[1:]
    pps = points * len(steady) / (sum(steady) / 1e3)
    log(f"train bf16: {points} voxels; losses kernel path {losses}, plain path {p_losses}")
    log(f"train bf16: step ms (steps 2-{TRAIN_STEPS}) kernel {[round(t, 3) for t in steady]}, "
        f"plain {[round(t, 3) for t in p_steady]}; step 1 kernel {ms[0]:.3f}, plain "
        f"{p_ms[0]:.3f}; {pps:.1f} points/s; peak memory {peak / 2**30:.3f} GiB; "
        f"launches over {TRAIN_STEPS} steps {totals}")
    return totals


def profile_step(device, out_dir):
    """Profile one bench-scale bf16 train step after two warm-up steps:
    device time by kernel, the device span and its idle share."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18
    from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

    model = MinkUNet18(3, NUM_CLASSES, generator=torch.Generator().manual_seed(0)).to(device)
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                        NUM_CLASSES)
    constants.set_compute_dtype(torch.bfloat16)
    batch = make_batch(7, N_CAP, device).lex_sort()
    labels = torch.from_numpy(np.random.default_rng(8).integers(
        0, NUM_CLASSES, size=tuple(batch.coords.shape[:2]))).to(device)
    for _ in range(2):
        step(batch, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "train_step_trace.json")
    prof.export_chrome_trace(trace)
    # Device work from the exported trace: every kernel, copy and memset.
    with open(trace) as f:
        ops = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in ops) / 1e3
    span = (max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops)) / 1e3
    by_name = {}
    for e in ops:
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"] / 1e3)
    print(f"profiled step: host wall {wall:.3f} ms, device busy {busy:.3f} ms over a span of "
          f"{span:.3f} ms, idle share {1 - busy / span:.1%}, {len(ops)} device ops")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"{t:10.3f} ms {t / busy:6.1%} {n:5d}x  {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one bench-scale train step into DIR instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        log(f"chip_smoke: needs an sm_90 card, found sm_{cap[0]}{cap[1]}")
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from warpconvnet_tpu_torch.kernels import _build  # fails outside the repo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    if args.profile:
        profile_step(device, args.profile)
        return 0

    vox = make_batch(0, N_CAP, device).lex_sort()
    log(f"bench scene pair: {vox.num_valid.tolist()} voxels")
    table, k1 = phase_k1(vox)
    k2 = phase_k2(vox, table)
    bwd = phase_bwd(vox, table)
    del table, vox
    inference = phase_slice(device)
    k1["inference_launches"], k2["inference_launches"] = inference
    launches = phase_train(device)
    entries = dict(k1=k1, fwd=k2, **bwd)
    for key, entry in entries.items():
        entry["launches"] = launches[key]
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
