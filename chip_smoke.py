"""GPU smoke run of the PyTorch port: MinkUNet18 inference on an H100.

    python3 chip_smoke.py

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
Prints one JSON line of per-kernel results, then the ok line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
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


@contextmanager
def plain_kernels():
    """Route the conv path through the kernels' plain versions, also on
    CUDA tensors: the reference for the kernel path on the same card."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm, sorted_search

    with mock.patch.object(
        sorted_search, "kernel_map_probe", sorted_search.kernel_map_probe_plain
    ), mock.patch.object(
        implicit_gemm, "implicit_gemm_fwd", implicit_gemm.implicit_gemm_fwd_plain
    ):
        yield


def reset_counts():
    from warpconvnet_tpu_torch.kernels import implicit_gemm, sorted_search

    sorted_search.kernel_map_probe.launches = 0
    implicit_gemm.implicit_gemm_fwd.launches = 0


def counts():
    from warpconvnet_tpu_torch.kernels import implicit_gemm, sorted_search

    return sorted_search.kernel_map_probe.launches, implicit_gemm.implicit_gemm_fwd.launches


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


def main() -> int:
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

    vox = make_batch(0, N_CAP, device).lex_sort()
    log(f"bench scene pair: {vox.num_valid.tolist()} voxels")
    table, k1 = phase_k1(vox)
    k2 = phase_k2(vox, table)
    del table, vox
    launches = phase_slice(device)
    k1["launches"], k2["launches"] = launches
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
