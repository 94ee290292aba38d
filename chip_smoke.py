"""GPU smoke run of the PyTorch port on an H100: MinkUNet18 inference and
training, the depthwise / grouped conv path (a SparseConvNeXtBlock), Volt-s
inference and training (segment attention and its backward), and Point
Transformer V3's kernel shapes and training.

    python3 chip_smoke.py                  # the smoke run below
    python3 chip_smoke.py --profile DIR    # profile a MinkUNet18 train step, a ConvNeXt
                                           # fwd+bwd, a Volt-s forward and a Volt-s train step

Phases (any failure exits non-zero):
  1. device: needs CUDA and an sm_90 card; prints the card's name and
     power limit as nvidia-smi reports them.
  2. build: compiles the CUDA kernels from ``warpconvnet_tpu_torch/csrc``.
  3. K1: the L0 3^3 kernel map of one bench scene pair (B=2,
     n_cap=131072) and its 7^3 self-map (the ConvNeXt block's), CUDA kernel
     against its plain version: equal tables; each timed against the plain
     version, torch.searchsorted of the formed queries and its bound, with
     the share of tiles walked in device memory (window wider than shared
     memory).
  4. K2: the implicit-GEMM forward on that map at C 32->32 and 256->256 in
     fp32 and bf16, CUDA kernel against its plain version, its tiles in the
     map's row order and in the index order (the same bits).
  5. slice: MinkUNet18 (3 -> 20 classes, bf16 compute, fp32 params, seeded
     weights, eval mode) answers 3 requests, each a fresh scene pair whose
     maps are built inside the forward. Checks finite logits, 5 K1 and 40
     K2 launches per forward, and agreement with the plain path on the
     card; a small fp32 forward checks the kernels tightly.
  6. backward kernels: K2 as dgrad and K3 on the L0 -> L1 2^3 parity map
     and its reverse, K4 on the L0 3^3 map (also timed against the K2-dgrad
     + K3 pair), each against its plain version at C 32 fp32 and at the
     bf16 shapes 128 -> 96 and 96 -> 96, K3 and K4 with the floats their dw
     blocks add with atomics (their own counts) held against the host
     model. K2, K2-dgrad and K4 take their tiles in the maps' row orders.
  6b. step shapes: K2, K2-dgrad, K3 and K4 at every call shape of the bf16
     MinkUNet18 train step on the bench pair (the 3^3 maps of L0-L4 and the
     2^3 maps and their reverses), each against its plain version, timed,
     with its bound and launches a step (K3 and K4 with their dw counts
     against the host model); each map's tile work over its useful pairs
     in the index order and in its row order.
  7. train: MinkUNet18 (bf16 compute, fp32 params, seeded weights and
     labels, Adam 1e-3) takes 5 steps on one bench scene pair on the kernel
     path and 5 from the same state on the plain path. Checks 5 K1, 40 K2,
     8 K2-dgrad, 8 K3 and 32 K4 launches per step, a finite loss and a
     finite grad on every parameter, a falling loss, and step 1's loss,
     gradients and parameters against the plain path; a small fp32 step
     checks the kernels tightly. Logs step ms, points/s and peak memory.
  8. K5: K1's kernel on offsets that form no grid (the 7-point cross), the
     contract of the JAX package's plain probe: equal tables, timed as in 3.
  9. depthwise kernels: K6 forward on the bench pair's 7^3 map at C 96
     (bf16, fp32) and on the L0 3^3 map at C 96 and 384; K6 as dgrad and K7
     on the L0 -> L1 2^3 parity map and its reverse; K8 on the 7^3 and 3^3
     self-maps. Each against its plain version, timed; K8's dx also with
     the bits of K6 on (g, w flipped), and the floats K7's and K8's blocks
     add into dw (their own counts, ``tracing`` ``k7.dw_floats`` and
     ``k8.dw_floats``) held against the host model ``bwd_fused_dw_adds``.
 10. convnext: SparseConvNeXtBlock(96, kernel 7) on the bench scene pair
     (bf16 features, fp32 parameters, seeded weights): fwd+bwd of
     sum(out^2) with 1 K1, 1 K6 and 1 K8 launch, an inference forward with
     1 K1 and 1 K6, finite outputs and gradients, agreement with the plain
     path; a small fp32 block checks the kernels tightly. Logs fwd ms,
     fwd+bwd ms, voxels/s and peak memory.
 11. strided depthwise and grouped: a 2^3 stride-2 SparseDepthwiseConv3d
     fwd+bwd (1 K6, 1 K6-dgrad, 1 K7) and a 3^3 groups=2 SparseConv3d
     fwd+bwd (1 K1, 1 K2, 1 K4), each against the plain route.
 12. K9: segment attention at Volt-s's trunk shape (q/k/v [2, 40960, 6, 64],
     validity from the bench pair's real token counts), fp32 and bf16, then
     a grouped layout (segments of 1024 rows), cross attention (Sq 4096,
     Skv 40960) and D 16; each against its plain version, timed, with the
     share of kv tiles visited and one scaled_dot_product_attention per
     scene on its valid rows as the library yardstick; fp32 at the trunk
     shape also against a float64 plain forward (out and lse); each fp32
     case with its scratch bytes, the kv rows split (once each) and the
     rows its blocks copied in, and their ratio, the reuse of each split.
 13. volt: Volt-s (3 -> 20 classes, dim 384, 6 heads, depth 12, bf16 conv
     compute, fp32 parameters, seeded weights, eval mode, token capacity
     40960) answers 3 requests, each a fresh bench scene pair whose maps
     are built inside the forward. Checks finite logits, zero pad rows, no
     dropped token (against torch.unique of coords // 4), 1 K1, 2 K2 and
     12 K9 launches per forward, and agreement with the plain path on the
     card; a small fp32 Volt checks the kernels tightly. Logs forward ms,
     tokens/s, points/s and peak memory.
 14. K9-dkv and K9-dq: the segment-attention backward at Volt-s's trunk
     shape (as phase 12, dO zero on pad rows), fp32 and bf16 (the bf16
     kernels on the tensor cores), then the grouped and cross layouts, a
     grouped layout whose every 7th query row matches nothing, and D 16 (4
     heads) on the grouped layout; each against the plain backward
     (relative error of dq, dk and dv, zero dq on unmatched rows), timed,
     with the backward of one scaled_dot_product_attention per scene on its
     valid rows as the library yardstick.
 15. volt train: Volt-s (as phase 13, token capacity 40960, Adam 1e-3,
     seeded labels) takes 5 steps on one bench scene pair on the kernel
     path and 2 from the same state on the plain path. Checks 1 K1, 2 K2,
     2 K4, 12 K9, 12 K9-dkv and 12 K9-dq launches per step, a finite loss
     and a finite grad on every parameter, a loss falling from step 2 on
     (Adam's first update at lr 1e-3 overshoots), and step 1's loss,
     gradients and parameters against the plain path; a
     small fp32 Volt step checks the kernels tightly. Logs step ms,
     points/s, tokens/s and peak memory.
 16. PTv3 shapes: a bench scene pair of 6 channels (n_cap 262144) at PTv3's
     five levels (stride-2 grid max pooling). K2 and K4 (bf16, in the maps'
     row orders) on the 5^3 stem map at C 6 -> 32 and on each level's 3^3
     map at its positional conv's width (32 to 512); K9, K9-dkv and K9-dq
     (fp32) at level 0's patch shape [2, 262144, 2, 16], 1024-row patches
     of the valid rows and the pad rows on ids that match nothing
     (``patch_segment_ids``). Each against its plain version, timed beside
     its bound; pad rows' outputs and dq zero, and K9's visited kv tiles
     within 1.1x those of the valid rows alone.
 17. ptv3 train: PTv3 at its published widths (bf16 stem and positional
     convs, fp32 trunk and parameters, seeded weights and labels, Adam
     1e-3) takes 5 steps on a bench scene pair of 6 channels at n_cap
     262144. Checks 6 K1, 23 K2, 23 K4, 22 K9, 22 K9-dkv and 22 K9-dq
     launches per step, a finite loss and a finite grad on every parameter
     and a loss falling from step 2 on; first, a small fp32 PTv3 step (the
     published depths at small widths, 64-row patches) against the plain
     path checks the kernels tightly (phase 16 holds the bench scale's
     shapes to their plain versions, whose attention does not fit beside a
     bench-scale step). Logs step ms, points/s and peak memory.
Prints one JSON line of per-kernel results (time, plain time, bound from
the bytes and operations of this run's inputs, the time of a one-call
PyTorch equivalent where one exists, launches on the main paths), then the
ok line last.

Launches are the ``tracing`` registry's host counters; the kernels' own
counts are its device counters, which count only while recording, so the
checks that read them record around their launches, and the main-path
phases (from phase 6 on) run while recording, their spans on (about 8 us
of host time each).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager, nullcontext
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
# The table convs of a MinkUNet18 step (models/mink_unet.py), (c_in, c_out,
# convs a step): the 3^3 convs of each level (encoder stage, then decoder
# stage), the 2^3 strided convs Li -> Li+1 and the transposed convs
# Li+1 -> Li, i = 0..3.
STEP_SUB = {
    0: ((128, 96, 1), (96, 96, 3)),
    1: ((32, 32, 4), (128, 96, 1), (96, 96, 3)),
    2: ((32, 64, 1), (64, 64, 3), (192, 128, 1), (128, 128, 3)),
    3: ((64, 128, 1), (128, 128, 3), (384, 256, 1), (256, 256, 3)),
    4: ((128, 256, 1), (256, 256, 3)),
}
STEP_DOWN = ((32, 32), (32, 32), (64, 64), (128, 128))
STEP_UP = ((96, 96), (128, 96), (256, 128), (256, 256))
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
# The depthwise path (SparseConvNeXtBlock and the strided depthwise conv):
# kernel path against plain path, relative Frobenius error of outputs and
# gradients. fp32: the same sums in another order. bf16: the depthwise
# output and dx are rounded to bf16 once, so a one-ulp flip (2^-8) where
# the orders differ reaches the fp32 block output through LayerNorm.
DEPTH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CONVNEXT_C = 96
CONVNEXT_K = 7
CONVNEXT_REPEATS = 3
VOLT_S_C = 384
VOLT_HEADS = 6
VOLT_DEPTH = 12
PATCH = 4
TOKEN_CAPACITY = 40960
K9_PER_FORWARD = VOLT_DEPTH
# K9 against its plain version, relative Frobenius error of the output and
# its largest absolute error over the reference's largest value. fp32: the
# same sums in another order, online softmax against one pass. bf16: the
# kernel rounds the unnormalised probabilities to bf16 before P V, the plain
# version the normalised ones, and both round the output.
K9_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# fp32 K9 (3xTF32) against a float64 plain forward of the same inputs at
# the trunk shape, relative Frobenius error of out and of lse (rows that
# match something): tests/test_torch_gpu.py's K9_FP64_TOL, where a forward
# of single TF32 products falls outside.
K9_FP64_TOL = {"out": 1.2e-5, "lse": 2e-6}
# Volt-s logits, kernel path against plain path (relative Frobenius): bf16
# stem convs round differently where sums run in another order; the small
# fp32 Volt runs the same sums in another order.
VOLT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K9-dkv / K9-dq against the plain backward, relative Frobenius error of
# each gradient. fp32: the same sums in another order. bf16: both round P
# and scale * dS to bf16 at the stock TPU kernels' points and each gradient
# once; the fp32 sums' order and exp2 against exp may flip one rounding by
# an ulp (2^-8).
K9_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
VOLT_TRAIN_STEPS = 5
VOLT_PER_STEP = dict(k1=1, fwd=2, fused=2, attn=VOLT_DEPTH, dkv=VOLT_DEPTH, dq=VOLT_DEPTH)
# Volt step 1 on the kernel path against the plain path, same card, same
# state (the rules of TRAIN_TOL). fp32 (the small Volt): the same sums in
# another order (measured: loss equal, gradients 2.4e-7, run-to-run 1.1e-7
# from the stem's K4 atomics). bf16 stem, fp32 trunk (bench scale):
# measured loss 7.3e-8, gradients 6.3e-5 (worst the stem's conv weights,
# 1.9e-4), run-to-run 5.7e-6; the trunk is fp32, so the bf16 rounding that
# widens MinkUNet's bound touches only the two stem convs. Bounds about 3x
# (H100 80GB HBM3, 700 W).
VOLT_TRAIN_TOL = {
    torch.float32: dict(loss=2e-7, grads=7.5e-7),
    torch.bfloat16: dict(loss=2e-7, grads=1.8e-4),
}
# Point Transformer V3 at its published widths (models/point_transformer_v3.py)
# on a bench scene pair of 6 input channels padded to PTV3_N_CAP rows a scene,
# five levels at capacities n_cap >> level.
PTV3_N_CAP = 1 << 18
PTV3_IN = 6
PTV3_WIDTHS = (32, 64, 128, 256, 512)
PTV3_PATCH = 1024
# Positional (xCPE) convs a step at each level: the encoder's blocks and
# the decoder's.
PTV3_CPE = (4, 4, 4, 8, 2)
PTV3_TRAIN_STEPS = 5
# A PTv3 step: K1 builds the 5^3 stem map and each level's 3^3 map; the stem
# and the 22 blocks' positional convs run K2 forward and K4 backward; the 22
# blocks' patch attention K9, K9-dkv and K9-dq.
PTV3_PER_STEP = dict(k1=6, fwd=23, fused=23, attn=22, dkv=22, dq=22)
# PTv3 step 1 on the kernel path against the plain path, same card, same
# state (the rules of TRAIN_TOL), fp32, the published depths at small widths
# and 64-row patches: the same sums in another order (measured: loss equal,
# gradients 3.2e-6, worst BN and dense biases, sums that cancel; run-to-run
# 2.0e-7 from K4's atomics). Bounds about 3x (H100 80GB HBM3, 700 W). At the
# bench scale the plain path's attention does not fit beside the step's
# activations (its chunk's scores over all 262144 rows ran out of memory).
PTV3_TRAIN_TOL = dict(loss=2e-7, grads=1e-5)
# Bounds (H100 SXM datasheet figures): HBM rate, and
# dense peaks by the inputs' type (fp32: the CUDA cores' FMA).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32-accurate products on the TF32 tensor cores (494.7 TFLOP/s dense):
# three TF32 products a product (3xTF32), as the fp32 K9-dkv / K9-dq run.
# The bound_ms of every fp32 attention entry (K9, K9-dkv, K9-dq) is at this
# rate, with the FMA bound beside it as fma_bound_ms.
TF32X3_FLOPS = 494.7e12 / 3


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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn``'s kernels a call, from a profiler trace of
    ``iters`` back-to-back calls. A kernel of tens of microseconds finishes
    before the host has launched the next, so ``cuda_ms`` times the host's
    launch rate there; the trace times the kernels themselves."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    # The trace may drop an event: a mean per kernel name, each kernel of
    # ``fn`` launched once a call; a trace that lost every kernel event is
    # taken again (at most three windows).
    by_name = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                by_name.setdefault(e["name"], []).append(e["dur"])
        if by_name:
            break
    check(by_name != {}, "device_ms: no kernel in three traces")
    return sum(sum(d) / len(d) for d in by_name.values()) / 1e3


def bound(nbytes: float, flops: float = 0.0, dtype=torch.float32, peak=None):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over ``peak`` (by
    default the peak rate for ``dtype``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.cache
def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock, power draw and temperature now, as nvidia-smi
    reports them: beside a timing, they show whether the card ran below its
    clocks."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def wgrad_nbytes(x, g, table, dw) -> int:
    """Bytes a weight gradient ``dw[k] = sum x[b, table[b, k, o]]^T g[b, o]``
    (K3, K7) must move: the table and dw once, the x rows that an entry
    names and the g rows that hold a pair; padding rows and rows without
    a pair need not be read."""
    valid = table >= 0
    x_rows = sum(int(torch.unique(t[v]).numel()) for t, v in zip(table, valid))
    g_rows = int(valid.any(1).sum())
    return (nbytes(table, dw) + x_rows * x.shape[2] * x.element_size()
            + g_rows * g.shape[2] * g.element_size())


def make_batch(seed: int, n_cap: int, device, channels: int = 3, scale: float = 1.0,
               coord_range: int = 512):
    """The bench's input: B surface scenes on ``coord_range``^2 columns,
    ``channels`` random feature channels (times ``scale``)."""
    from warpconvnet_tpu_torch.geometry.voxels import Voxels
    from warpconvnet_tpu_torch.ops.keys import PAD_COORD
    from warpconvnet_tpu_torch.utils.scenes import make_surface_scene

    rng = np.random.default_rng(seed)
    coords = np.full((B, n_cap, 3), PAD_COORD, np.int32)
    feats = np.zeros((B, n_cap, channels), np.float32)
    nv = np.zeros((B,), np.int32)
    for i in range(B):
        c = make_surface_scene(rng, n_cap, coord_range=coord_range)
        nv[i] = len(c)
        coords[i, : len(c)] = c
        feats[i, : len(c)] = rng.standard_normal((len(c), channels)) * scale
    return Voxels.create(coords, feats, nv, device=device)


@functools.cache
def wrappers():
    """Every kernel wrapper, keyed as in ``PER_STEP`` (the depthwise ones
    by ``d``-keys, segment attention as ``attn``, ``dkv`` and ``dq``);
    taken once, so that counts can be read while ``plain_kernels`` patches
    them."""
    from warpconvnet_tpu_torch.kernels import depthwise_fma as dw
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig, sorted_search
    from warpconvnet_tpu_torch.kernels import segment_attention as k9

    return dict(k1=sorted_search.kernel_map_probe, fwd=ig.implicit_gemm_fwd,
                dgrad=ig.implicit_gemm_dgrad, wgrad=ig.implicit_gemm_wgrad,
                fused=ig.implicit_gemm_bwd_fused, dfwd=dw.depthwise_fma_fwd,
                ddgrad=dw.depthwise_fma_dgrad, dwgrad=dw.depthwise_fma_wgrad,
                dfused=dw.depthwise_fma_bwd_fused, attn=k9.segment_attention_fwd,
                dkv=k9.segment_attention_bwd_dkv, dq=k9.segment_attention_bwd_dq)


@contextmanager
def plain_kernels():
    """Route the conv paths through the kernels' plain versions, also on
    CUDA tensors: the reference for the kernel path on the same card."""
    from warpconvnet_tpu_torch.kernels import depthwise_fma as dw
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig, sorted_search
    from warpconvnet_tpu_torch.kernels import segment_attention as k9

    modules = {"k1": sorted_search, "fwd": ig, "dgrad": ig, "wgrad": ig, "fused": ig,
               "dfwd": dw, "ddgrad": dw, "dwgrad": dw, "dfused": dw, "attn": k9, "dkv": k9,
               "dq": k9}

    def orderless(plain):  # K2 and K4 take a row order; their plain versions take none
        return lambda *args, order=None, **kwargs: plain(*args, **kwargs)

    with ExitStack() as stack:
        for key, fn in wrappers().items():
            plain = getattr(modules[key], fn.__name__ + "_plain")
            stack.enter_context(mock.patch.object(
                modules[key], fn.__name__, orderless(plain) if key in ("fwd", "dgrad", "fused")
                else plain
            ))
        # K9-dkv and K9-dq share one pass of the plain backward.
        stack.enter_context(mock.patch.object(k9, "segment_attention_bwd",
                                              k9.segment_attention_bwd_plain))
        yield


_launch_base = {}  # each wrapper's launches at the last reset_counts()


def _launches(key):
    from warpconvnet_tpu_torch import tracing

    return tracing.counters().get(f"launches.{wrappers()[key].__name__}", 0)


def reset_counts():
    _launch_base.update({key: _launches(key) for key in wrappers()})


def counts():
    got = all_counts(("k1", "fwd"))
    return got["k1"], got["fwd"]


def all_counts(keys=tuple(PER_STEP)):
    return {key: _launches(key) - _launch_base.get(key, 0) for key in keys}


@contextmanager
def device_counts(device):
    """Record while the block runs; the dict it yields then holds what each
    device counter of ``tracing`` gained on ``device`` (synchronises)."""
    from warpconvnet_tpu_torch import tracing

    before = tracing.counters(device)
    gained = {}
    with tracing.recording():
        yield gained
    after = tracing.counters(device)
    gained.update({k: after[k] - before[k] for k in tracing.DEVICE_KEYS})


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def probe_case(vox, offsets, label):
    """K1 on the bench pair's self-map under ``offsets``: the table against
    the plain version (bit-equal), then the kernel, the plain version and
    torch.searchsorted of the formed query keys timed back to back with
    CUDA events as every kernel here is (the kernel and torch.searchsorted
    also from a profiler trace, ``device_ms``: a kernel shorter than its
    launch is timed at the host's launch rate by events), the bound, and the
    share of tiles whose window of keys did not fit in shared memory and was
    walked in device memory. Returns (table, numbers)."""
    from warpconvnet_tpu_torch.kernels import sorted_search
    from warpconvnet_tpu_torch.ops.keys import PAD_COORD, coord_keys

    keys = coord_keys(torch.where(vox.valid_mask()[..., None], vox.coords, PAD_COORD))
    args = (keys, vox.num_valid, vox.coords, vox.num_valid, offsets, (1, 1, 1))
    with device_counts(vox.coords.device) as gained:
        got = sorted_search.kernel_map_probe(*args)
    ref = sorted_search.kernel_map_probe_plain(*args)
    torch.cuda.synchronize()
    tiles, wide = gained["k1.tiles"], gained["k1.wide_tiles"]
    mismatches = int((got != ref).sum())
    err = int((got.long() - ref.long()).abs().max())
    del ref
    check(mismatches == 0, f"{label}: {mismatches} table entries differ from the plain version")
    hits = int((got >= 0).sum())
    ms = cuda_ms(lambda: sorted_search.kernel_map_probe(*args))
    dev_ms = device_ms(lambda: sorted_search.kernel_map_probe(*args))
    plain_ms = cuda_ms(lambda: sorted_search.kernel_map_probe_plain(*args))
    qk, _ = sorted_search._queries(vox.coords, vox.num_valid, offsets, (1, 1, 1))
    qk = qk.reshape(B, -1).contiguous()
    lib_ms = cuda_ms(lambda: torch.searchsorted(keys, qk))
    lib_dev_ms = device_ms(lambda: torch.searchsorted(keys, qk))
    del qk
    bound_ms, bound_by = bound(nbytes(keys, vox.coords, got))
    log(f"{label} table {tuple(got.shape)}: equal to plain, {hits} pairs; kernel {ms:.4f} ms "
        f"({dev_ms:.4f} ms in a trace), plain {plain_ms:.4f} ms, torch.searchsorted "
        f"{lib_ms:.4f} ms ({lib_dev_ms:.4f} ms in a trace), bound {bound_ms:.4f} ms; {wide} of "
        f"{tiles} tiles walked in device memory; card {card_name()}")
    return got, dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                     library_device_ms=lib_dev_ms, global_share=wide / tiles)


def phase_k1(vox):
    """K1 on the L0 3^3 map and on the 7^3 map of the ConvNeXt block."""
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets

    table, entry = probe_case(vox, kernel_offsets(3), "K1 (L0 3^3)")
    big, at7 = probe_case(vox, kernel_offsets(CONVNEXT_K), "K1 (7^3, the ConvNeXt map)")
    del big
    return table, dict(
        name="kernel_map_probe", route="cuda",
        source="warpconvnet_tpu_torch/csrc/sorted_search.cu",
        replaces="warpconvnet_tpu/kernels/sorted_search.py:288",
        shape=f"B={B} K=27 M={table.shape[2]} (L0 3^3 submanifold map)", **entry,
        at_7cubed=dict(shape=f"B={B} K=343 M={table.shape[2]} (7^3 self-map)", **at7),
    )


def phase_k5(vox):
    """K1's kernel on offsets with no (dx, dy, dz) grid, the contract of the
    JAX package's plain probe K5 (``sorted_search.py:54``)."""
    cross = np.array([[1, 0, 0], [0, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0], [0, 1, 0],
                      [0, 0, -1]], np.int32)
    table, entry = probe_case(vox, cross, "K5 contract (cross offsets) by K1's kernel")
    return dict(
        name="kernel_map_probe (K5 contract: 7-point cross offsets)", route="cuda",
        source="warpconvnet_tpu_torch/csrc/sorted_search.cu",
        replaces="warpconvnet_tpu/kernels/sorted_search.py:54",
        shape=f"B={B} K=7 M={table.shape[2]} (L0, no offset grid)", **entry,
        note="not on a main path: no main path probes offsets without a grid",
    )


def phase_k2(vox, table):
    """K2 on the L0 3^3 map at C 32->32 and 256->256 in fp32 and bf16, its
    tiles in the map's row order (the main path's) and in the index order:
    the same bits, both timed."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm
    from warpconvnet_tpu_torch.ops.kernel_map import row_order

    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = vox.valid_mask()[..., None]
    n = vox.max_num_points
    order = row_order(table)
    entry = None
    for c in (32, 256):
        x32 = torch.randn((B, n, c), generator=gen, device="cuda") * mask
        w32 = torch.randn((27, c, c), generator=gen, device="cuda") / np.sqrt(27 * c)
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            got = implicit_gemm.implicit_gemm_fwd(x, w, table, order=order)
            unordered = implicit_gemm.implicit_gemm_fwd(x, w, table)
            ref = implicit_gemm.implicit_gemm_fwd_plain(x, w, table)
            torch.cuda.synchronize()
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            check(torch.equal(got.view(bits), unordered.view(bits)),
                  f"K2 C {c}: the row order changed the output's bits")
            err = float((got.float() - ref.float()).abs().max())
            torch.testing.assert_close(got.float(), ref.float(), **K2_TOL[dtype])
            ms = cuda_ms(lambda: implicit_gemm.implicit_gemm_fwd(x, w, table, order=order))
            index_ms = cuda_ms(lambda: implicit_gemm.implicit_gemm_fwd(x, w, table))
            plain_ms = cuda_ms(lambda: implicit_gemm.implicit_gemm_fwd_plain(x, w, table))
            flops = 2.0 * int((table >= 0).sum()) * c * c
            bound_ms, bound_by = bound(nbytes(x, w, table, got), flops, dtype)
            log(f"K2 C {c}->{c} {str(dtype)[6:]}: max_abs_err {err:.3e}, the same bits in "
                f"either order; kernel {ms:.4f} ms in the map's order ({flops / ms / 1e9:.2f} "
                f"useful TFLOP/s), {index_ms:.4f} ms in the index order, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            if c == 256 and dtype == torch.bfloat16:
                entry = dict(
                    name="implicit_gemm_fwd", route="cuda",
                    source="warpconvnet_tpu_torch/csrc/implicit_gemm.cu",
                    replaces="warpconvnet_tpu/kernels/implicit_gemm.py:546",
                    shape=f"B={B} K=27 N={n} C 256->256 bf16 (L0 map)",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None, index_order_ms=index_ms,
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

    model = MinkUNet18(3, NUM_CLASSES, device=device,
                       generator=torch.Generator().manual_seed(0)).eval()

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
    launches = all_counts(tuple(wrappers()))
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
        f"peak memory {peak / 2**30:.3f} GiB; launches K1 {launches['k1']}, K2 {launches['fwd']}")
    return launches


def phase_bwd(vox, table3):
    """K2-dgrad and K3 on the L0 -> L1 parity map and its reverse, K4 on the
    L0 3^3 map, against their plain versions; returns the JSON entries."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets, row_order

    _, _, down, _ = generate_output_coords_and_kernel_map(
        vox, 2, stride=2, out_capacity=N_CAP // 2
    )
    down = down.with_orders()
    up = down.reversed()
    offsets3 = kernel_offsets(3)
    order3 = row_order(table3)
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
            rev, rev_order = bpt.rev.contiguous(), bpt.rev_order
            dx = ig.implicit_gemm_dgrad(g, w, rev, order=rev_order)
            ref_dx = ig.implicit_gemm_dgrad_plain(g, w, rev)
            with device_counts(x.device) as gained:
                dw = ig.implicit_gemm_wgrad(x, g, bpt.table)
            floats, plan = gained["k3.dw_floats"], ig.implicit_gemm_wgrad.plan
            ref_dw = ig.implicit_gemm_wgrad_plain(x, g, bpt.table)
            torch.cuda.synchronize()
            model = ig.bwd_fused_dw_atomics(bpt.table, c_in, c_out, plan["chunk_rows"])
            check(floats == model, f"K3 {name} {tag}: {floats} dw floats added, the model "
                  f"counts {model}")
            torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dtype])
            dx_err = float((dx.float() - ref_dx.float()).abs().max())
            w_err = dw_err(dw, ref_dw)
            w_abs = float((dw - ref_dw).abs().max())
            t = dict(
                dgrad=cuda_ms(lambda: ig.implicit_gemm_dgrad(g, w, rev, order=rev_order)),
                dgrad_plain=cuda_ms(lambda: ig.implicit_gemm_dgrad_plain(g, w, rev)),
                wgrad=cuda_ms(lambda: ig.implicit_gemm_wgrad(x, g, bpt.table)),
                wgrad_plain=cuda_ms(lambda: ig.implicit_gemm_wgrad_plain(x, g, bpt.table)),
            )
            pairs = int((bpt.table >= 0).sum())
            flops = 2.0 * pairs * c_in * c_out
            dgrad_bound = bound(nbytes(g, w, rev, dx), flops, dtype)
            wgrad_bound = bound(wgrad_nbytes(x, g, bpt.table, dw), flops, dtype)
            log(f"{name} {tag} ({pairs} pairs): K2-dgrad max_abs_err {dx_err:.3e}, "
                f"{t['dgrad']:.4f} ms, plain {t['dgrad_plain']:.4f} ms; K3 rel err "
                f"{w_err:.3e} (max_abs {w_abs:.3e}), {t['wgrad']:.4f} ms, "
                f"plain {t['wgrad_plain']:.4f} ms; bounds {dgrad_bound[0]:.4f} / "
                f"{wgrad_bound[0]:.4f} ms; K3 added {floats} dw floats (as the host model "
                f"counts) from {plan['dw_blocks']} blocks of {plan['chunk_rows']} rows")
            if name.startswith("transposed") and (c_in, c_out) == (96, 96):
                shape = f"B={B} K=8 N_in={n_in} N_out={n_out} C 96->96 bf16 ({name} 2^3 map)"
                entries["dgrad"] = dict(
                    name="implicit_gemm_dgrad", route="cuda",
                    source="warpconvnet_tpu_torch/csrc/implicit_gemm.cu",
                    replaces="warpconvnet_tpu/kernels/implicit_gemm.py:546",
                    shape=shape, max_abs_err=dx_err, ms=t["dgrad"], plain_ms=t["dgrad_plain"],
                    bound_ms=dgrad_bound[0], bound_by=dgrad_bound[1], library_ms=None,
                )
                entries["wgrad"] = dict(
                    name="implicit_gemm_wgrad", route="cuda",
                    source="warpconvnet_tpu_torch/csrc/implicit_gemm_wgrad.cu",
                    replaces="warpconvnet_tpu/kernels/implicit_gemm.py:683",
                    shape=shape, max_abs_err=w_abs, ms=t["wgrad"], plain_ms=t["wgrad_plain"],
                    bound_ms=wgrad_bound[0], bound_by=wgrad_bound[1], library_ms=None,
                    dw_atomic_floats=floats, chunk_rows=plan["chunk_rows"],
                )
        # The L0 3^3 self-map: K4, its plain version, and the split pair.
        x = rand((B, n0, c_in)).to(dtype)
        g = rand((B, n0, c_out), n0 ** -0.5).to(dtype)
        w = rand((27, c_in, c_out), (27 * c_in) ** -0.5).to(dtype)
        rev3 = table3.flip(1).contiguous()
        with device_counts(x.device) as gained:
            dx, dw = ig.implicit_gemm_bwd_fused(x, g, w, table3, offsets3, order=order3)
        atomics = gained["k4.dw_floats"]
        ref_dx, ref_dw = ig.implicit_gemm_bwd_fused_plain(x, g, w, table3, offsets3)
        torch.cuda.synchronize()
        model = ig.bwd_fused_dw_atomics(
            table3, c_in, c_out, ig.DW_ROWS if dtype == torch.bfloat16 else ig.F_DW_ROWS)
        check(atomics == model, f"K4 {tag}: {atomics} dw floats added, the model counts {model}")
        torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dtype])
        dx_err = float((dx.float() - ref_dx.float()).abs().max())
        w_err = dw_err(dw, ref_dw)
        ms = cuda_ms(lambda: ig.implicit_gemm_bwd_fused(x, g, w, table3, offsets3, order=order3))
        plain_ms = cuda_ms(lambda: ig.implicit_gemm_bwd_fused_plain(x, g, w, table3, offsets3))
        pair_ms = cuda_ms(lambda: (ig.implicit_gemm_dgrad(g, w, rev3, order=order3),
                                   ig.implicit_gemm_wgrad(x, g, table3)))
        fused_bound = bound(nbytes(x, g, w, table3, dx, dw),
                            4.0 * int((table3 >= 0).sum()) * c_in * c_out, dtype)
        log(f"L0 3^3 self-map {tag}: K4 dx max_abs_err {dx_err:.3e}, dw rel err "
            f"{w_err:.3e}; K4 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"K2-dgrad + K3 pair {pair_ms:.4f} ms, bound {fused_bound[0]:.4f} ms; the kernel's "
            f"dw blocks added {atomics} floats with atomics (as the host model counts)")
        if (c_in, c_out) == (128, 96):
            entries["fused"] = dict(
                name="implicit_gemm_bwd_fused", route="cuda",
                source="warpconvnet_tpu_torch/csrc/implicit_gemm_bwd_fused.cu",
                replaces="warpconvnet_tpu/kernels/implicit_gemm.py:801",
                shape=f"B={B} K=27 N={n0} C 128->96 bf16 (L0 3^3 map)",
                max_abs_err=dx_err, ms=ms, plain_ms=plain_ms, pair_ms=pair_ms,
                bound_ms=fused_bound[0], bound_by=fused_bound[1], library_ms=None,
                dw_atomic_floats=atomics,
            )
    return entries


def step_maps(vox):
    """The bench pair's MinkUNet18 maps, built as the model builds them:
    the 3^3 self-map of each level L0-L4 and the 2^3 map of each
    downsample Li -> Li+1 (the decoder's transposed conv reads it
    reversed), each with its row orders (a port whose maps take none
    keeps them as they are)."""
    from warpconvnet_tpu_torch.geometry.voxels import Voxels
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNetBase
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )

    def ordered(m):
        return m.with_orders() if hasattr(m, "with_orders") else m

    caps = MinkUNetBase._caps(vox.max_num_points)
    subs, downs = [], []
    level = vox
    for i in range(5):
        subs.append(ordered(generate_output_coords_and_kernel_map(level, 3)[2]))
        if i == 4:
            break
        oc, onv, down, ts = generate_output_coords_and_kernel_map(
            level, 2, stride=2, out_capacity=caps[i + 1]
        )
        downs.append(ordered(down))
        level = Voxels(coords=oc, features=torch.zeros_like(oc[..., :1], dtype=torch.float32),
                       num_valid=onv, voxel_size=level.voxel_size, tensor_stride=ts,
                       lex_sorted=True)
    return subs, downs


def step_shapes(subs, downs):
    """(kind, label, table, its order, rows of the gathered side, c_in,
    c_out, launches a step, the self-map for K4 or None) of every K2,
    K2-dgrad, K3 and K4 call shape of a MinkUNet18 train step on
    ``step_maps``' maps. A dgrad's c_in / c_out are those of its product:
    g's channels in, the conv's input channels out; K3's gathered side is
    x, its g has the table's rows, and it takes no order. (A port whose
    maps carry no row orders gets None.)"""
    shapes = []
    for level, sub in enumerate(subs):
        n, order = sub.table.shape[2], getattr(sub, "order", None)
        for c_in, c_out, convs in STEP_SUB[level]:
            label = f"L{level} 3^3 {c_in}->{c_out}"
            shapes.append(("fwd", label, sub.table, order, n, c_in, c_out, convs, None))
            shapes.append(("fused", label, sub.table, order, n, c_in, c_out, convs, sub))
    for i, down in enumerate(downs):
        fine, coarse = down.rev.shape[2], down.table.shape[2]
        order, rev_order = getattr(down, "order", None), getattr(down, "rev_order", None)
        c_in, c_out = STEP_DOWN[i]
        label = f"L{i}->L{i + 1} 2^3 {c_in}->{c_out}"
        shapes.append(("fwd", label, down.table, order, fine, c_in, c_out, 1, None))
        shapes.append(("dgrad", label, down.rev, rev_order, coarse, c_out, c_in, 1, None))
        shapes.append(("wgrad", label, down.table, None, fine, c_in, c_out, 1, None))
        c_in, c_out = STEP_UP[i]
        label = f"L{i + 1}->L{i} 2^3 transposed {c_in}->{c_out}"
        shapes.append(("fwd", label, down.rev, rev_order, coarse, c_in, c_out, 1, None))
        shapes.append(("dgrad", label, down.table, order, fine, c_out, c_in, 1, None))
        shapes.append(("wgrad", label, down.rev, None, coarse, c_in, c_out, 1, None))
    return shapes


def phase_step_shapes(vox):
    """K2, K2-dgrad, K3 and K4 at every call shape of the bf16 MinkUNet18
    train step on the bench pair, each against its plain version, timed,
    with its bound and its launches a step, K3's and K4's dw floats (their
    own counts) against the host model; each map's tile work (K2's own count,
    checked against the host model ``tile_work``) under the index order and
    under its row order, and the order's build time, also for the maps of
    the paths that take no order (the ConvNeXt block's 7^3 self-map, Volt's
    4^3 / 4 pooling map). Returns {kind: [shape results]} and the maps'
    numbers."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )
    from warpconvnet_tpu_torch.ops.kernel_map import row_order

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2)

    def counted(kind, fn):
        """fn()'s result and the count its kernel adds under ``kind``."""
        with device_counts(vox.coords.device) as gained:
            out = fn()
        return out, gained[kind]

    subs, downs = step_maps(vox)
    maps = [(f"L{i} 3^3", m.table, m.order, m.table.shape[2]) for i, m in enumerate(subs)]
    for i, d in enumerate(downs):
        fine, coarse = d.rev.shape[2], d.table.shape[2]
        maps += [(f"L{i}->L{i + 1} 2^3", d.table, d.order, fine),
                 (f"L{i + 1}->L{i} 2^3 (rev)", d.rev, d.rev_order, coarse)]
    map_rows = []
    for label, table, order, n_in in maps:
        x = torch.randn((table.shape[0], n_in, 32), generator=gen, device="cuda").to(dt)
        w = torch.randn((table.shape[1], 32, 32), generator=gen, device="cuda").to(dt)
        pairs = int((table >= 0).sum())
        work = {}
        for name, o in (("index", None), ("row", order)):
            _, work[name] = counted("k2.fwd_tile_work", lambda: ig.implicit_gemm_fwd(x, w, table,
                                                                                  order=o))
            model = ig.tile_work(table, o)[0]
            check(work[name] == model, f"{label}: K2 counted tile work {work[name]} in the "
                  f"{name} order, the model {model}")
        order_ms = cuda_ms(lambda: row_order(table), iters=5)
        map_rows.append(dict(map=label, shape=list(table.shape), pairs=pairs,
                             tile_work_index_order=work["index"] / pairs,
                             tile_work_row_order=work["row"] / pairs, order_ms=order_ms))
        log(f"{label} map {tuple(table.shape)}: {pairs} pairs; K2's tile work / useful pairs "
            f"{work['index'] / pairs:.3f} in the index order, {work['row'] / pairs:.3f} in its "
            f"row order (as the host model counts); row order built in {order_ms:.4f} ms")
    del x, w
    for label, ks, st, cap in (
            (f"{CONVNEXT_K}^3 (ConvNeXt, no order taken)", CONVNEXT_K, 1, None),
            (f"{PATCH}^3 / {PATCH} (Volt pooling, no order taken)", PATCH, PATCH, TOKEN_CAPACITY)):
        table = generate_output_coords_and_kernel_map(vox, ks, st, out_capacity=cap)[2].table
        order_ms = cuda_ms(lambda: row_order(table), iters=5)
        log(f"{label} map {tuple(table.shape)}: a row order would take {order_ms:.4f} ms")
        del table

    names = dict(fwd="K2", dgrad="K2-dgrad", wgrad="K3", fused="K4")
    results = dict(fwd=[], dgrad=[], wgrad=[], fused=[])
    for kind, label, table, order, n_src, c_in, c_out, convs, sub in step_shapes(subs, downs):
        b, k, n_out = table.shape
        pairs = int((table >= 0).sum())
        flops = 2.0 * pairs * c_in * c_out
        if kind == "fused":
            x = torch.randn((b, n_out, c_in), generator=gen, device="cuda").to(dt)
            g = (torch.randn((b, n_out, c_out), generator=gen, device="cuda") / 300).to(dt)
            w = (torch.randn((k, c_in, c_out), generator=gen, device="cuda") / (k * c_in) ** 0.5)
            w = w.to(dt)
            args = (x, g, w, table, sub.offsets)
            with device_counts(x.device) as counts:
                got_dx, got_dw = ig.implicit_gemm_bwd_fused(*args, order=order)
            ref_dx, ref_dw = ig.implicit_gemm_bwd_fused_plain(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got_dx.float(), ref_dx.float(), **K2_TOL[dt])
            err = float((got_dx.float() - ref_dx.float()).abs().max())
            dw_err = rel_err(got_dw, ref_dw)
            check(dw_err <= DW_TOL, f"K4 {label}: dw relative error {dw_err:.3e} > {DW_TOL}")
            ms = cuda_ms(lambda: ig.implicit_gemm_bwd_fused(*args, order=order))
            plain_ms = cuda_ms(lambda: ig.implicit_gemm_bwd_fused_plain(*args), iters=3, warmup=1)
            b_ms, b_by = bound(nbytes(x, g, w, table, got_dx, got_dw), 2 * flops, dt)
            model = ig.bwd_fused_dw_atomics(table, c_in, c_out)
            check(counts["k4.dw_floats"] == model,
                  f"K4 {label}: {counts['k4.dw_floats']} dw floats added, the model {model}")
            extra = dict(dw_rel_err=dw_err, tile_work=counts["k4.tile_work"],
                         dw_atomic_floats=counts["k4.dw_floats"])
            del x, g, w, got_dx, got_dw, ref_dx, ref_dw
        elif kind == "wgrad":  # x [b, n_src, c_in] gathered, g [b, n_out, c_out]
            x = torch.randn((b, n_src, c_in), generator=gen, device="cuda").to(dt)
            g = (torch.randn((b, n_out, c_out), generator=gen, device="cuda") / 300).to(dt)
            fn = lambda: ig.implicit_gemm_wgrad(x, g, table)  # noqa: E731
            got, floats = counted("k3.dw_floats", fn)
            plan = ig.implicit_gemm_wgrad.plan
            ref = ig.implicit_gemm_wgrad_plain(x, g, table)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            dw_err = rel_err(got, ref)
            check(dw_err <= DW_TOL, f"K3 {label}: dw relative error {dw_err:.3e} > {DW_TOL}")
            model = ig.bwd_fused_dw_atomics(table, c_in, c_out, plan["chunk_rows"])
            check(floats == model, f"K3 {label}: {floats} dw floats added, the model {model}")
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(lambda: ig.implicit_gemm_wgrad_plain(x, g, table), iters=3,
                               warmup=1)
            b_ms, b_by = bound(wgrad_nbytes(x, g, table, got), flops, dt)
            extra = dict(dw_rel_err=dw_err, dw_atomic_floats=floats, **plan)
            del x, g, got, ref
        else:
            x = torch.randn((b, n_src, c_in), generator=gen, device="cuda").to(dt)
            w = (torch.randn((k, c_in, c_out), generator=gen, device="cuda") / (k * c_in) ** 0.5)
            w = w.to(dt)
            if kind == "fwd":
                fn = lambda: ig.implicit_gemm_fwd(x, w, table, order=order)  # noqa: E731
                plain = lambda: ig.implicit_gemm_fwd_plain(x, w, table)  # noqa: E731
            else:  # the dgrad of a conv whose weight is w^T [k, c_out, c_in]
                wd = w.transpose(1, 2).contiguous()
                fn = lambda: ig.implicit_gemm_dgrad(x, wd, table, order=order)  # noqa: E731
                plain = lambda: ig.implicit_gemm_dgrad_plain(x, wd, table)  # noqa: E731
            got, work = counted(f"k2.{kind}_tile_work", fn)
            ref = plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref.float(), **K2_TOL[dt])
            err = float((got.float() - ref.float()).abs().max())
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            b_ms, b_by = bound(nbytes(x, w, table, got), flops, dt)
            extra = dict(tile_work=work)
            del x, w, got, ref
        results[kind].append(dict(shape=label, k=k, rows=n_out, pairs=pairs,
                                  launches_per_step=convs, max_abs_err=err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **extra))
        log(f"{names[kind]} {label} ({convs} a step, {pairs} pairs): max_abs_err {err:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
            + (f"; tile work {extra['tile_work']}" if "tile_work" in extra else "")
            + (f"; dw rel err {extra['dw_rel_err']:.3e}, {extra['dw_atomic_floats']} dw floats "
               "added with atomics" if "dw_rel_err" in extra else "")
            + (f" from {extra['dw_blocks']} blocks of {extra['chunk_rows']} rows"
               if kind == "wgrad" else ""))
    for kind, rows in results.items():
        total = sum(r["ms"] * r["launches_per_step"] for r in rows)
        bound_total = sum(r["bound_ms"] * r["launches_per_step"] for r in rows)
        launches = sum(r["launches_per_step"] for r in rows)
        log(f"{names[kind]} over a MinkUNet18 step's shapes: {launches} launches, {total:.4f} ms "
            f"by the shapes' times, bound {bound_total:.4f} ms; card {card_name()}")
    return results, map_rows


def depth_entry(key, label, shape, err, ms, plain_ms, bound_pair):
    # wrapper name, line of the TPU kernel in warpconvnet_tpu/kernels/depthwise_fma.py
    name, line = {
        "dfwd": ("depthwise_fma_fwd", 152),
        "ddgrad": ("depthwise_fma_dgrad", 152),
        "dwgrad": ("depthwise_fma_wgrad", 261),
        "dfused": ("depthwise_fma_bwd_fused", 367),
    }[key]
    return dict(
        name=name, route="cuda", source="warpconvnet_tpu_torch/csrc/depthwise_fma.cu",
        replaces=f"warpconvnet_tpu/kernels/depthwise_fma.py:{line}", shape=f"{shape} ({label})",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_pair[0],
        bound_by=bound_pair[1], library_ms=None,
    )


def phase_depthwise(vox, table3):
    """K6 (forward, and dgrad through rev), K7 and K8 against their plain
    versions at the depthwise path's shapes; returns the JSON entries."""
    from warpconvnet_tpu_torch.kernels import depthwise_fma as dw
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets

    gen = torch.Generator(device="cuda").manual_seed(2)
    mask = vox.valid_mask()[..., None]
    n0 = vox.max_num_points
    c = CONVNEXT_C

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    _, _, sub7, _ = generate_output_coords_and_kernel_map(vox, CONVNEXT_K)
    table7 = sub7.table
    pairs7, pairs3 = int((table7 >= 0).sum()), int((table3 >= 0).sum())
    log(f"{CONVNEXT_K}^3 self-map: table {tuple(table7.shape)} int32, "
        f"{table7.numel() * 4 / 1e6:.1f} MB, {pairs7} pairs ({pairs7 / table7.numel():.2%} "
        f"of the slots valid); L0 3^3: {pairs3} pairs")
    _, _, down, _ = generate_output_coords_and_kernel_map(
        vox, 2, stride=2, out_capacity=N_CAP // 2
    )
    n1 = down.table.shape[2]
    entries = {}

    # K6 forward: the 7^3 map (path A), the L0 3^3 map at C 96 and 384.
    for label, table, pairs, cc, dtypes in (
        (f"{CONVNEXT_K}^3 self-map", table7, pairs7, c, (torch.bfloat16, torch.float32)),
        ("L0 3^3 map", table3, pairs3, c, (torch.bfloat16, torch.float32)),
        ("L0 3^3 map", table3, pairs3, VOLT_S_C, (torch.bfloat16,)),
    ):
        k = table.shape[1]
        for dtype in dtypes:
            x = rand((B, n0, cc), dtype) * mask
            w = rand((k, cc), torch.float32, k ** -0.5)
            got = dw.depthwise_fma_fwd(x, w, table)
            ref = dw.depthwise_fma_fwd_plain(x, w, table)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref.float(), **K2_TOL[dtype])
            err = float((got.float() - ref.float()).abs().max())
            ms = cuda_ms(lambda: dw.depthwise_fma_fwd(x, w, table))
            plain_ms = cuda_ms(lambda: dw.depthwise_fma_fwd_plain(x, w, table), iters=3, warmup=1)
            bd = bound(nbytes(x, w, table, got), 2.0 * pairs * cc, dtype)
            tag = f"C {cc} {str(dtype)[6:]}"
            log(f"K6 {label} {tag}: max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
            if k == CONVNEXT_K ** 3 and dtype == torch.bfloat16:
                entries["dfwd"] = depth_entry("dfwd", label, f"B={B} K={k} N={n0} {tag}",
                                              err, ms, plain_ms, bd)

    # K6 as dgrad and K7 on the L0 -> L1 parity map (path B) and its reverse.
    pairs2 = int((down.table >= 0).sum())
    rev = down.rev.contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        x = rand((B, n0, c), dtype) * mask
        g = rand((B, n1, c), dtype)
        w = rand((8, c), torch.float32, 8 ** -0.5)
        dx = dw.depthwise_fma_dgrad(g, w, rev)
        with device_counts(x.device) as gained:
            dwt = dw.depthwise_fma_wgrad(x, g, down.table)
        adds, plan = gained["k7.dw_floats"], dw.depthwise_fma_wgrad.plan
        ref_dx = dw.depthwise_fma_dgrad_plain(g, w, rev)
        ref_dw = dw.depthwise_fma_wgrad_plain(x, g, down.table)
        torch.cuda.synchronize()
        torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dtype])
        w_err = rel_err(dwt, ref_dw)
        check(w_err <= DW_TOL, f"K7 dw relative error {w_err:.3e} > {DW_TOL}")
        model = dw.bwd_fused_dw_adds(down.table, c, plan["chunk_rows"])
        check(adds == model, f"K7: {adds} floats added into dw, host model {model}")
        dx_err = float((dx.float() - ref_dx.float()).abs().max())
        w_abs = float((dwt - ref_dw).abs().max())
        t = dict(
            dgrad=cuda_ms(lambda: dw.depthwise_fma_dgrad(g, w, rev)),
            dgrad_plain=cuda_ms(lambda: dw.depthwise_fma_dgrad_plain(g, w, rev)),
            wgrad=cuda_ms(lambda: dw.depthwise_fma_wgrad(x, g, down.table)),
            wgrad_plain=cuda_ms(lambda: dw.depthwise_fma_wgrad_plain(x, g, down.table)),
        )
        bd_d = bound(nbytes(g, w, rev, dx), 2.0 * pairs2 * c, dtype)
        bd_w = bound(wgrad_nbytes(x, g, down.table, dwt), 2.0 * pairs2 * c, dtype)
        tag = f"C {c} {str(dtype)[6:]}"
        log(f"L0->L1 2^3 parity map {tag} ({pairs2} pairs): K6-dgrad max_abs_err {dx_err:.3e}, "
            f"{t['dgrad']:.4f} ms, plain {t['dgrad_plain']:.4f} ms, bound {bd_d[0]:.4f} ms; "
            f"K7 rel err {w_err:.3e} (max_abs {w_abs:.3e}), {t['wgrad']:.4f} ms, plain "
            f"{t['wgrad_plain']:.4f} ms, bound {bd_w[0]:.4f} ms; K7 adds {adds} floats into dw "
            f"(host model {model}) from {plan['dw_blocks']} blocks of {plan['chunk_rows']} rows")
        if dtype == torch.bfloat16:
            shape = f"B={B} K=8 N_in={n0} N_out={n1} {tag}"
            entries["ddgrad"] = depth_entry("ddgrad", "L0->L1 2^3 parity map, through rev",
                                            shape, dx_err, t["dgrad"], t["dgrad_plain"], bd_d)
            entries["dwgrad"] = depth_entry("dwgrad", "L0->L1 2^3 parity map", shape, w_abs,
                                            t["wgrad"], t["wgrad_plain"], bd_w)
            entries["dwgrad"].update(dw_floats=adds, chunk_rows=plan["chunk_rows"])

    # K8 on the 7^3 (path A) and 3^3 self-maps, and the split pair it saves.
    for label, table, rev_t, pairs, dtypes in (
        (f"{CONVNEXT_K}^3 self-map", table7, sub7.rev, pairs7, (torch.bfloat16,)),
        ("L0 3^3 self-map", table3, None, pairs3, (torch.bfloat16, torch.float32)),
    ):
        k = table.shape[1]
        offsets = kernel_offsets(round(k ** (1 / 3)))
        rev_t = table.flip(1).contiguous() if rev_t is None else rev_t
        for dtype in dtypes:
            x = rand((B, n0, c), dtype) * mask
            g = rand((B, n0, c), dtype) * mask
            w = rand((k, c), torch.float32, k ** -0.5)
            with device_counts(x.device) as gained:
                dx, dwt = dw.depthwise_fma_bwd_fused(x, g, w, table, offsets)
            adds = gained["k8.dw_floats"]
            plan = dw.depthwise_fma_bwd_fused.plan
            model = dw.bwd_fused_dw_adds(table, c, plan["chunk_rows"])
            ref_dx, ref_dw = dw.depthwise_fma_bwd_fused_plain(x, g, w, table, offsets)
            k6_dx = dw.depthwise_fma_fwd(g, w.flip(0).contiguous(), table)
            torch.cuda.synchronize()
            torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dtype])
            w_err = rel_err(dwt, ref_dw)
            check(w_err <= DW_TOL, f"K8 dw relative error {w_err:.3e} > {DW_TOL}")
            check(adds == model, f"K8 {label}: {adds} floats added into dw, host model {model}")
            check(torch.equal(dx, k6_dx), f"K8 {label}: dx differs from K6 on (g, w flipped)")
            dx_err = float((dx.float() - ref_dx.float()).abs().max())
            ms = cuda_ms(lambda: dw.depthwise_fma_bwd_fused(x, g, w, table, offsets))
            plain_ms = cuda_ms(lambda: dw.depthwise_fma_bwd_fused_plain(x, g, w, table, offsets),
                               iters=3, warmup=1)
            pair_ms = cuda_ms(lambda: (dw.depthwise_fma_dgrad(g, w, rev_t),
                                       dw.depthwise_fma_wgrad(x, g, table)))
            bd = bound(nbytes(x, g, w, table, dx, dwt), 4.0 * pairs * c, dtype)
            tag = f"C {c} {str(dtype)[6:]}"
            log(f"K8 {label} {tag}: dx max_abs_err {dx_err:.3e} (the bits of K6 on (g, w "
                f"flipped)), dw rel err {w_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, K6-dgrad + K7 pair {pair_ms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}); dw "
                f"adds {adds} floats ({adds / 4:.0f} float4; host model {model}) from "
                f"{plan['dw_blocks']} dw blocks of {plan['chunk_rows']} rows")
            if k == CONVNEXT_K ** 3:
                entries["dfused"] = depth_entry("dfused", label, f"B={B} K={k} N={n0} {tag}",
                                                dx_err, ms, plain_ms, bd)
                entries["dfused"].update(pair_ms=pair_ms, dw_floats=adds)
    return entries


def convnext_run(block, vox, train: bool):
    """One fwd+bwd of sum(out^2) (``train``) or one inference forward:
    (output features, input grad or None, ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    block.zero_grad(set_to_none=True)
    start.record()
    if train:
        x = vox.features.detach().requires_grad_(True)
        out = block(vox.replace(features=x))
        (out.features.float() ** 2).sum().backward()
        grad = x.grad
    else:
        with torch.inference_mode():
            out = block(vox)
        grad = None
    end.record()
    torch.cuda.synchronize()
    return out.features.detach(), grad, start.elapsed_time(end)


def check_launches(label, want, before=None):
    """Every kernel's launches since ``before`` (default: since the last
    reset) must equal ``want`` (absent keys: 0). Returns the counts."""
    got = all_counts(tuple(wrappers()))
    delta = {key: n - (before or {}).get(key, 0) for key, n in got.items()}
    want = {key: want.get(key, 0) for key in got}
    check(delta == want, f"{label}: launches {delta}, want {want}")
    return got


def compare_grads(label, got, ref, tol):
    """Relative Frobenius error of each tensor (outputs and gradients),
    kernel path against plain path; returns the largest."""
    worst = 0.0
    for name in ref:
        check(bool(torch.isfinite(got[name]).all()), f"{label}: {name} not finite")
        err = rel_err(got[name], ref[name])
        check(err <= tol, f"{label}: {name} relative error {err:.3e} > {tol}")
        worst = max(worst, err)
    return worst


def block_results(block, out, dx):
    res = {"output": out, "input grad": dx}
    res.update({n: p.grad.detach().clone() for n, p in block.named_parameters()})
    return res


def phase_convnext(device):
    """Path A: SparseConvNeXtBlock(96, kernel 7) fwd+bwd and inference on
    the bench scene pair; returns the launches of each run kind."""
    from warpconvnet_tpu_torch.nn.modules.blocks import SparseConvNeXtBlock

    def make_block(layer_scale):
        return SparseConvNeXtBlock(CONVNEXT_C, CONVNEXT_K, layer_scale_init=layer_scale,
                                   device=device, generator=torch.Generator().manual_seed(0))

    # Tight check first: fp32 at n_cap 4096, a layer scale of 0.5 so the MLP
    # branch's gradients count.
    small = make_batch(300, 4096, device, channels=CONVNEXT_C, scale=0.1).lex_sort()
    block = make_block(0.5)
    out, dx, _ = convnext_run(block, small, train=True)
    got = block_results(block, out, dx)
    with plain_kernels():
        out, dx, _ = convnext_run(block, small, train=True)
    worst = compare_grads("convnext fp32 (n_cap 4096)", got, block_results(block, out, dx),
                          DEPTH_TOL[torch.float32])
    log(f"convnext fp32 (n_cap 4096): output and gradients vs plain, worst rel err {worst:.3e}")

    block = make_block(1e-6)  # the block's own init, as a user would run it
    vox = make_batch(301, N_CAP, device, channels=CONVNEXT_C, scale=0.1).lex_sort()
    vox = vox.replace(features=vox.features.to(torch.bfloat16))
    voxels = int(vox.num_valid.sum())
    torch.cuda.reset_peak_memory_stats()
    train_ms, infer_ms, launches = [], [], {}
    reset_counts()
    for i in range(CONVNEXT_REPEATS):
        before = all_counts(tuple(wrappers()))
        out, dx, ms = convnext_run(block, vox, train=True)
        check_launches(f"convnext fwd+bwd {i}", dict(k1=1, dfwd=1, dfused=1), before)
        train_ms.append(ms)
    launches[f"SparseConvNeXtBlock fwd+bwd ({CONVNEXT_REPEATS} runs)"] = all_counts(
        tuple(wrappers()))
    got = block_results(block, out, dx)
    check(out.dtype == torch.float32 and tuple(out.shape) == (B, N_CAP, CONVNEXT_C),
          f"convnext output {out.dtype} {tuple(out.shape)}")
    check(bool((out[~vox.valid_mask()] == 0).all()), "convnext: pad rows not zero")
    reset_counts()
    for i in range(CONVNEXT_REPEATS):
        before = all_counts(tuple(wrappers()))
        inf, _, ms = convnext_run(block, vox, train=False)
        check_launches(f"convnext inference {i}", dict(k1=1, dfwd=1), before)
        infer_ms.append(ms)
    launches[f"SparseConvNeXtBlock inference ({CONVNEXT_REPEATS} runs)"] = all_counts(
        tuple(wrappers()))
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(inf, out), "convnext: inference output differs from the train forward's")
    reset_counts()
    with plain_kernels():
        p_out, p_dx, p_ms = convnext_run(block, vox, train=True)
    check_launches("convnext plain path", {})
    worst = compare_grads("convnext bf16 (bench scale)", got, block_results(block, p_out, p_dx),
                          DEPTH_TOL[torch.bfloat16])
    steady = train_ms[1:]
    vps = voxels * len(steady) / (sum(steady) / 1e3)
    log(f"convnext bf16 C {CONVNEXT_C} k {CONVNEXT_K}^3, {voxels} voxels: fwd+bwd ms "
        f"{[round(t, 3) for t in train_ms]} (plain path {p_ms:.3f}), inference fwd ms "
        f"{[round(t, 3) for t in infer_ms]}; {vps:.1f} voxels/s fwd+bwd (runs 2-"
        f"{CONVNEXT_REPEATS}); peak memory {peak / 2**30:.3f} GiB; worst rel err vs plain "
        f"{worst:.3e} over the output and {len(got) - 1} gradients")
    return launches


def phase_strided_grouped(device):
    """Path B: a 2^3 stride-2 depthwise conv fwd+bwd; path C: a 3^3 groups=2
    conv fwd+bwd; each against the plain route. Returns their launches."""
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseConv3d, SparseDepthwiseConv3d

    vox = make_batch(302, N_CAP, device, channels=CONVNEXT_C, scale=0.1).lex_sort()
    vox = vox.replace(features=vox.features.to(torch.bfloat16))
    gen = torch.Generator().manual_seed(0)
    paths = (
        ("strided depthwise fwd+bwd",
         SparseDepthwiseConv3d(CONVNEXT_C, 2, stride=2, device=device, generator=gen),
         dict(out_capacity=N_CAP // 2), dict(dfwd=1, ddgrad=1, dwgrad=1)),
        ("grouped fwd+bwd",
         SparseConv3d(CONVNEXT_C, CONVNEXT_C, 3, groups=2, device=device, generator=gen),
         {}, dict(k1=1, fwd=1, fused=1)),
    )
    launches = {}
    constants.set_compute_dtype(torch.bfloat16)
    try:
        for label, conv, kw, want in paths:
            results = []
            for plain in (False, True):
                x = vox.features.detach().requires_grad_(True)
                conv.zero_grad(set_to_none=True)
                reset_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with plain_kernels() if plain else nullcontext():
                    start.record()
                    out, _ = conv(vox.replace(features=x), **kw)
                    (out.features.float() ** 2).sum().backward()
                    end.record()
                    torch.cuda.synchronize()
                if plain:
                    check_launches(f"{label} plain path", {})
                else:
                    launches[label] = check_launches(label, want)
                res = {"output": out.features.detach(), "input grad": x.grad}
                res.update({n: p.grad.detach().clone() for n, p in conv.named_parameters()})
                results.append((res, start.elapsed_time(end)))
            worst = compare_grads(label, results[0][0], results[1][0], DEPTH_TOL[torch.bfloat16])
            log(f"{label} bf16 C {CONVNEXT_C}: kernel path {results[0][1]:.3f} ms, plain path "
                f"{results[1][1]:.3f} ms, worst rel err vs plain {worst:.3e}; launches "
                f"{ {k: v for k, v in launches[label].items() if v} }")
    finally:
        constants.set_compute_dtype(None)
    return launches


def token_counts(vox):
    """Tokens of each scene at patch size PATCH: distinct coords // PATCH
    over its valid rows (torch.unique, independent of the port's maps)."""
    return [int(torch.unique(torch.div(vox.coords[b, : int(vox.num_valid[b])], PATCH,
                                       rounding_mode="floor"), dim=0).shape[0])
            for b in range(vox.batch_size)]


def equal_segment_pairs(seg_q, seg_kv):
    """(query, kv) row pairs with equal segments, summed over scenes: the
    pairs whose products the function needs, pad sentinel included."""
    total = 0
    for b in range(seg_q.shape[0]):
        uq, cq = torch.unique(seg_q[b], return_counts=True)
        uk, ck = torch.unique(seg_kv[b], return_counts=True)
        kv = dict(zip(uk.tolist(), ck.tolist()))
        total += sum(c * kv.get(u, 0) for u, c in zip(uq.tolist(), cq.tolist()))
    return total


def sdpa_ms(q, k, v, nq, nkv):
    """One scaled_dot_product_attention per scene on its valid rows (no
    mask): the library call for global attention over a ragged batch."""
    from torch.nn import functional as F

    def run():
        for b in range(q.shape[0]):
            F.scaled_dot_product_attention(q[b:b + 1, : nq[b]].transpose(1, 2),
                                           k[b:b + 1, : nkv[b]].transpose(1, 2),
                                           v[b:b + 1, : nkv[b]].transpose(1, 2))
    return cuda_ms(run, iters=3, warmup=1)


def k9_fp64_errors(k9, q, k, v, seg_q, seg_kv):
    """Relative Frobenius errors of fp32 K9's out and lse (rows that match
    something) and of the fp32 plain forward's against a float64 plain
    forward of the same inputs."""
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    plain = k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv, return_lse=True)
    o64, lse64 = k9.segment_attention_fwd_plain(q.double(), k.double(), v.double(), seg_q,
                                                seg_kv, chunk=512, return_lse=True)
    finite = torch.isfinite(lse64)
    check(torch.equal(torch.isfinite(lse), finite), "K9: lse +inf on other rows than float64's")

    def rel(x, r):
        return float((x.double() - r).norm() / r.norm())

    return dict(out=rel(out, o64), lse=rel(lse[finite], lse64[finite]),
                plain_out=rel(plain[0], o64), plain_lse=rel(plain[1][finite], lse64[finite]))


def k9_split_reuse(k9, q, k, v, seg_q, seg_kv):
    """One fp32 K9 call's scratch bytes, the kv rows it split and its
    blocks copied in (``tracing`` ``k9.fwd_split_rows``,
    ``k9.fwd_staged_rows``) and their ratio, the reuse of each split;
    checks that each kv row of each head was split once."""
    from warpconvnet_tpu_torch import tracing
    from warpconvnet_tpu_torch.kernels import _build

    b, skv, h, d = k.shape
    rows0 = tracing.counters().get("k9.fwd_split_rows", 0)
    with device_counts("cuda") as gained:
        k9.segment_attention_fwd(q, k, v, seg_q, seg_kv)
    rows = tracing.counters()["k9.fwd_split_rows"] - rows0
    check(rows == b * h * skv, f"K9: split {rows} kv rows, not B H Skv = {b * h * skv}")
    staged = gained["k9.fwd_staged_rows"]
    return dict(scratch_bytes=k9.split_scratch(_build.load_library(), b, skv, h, d)[1],
                split_rows=rows, staged_rows=staged, split_reuse=staged / rows)


def phase_k9(tokens):
    """K9 against its plain version at Volt-s's trunk shape (validity from
    the real token counts ``tokens``), fp32 and bf16, and on a grouped
    layout, cross attention and D 16. Returns the JSON entry."""
    from warpconvnet_tpu_torch.kernels import segment_attention as k9
    from warpconvnet_tpu_torch.nn.functional.flash_attention import (
        segment_ids_from_groups,
        segment_ids_from_valid,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    s, d = TOKEN_CAPACITY, VOLT_S_C // VOLT_HEADS
    rows = torch.arange(s, device="cuda")[None, :]
    valid = rows < torch.as_tensor(tokens, device="cuda")[:, None]
    cross_q = [min(t, 4096) - 96 * (i + 1) for i, t in enumerate(tokens)]
    cases = (  # name, heads, D, Sq, seg_q, seg_kv, valid rows (q, kv) for the library
        ("global", VOLT_HEADS, d, s, segment_ids_from_valid(valid), None, (tokens, tokens)),
        ("grouped 1024", VOLT_HEADS, d, s, segment_ids_from_groups(rows // 1024, valid), None,
         None),
        ("cross Sq 4096", VOLT_HEADS, d, 4096,
         segment_ids_from_valid(rows[:, :4096] < torch.as_tensor(cross_q, device="cuda")[:, None]),
         segment_ids_from_valid(valid), (cross_q, tokens)),
        ("global D 16", 4, 16, s, segment_ids_from_valid(valid), None, (tokens, tokens)),
    )
    entry = None
    for name, h, dd, sq, seg_q, seg_kv, lib_rows in cases:
        seg_kv = seg_q if seg_kv is None else seg_kv
        pairs = equal_segment_pairs(seg_q, seg_kv)
        q32 = torch.randn((B, sq, h, dd), generator=gen, device="cuda") * 2.5
        k32 = torch.randn((B, s, h, dd), generator=gen, device="cuda")
        v32 = torch.randn((B, s, h, dd), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            visited, tiles = k9.kv_tiles_visited(seg_q, seg_kv, k9.query_tile(dtype, dd))
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            got = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv)
            ref = k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == ref.shape, f"K9 {name}: {got.dtype} {got.shape}")
            err = rel_err(got, ref)
            max_abs = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            tol = K9_TOL[dtype]
            check(bool(torch.isfinite(got).all()), f"K9 {name}: non-finite output")
            check(err <= tol and max_abs <= tol * scale,
                  f"K9 {name} {str(dtype)[6:]}: relative error {err:.3e}, max abs {max_abs:.3e} "
                  f"(largest {scale:.3e}) > {tol}")
            fp64 = None
            if name == "global" and dtype == torch.float32:
                fp64 = k9_fp64_errors(k9, q, k, v, seg_q, seg_kv)
                log(f"K9 {name} fp32 against float64: out {fp64['out']:.3e}, lse "
                    f"{fp64['lse']:.3e} (fp32 plain {fp64['plain_out']:.3e}, "
                    f"{fp64['plain_lse']:.3e}; bounds {K9_FP64_TOL})")
                check(all(fp64[key] <= bound for key, bound in K9_FP64_TOL.items()),
                      f"K9 {name} fp32: {fp64} against float64, bounds {K9_FP64_TOL}")
            split = k9_split_reuse(k9, q, k, v, seg_q, seg_kv) if dtype == torch.float32 else None
            fast = dtype == torch.bfloat16 or dd == 16 or name != "global"
            ms = cuda_ms(lambda: k9.segment_attention_fwd(q, k, v, seg_q, seg_kv),
                         iters=10 if fast else 3, warmup=1)
            plain_ms = cuda_ms(lambda: k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv),
                               iters=2, warmup=1)
            lib_ms = None if lib_rows is None else sdpa_ms(q, k, v, *lib_rows)
            flops = 4.0 * pairs * dd * h
            bd = bound(nbytes(q, k, v, seg_q, seg_kv, got), flops, dtype)
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            log(f"K9 {name} [B={B}, Sq={sq}, Skv={s}, H={h}, D={dd}] {str(dtype)[6:]}: rel err "
                f"{err:.3e}, max_abs_err {max_abs:.3e}; kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.2f} TFLOP/s on {pairs} equal-segment pairs), plain "
                f"{plain_ms:.4f} ms, sdpa {lib_txt}, bound {bd[0]:.4f} ms ({bd[1]}); kv tiles "
                f"visited {visited}/{tiles} ({visited / tiles:.2%}); split {split}; card "
                f"{card_state()}")
            if name == "global":
                res = dict(max_abs_err=max_abs, rel_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bd[0], bound_by=bd[1], library_ms=lib_ms,
                           kv_tiles_visited=visited / tiles, **(split or {}))
                if dtype == torch.float32:
                    entry = dict(
                        name="segment_attention_fwd", route="cuda",
                        source="warpconvnet_tpu_torch/csrc/segment_attention_fwd_tf32.cu",
                        replaces="warpconvnet_tpu/nn/functional/flash_attention.py:147",
                        shape=f"B={B} S={s} H={h} D={dd} fp32, validity {tokens} "
                              "(Volt-s trunk; the main path's dtype)",
                        rel_err_fp64=fp64, **res)
                    # One fp32 peak in every bound_ms: the tensor cores' 3xTF32
                    # rate, as for K9-dkv / K9-dq; the FMA bound beside it.
                    bd = bound(nbytes(q, k, v, seg_q, seg_kv, got), flops, peak=TF32X3_FLOPS)
                    entry.update(bound_ms=bd[0], bound_by=bd[1], fma_bound_ms=res["bound_ms"])
                else:
                    entry["bf16"] = dict(
                        res, source="warpconvnet_tpu_torch/csrc/segment_attention_fwd_bf16.cu")
    return entry


def sdpa_bwd_ms(q, k, v, do, nq, nkv):
    """The backward (dq, dk, dv) of one scaled_dot_product_attention per
    scene on its valid rows, under autograd: the library yardstick for
    K9-dkv + K9-dq. The forwards run once, outside the timing."""
    from torch.nn import functional as F

    leaves, outs, grads = [], [], []
    for b in range(q.shape[0]):
        qb, kb, vb = (t[b:b + 1, :n].transpose(1, 2).contiguous().requires_grad_(True)
                      for t, n in ((q, nq[b]), (k, nkv[b]), (v, nkv[b])))
        outs.append(F.scaled_dot_product_attention(qb, kb, vb))
        grads.append(do[b:b + 1, : nq[b]].transpose(1, 2).contiguous())
        leaves += [qb, kb, vb]
    return cuda_ms(lambda: torch.autograd.grad(outs, leaves, grads, retain_graph=True),
                   iters=3, warmup=1)


def phase_k9_bwd(tokens):
    """K9-dkv and K9-dq against the plain backward at Volt-s's trunk shape
    (validity from the real token counts ``tokens``), fp32 and bf16, and on
    a grouped layout, cross attention, a grouped layout with unmatched
    query rows and D 16 grouped. Returns the JSON entries (keys "dkv",
    "dq"), the bf16 kernels' nested under "bf16"."""
    from warpconvnet_tpu_torch.kernels import segment_attention as k9
    from warpconvnet_tpu_torch.nn.functional.flash_attention import (
        segment_ids_from_groups,
        segment_ids_from_valid,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    s, dh = TOKEN_CAPACITY, VOLT_S_C // VOLT_HEADS
    rows = torch.arange(s, device="cuda")[None, :]
    valid = rows < torch.as_tensor(tokens, device="cuda")[:, None]
    cross_q = [min(t, 4096) - 96 * (i + 1) for i, t in enumerate(tokens)]
    grouped = segment_ids_from_groups(rows // 1024, valid)
    unmatched = torch.where(rows % 7 == 0, 1_000_000, grouped).to(torch.int32)
    cases = (  # name, heads, D, Sq, seg_q, seg_kv, valid rows (q, kv) for the library
        ("global", VOLT_HEADS, dh, s, segment_ids_from_valid(valid), None, (tokens, tokens)),
        ("grouped 1024", VOLT_HEADS, dh, s, grouped, None, None),
        ("cross Sq 4096", VOLT_HEADS, dh, 4096,
         segment_ids_from_valid(rows[:, :4096] < torch.as_tensor(cross_q, device="cuda")[:, None]),
         segment_ids_from_valid(valid), (cross_q, tokens)),
        ("grouped 1024, every 7th query row unmatched", VOLT_HEADS, dh, s, unmatched, grouped,
         None),
        # PTv3's patch attention: 1024-row patches, 16-wide heads.
        ("grouped 1024 D 16", 4, 16, s, grouped, None, None),
    )
    entries = {}
    for name, h, d, sq, seg_q, seg_kv, lib_rows in cases:
        seg_kv = seg_q if seg_kv is None else seg_kv
        pairs = equal_segment_pairs(seg_q, seg_kv)
        q32 = torch.randn((B, sq, h, d), generator=gen, device="cuda") * 2.5
        k32 = torch.randn((B, s, h, d), generator=gen, device="cuda")
        v32 = torch.randn((B, s, h, d), generator=gen, device="cuda")
        # The caller (Attention) zeroes pad outputs, so dO is zero there.
        do32 = torch.randn((B, sq, h, d), generator=gen, device="cuda") * (
            seg_q != 2_000_000_000)[..., None, None]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
            out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
            di = k9.rowsum_o_do(out, do)
            args = (q, k, v, do, lse, di, seg_q, seg_kv)
            dk, dv = k9.segment_attention_bwd_dkv(*args)
            dq = k9.segment_attention_bwd_dq(*args)
            ref = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg_q, seg_kv)
            torch.cuda.synchronize()
            errs, max_abs = [], []
            for label, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                check(g.dtype == dtype and g.shape == r.shape, f"K9-bwd {name}: {label} {g.dtype}")
                check(bool(torch.isfinite(g).all()), f"K9-bwd {name}: non-finite {label}")
                errs.append(rel_err(g, r))
                max_abs.append(float((g.float() - r.float()).abs().max()))
                check(errs[-1] <= K9_BWD_TOL[dtype], f"K9-bwd {name} {str(dtype)[6:]}: {label} "
                      f"relative error {errs[-1]:.3e} > {K9_BWD_TOL[dtype]}")
            empty = ~torch.isfinite(lse[:, 0])
            check(bool((dq[empty] == 0).all()), f"K9-bwd {name}: unmatched rows' dq not zero")
            check(not name.endswith("unmatched") or bool(empty.any()),
                  f"K9-bwd {name}: no query row with lse +inf")
            heavy = name in ("global", "cross Sq 4096") and dtype == torch.float32
            dkv_ms = cuda_ms(lambda: k9.segment_attention_bwd_dkv(*args), iters=2 if heavy else 5,
                             warmup=1)
            dq_ms = cuda_ms(lambda: k9.segment_attention_bwd_dq(*args), iters=2 if heavy else 5,
                            warmup=1)
            plain_ms = None
            if name == "global":
                plain_ms = cuda_ms(lambda: k9.segment_attention_bwd_plain(
                    q, k, v, out, lse, do, seg_q, seg_kv), iters=1, warmup=1)
            lib_ms = None if lib_rows is None else sdpa_bwd_ms(q, k, v, do, *lib_rows)
            inputs = nbytes(q, k, v, do, lse, di, seg_q, seg_kv)
            # fp32 runs 3xTF32 on the tensor cores: its bound is at that
            # rate; the CUDA cores' FMA bound is kept beside it.
            peak = TF32X3_FLOPS if dtype == torch.float32 else None
            dkv_bd = bound(inputs + nbytes(dk, dv), 8.0 * pairs * d * h, dtype, peak)
            dq_bd = bound(inputs + nbytes(dq), 6.0 * pairs * d * h, dtype, peak)
            fn_bd = bound(inputs + nbytes(dq, dk, dv), 10.0 * pairs * d * h, dtype, peak)
            fma_bd = [bound(inputs + nbytes(*outs), f * pairs * d * h)[0] if peak else None
                      for outs, f in (((dk, dv), 8.0), ((dq,), 6.0))]
            fma_txt = f"; FMA bounds {fma_bd[0]:.4f}, {fma_bd[1]:.4f}" if peak else ""
            tflops = 14.0 * pairs * d * h / (dkv_ms + dq_ms) / 1e9
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
            log(f"K9-bwd {name} [B={B}, Sq={sq}, Skv={s}, H={h}, D={d}] {str(dtype)[6:]}: rel err "
                f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (max_abs "
                f"{max(max_abs):.3e}); K9-dkv {dkv_ms:.4f} ms (bound {dkv_bd[0]:.4f}), K9-dq "
                f"{dq_ms:.4f} ms (bound {dq_bd[0]:.4f}{fma_txt}); both {dkv_ms + dq_ms:.4f} ms "
                f"({tflops:.2f} TFLOP/s of the kernels' 14 D a pair on {pairs} equal-segment "
                f"pairs), function bound {fn_bd[0]:.4f} ms ({fn_bd[1]}, 10 D a pair); plain "
                f"{plain_txt}, sdpa backward {lib_txt}; {int(empty.sum())} unmatched query "
                f"rows; card {card_state()}")
            if name != "global":
                continue
            common = dict(
                route="cuda", source=("warpconvnet_tpu_torch/csrc/segment_attention_bwd_tf32.cu"
                                      if dtype == torch.float32 else
                                      "warpconvnet_tpu_torch/csrc/segment_attention_bwd_bf16.cu"),
                shape=f"B={B} S={s} H={h} D={d} fp32, validity {tokens} (Volt-s trunk; the main "
                      "path's dtype)",
                plain_ms=plain_ms, library_ms=lib_ms, function_bound_ms=fn_bd[0],
                note="plain_ms: one pass of the plain backward (dq, dk and dv); library_ms: "
                     "the SDPA backward (dq, dk and dv), per scene on its valid rows")
            res = dict(dkv=dict(max_abs_err=max(max_abs[1:]), rel_err=max(errs[1:]), ms=dkv_ms,
                                bound_ms=dkv_bd[0], bound_by=dkv_bd[1]),
                       dq=dict(max_abs_err=max_abs[0], rel_err=errs[0], ms=dq_ms,
                               bound_ms=dq_bd[0], bound_by=dq_bd[1]))
            if dtype == torch.float32:
                res["dkv"]["fma_bound_ms"], res["dq"]["fma_bound_ms"] = fma_bd
                entries["dkv"] = dict(
                    name="segment_attention_bwd_dkv",
                    replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:796",
                    **common, **res["dkv"])
                entries["dq"] = dict(
                    name="segment_attention_bwd_dq",
                    replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
                    **common, **res["dq"])
            else:
                for key in ("dkv", "dq"):
                    entries[key]["bf16"] = dict(
                        res[key], source=common["source"], plain_ms=plain_ms, library_ms=lib_ms,
                        tflops=(8.0 if key == "dkv" else 6.0) * pairs * d * h / res[key]["ms"] / 1e9,
                        library_factor=(dkv_ms + dq_ms) / lib_ms)
    return entries


def volt_forward(model, vox):
    """(logits, forward ms by CUDA events, the tokenizer's num_valid):
    ``sparse_reduce`` is wrapped to read the token counts the model saw."""
    from warpconvnet_tpu_torch.models import volt as volt_module

    seen = []

    def spy(*args, **kwargs):
        pooled, table = real(*args, **kwargs)
        seen.append(pooled.num_valid.tolist())
        return pooled, table

    real = volt_module.sparse_reduce
    with mock.patch.object(volt_module, "sparse_reduce", spy):
        out, ms = forward_ms(model, vox)
    return out, ms, seen[0]


def phase_volt(device):
    """Volt-s inference: 3 bench-scale requests on the kernel path, one on
    the plain path, and a small fp32 Volt; returns the main path's launches."""
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.volt import build_volt

    # Tight check first: a small fp32 Volt (dim 64, 4 heads of D 16).
    small_model = build_volt("volt-s", 3, NUM_CLASSES, dim=64, num_heads=4, depth=2,
                             device=device, generator=torch.Generator().manual_seed(1)).eval()
    small = make_batch(400, 4096, device)
    with torch.inference_mode():
        got, _, _ = volt_forward(small_model, small)
        with plain_kernels():
            ref, _, _ = volt_forward(small_model, small)
    err = rel_err(got, ref)
    check(err <= VOLT_TOL[torch.float32], f"volt fp32: relative error {err:.3e}")
    log(f"volt fp32 (dim 64, 4 heads, depth 2, n_cap 4096): relative error vs plain {err:.3e}")
    del small_model

    model = build_volt("volt-s", 3, NUM_CLASSES, token_capacity=TOKEN_CAPACITY, device=device,
                       generator=torch.Generator().manual_seed(0)).eval()
    requests = [make_batch(seed, N_CAP, device) for seed in range(11, 11 + REQUESTS)]
    want = dict(k1=1, fwd=2, attn=K9_PER_FORWARD)
    constants.set_compute_dtype(torch.bfloat16)
    try:
        logits, fwd_ms, toks = [], [], []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with torch.inference_mode():
            for i, vox in enumerate(requests):
                before = all_counts(tuple(wrappers()))
                out, ms, seen = volt_forward(model, vox)
                check_launches(f"volt request {i}", want, before)
                logits.append(out)
                fwd_ms.append(ms)
                toks.append(seen)
        launches = all_counts(tuple(wrappers()))
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode(), plain_kernels():
            ref, plain_ms, _ = volt_forward(model, requests[0])
    finally:
        constants.set_compute_dtype(None)
    for i, vox in enumerate(requests):
        mask = vox.valid_mask()
        got = logits[i]
        expect = token_counts(vox)
        check(tuple(got.shape) == (B, N_CAP, NUM_CLASSES), f"volt logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"volt request {i}: non-finite logits")
        check(bool((got[~mask] == 0).all()), f"volt request {i}: pad rows not zero")
        check(max(expect) <= TOKEN_CAPACITY and toks[i] == expect,
              f"volt request {i}: tokens {toks[i]}, distinct coords // {PATCH} {expect}, "
              f"capacity {TOKEN_CAPACITY}")
        log(f"volt request {i}: {vox.num_valid.tolist()} voxels, {toks[i]} tokens (none "
            f"dropped), forward {fwd_ms[i]:.3f} ms")
    log(f"volt: card {card_state()}")
    mask = requests[0].valid_mask()
    err = rel_err(logits[0][mask], ref[mask])
    check(err <= VOLT_TOL[torch.bfloat16], f"volt bf16: relative error {err:.3e}")
    steady = fwd_ms[1:]
    points = sum(int(v.num_valid.sum()) for v in requests[1:])
    tokens = sum(sum(t) for t in toks[1:])
    log(f"volt-s bf16 conv compute, fp32 trunk: forward ms {[round(t, 3) for t in fwd_ms]}, "
        f"plain path {plain_ms:.3f} ms (request 0), relative error vs plain {err:.3e}; "
        f"{tokens / (sum(steady) / 1e3):.1f} tokens/s, {points / (sum(steady) / 1e3):.1f} "
        f"points/s (requests 2-{REQUESTS}); peak memory {peak / 2**30:.3f} GiB; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches


def train_steps(model, state0, batch, labels, steps, plain, keys=tuple(PER_STEP)):
    """Run ``steps`` train steps from ``state0`` with a fresh Adam. Returns
    (losses, step ms, launches per step of the kernels ``keys``, step 1's
    (loss, grads, params))."""
    from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

    model.load_state_dict(state0)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=ADAM_EPS)
    step = make_segmentation_train_step(model, opt, NUM_CLASSES)
    losses, times, launches, first = [], [], [], None
    with plain_kernels() if plain else nullcontext():
        for i in range(steps):
            before = all_counts(keys)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, labels)["loss"]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append({k: v - before[k] for k, v in all_counts(keys).items()})
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


def compare_first_steps(got, ref, again, state0, dtype, label, tol=None):
    """Step 1 on the kernel path against the plain path: loss, all
    gradients (relative Frobenius error) and the post-step parameters,
    within ``tol`` (default ``TRAIN_TOL[dtype]``). ``again`` is a second
    kernel-path step 1, whose spread from the first (fp32 atomics add in a
    varying order) is logged beside the error."""
    tol = tol or TRAIN_TOL[dtype]
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


def labels_for(vox, seed):
    """Seeded class labels [B, N] on vox's device."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, NUM_CLASSES, size=tuple(vox.coords.shape[:2])).astype(np.int64)
    ).to(vox.coords.device)


def phase_train(device):
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18

    model = MinkUNet18(3, NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}

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
    totals = all_counts(tuple(wrappers()))
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


def phase_volt_train(device):
    """Volt-s training: a small fp32 step against the plain path, then
    VOLT_TRAIN_STEPS bench-scale steps on the kernel path and step 1 again
    on the plain path. Returns the kernel steps' launches."""
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.volt import build_volt

    keys = tuple(wrappers())

    def snapshot(model):
        return ({k: v.detach().clone() for k, v in model.state_dict().items()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    # Tight check first: a small fp32 Volt (dim 64, 4 heads of D 16, depth 2).
    small_model = build_volt("volt-s", 3, NUM_CLASSES, dim=64, num_heads=4, depth=2,
                             device=device, generator=torch.Generator().manual_seed(1))
    state0, params0 = snapshot(small_model)
    small = make_batch(500, 4096, device).lex_sort()
    small_labels = labels_for(small, 501)
    runs = [train_steps(small_model, state0, small, small_labels, 1, plain, keys)[3]
            for plain in (False, False, True)]
    compare_first_steps(runs[0], runs[2], runs[1], params0, torch.float32,
                        "volt train fp32 (dim 64, depth 2, n_cap 4096)",
                        VOLT_TRAIN_TOL[torch.float32])
    del small_model, runs

    model = build_volt("volt-s", 3, NUM_CLASSES, token_capacity=TOKEN_CAPACITY, device=device,
                       generator=torch.Generator().manual_seed(0))
    state0, params0 = snapshot(model)
    batch = make_batch(7, N_CAP, device).lex_sort()
    labels = labels_for(batch, 8)
    points, tokens = int(batch.num_valid.sum()), sum(token_counts(batch))
    constants.set_compute_dtype(torch.bfloat16)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, ms, launches, got = train_steps(model, state0, batch, labels, VOLT_TRAIN_STEPS,
                                                plain=False, keys=keys)
        totals = all_counts(keys)
        peak = torch.cuda.max_memory_allocated()
        p_losses, p_ms, p_launches, ref = train_steps(model, state0, batch, labels, 2,
                                                      plain=True, keys=keys)
        _, _, _, again = train_steps(model, state0, batch, labels, 1, plain=False, keys=keys)
    finally:
        constants.set_compute_dtype(None)
    log(f"volt train bf16 conv compute, fp32 trunk: {points} voxels, {tokens} tokens; losses "
        f"kernel path {losses}, plain path {p_losses}")
    want = {k: VOLT_PER_STEP.get(k, 0) for k in keys}
    for i, per in enumerate(launches):
        check(per == want, f"volt step {i}: launches {per}, want {want}")
    check(all(sum(per.values()) == 0 for per in p_launches), "the plain path launched a kernel")
    compare_first_steps(got, ref, again, params0, torch.bfloat16, "volt train bf16 (bench scale)",
                        VOLT_TRAIN_TOL[torch.bfloat16])
    # Adam's first update moves every weight by about lr; at lr 1e-3 it
    # overshoots on this randomly initialised trunk (the plain path's
    # second loss shows the same), so the loss is held to fall from step 2.
    check(losses[-1] < losses[1], f"volt loss did not fall after step 2: {losses}")
    steady = ms[1:]
    secs = sum(steady) / 1e3
    log(f"volt train: step ms (steps 2-{VOLT_TRAIN_STEPS}) {[round(t, 3) for t in steady]}; "
        f"step 1 kernel {ms[0]:.3f}, plain {p_ms[0]:.3f}; {points * len(steady) / secs:.1f} "
        f"points/s, {tokens * len(steady) / secs:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB; launches over {VOLT_TRAIN_STEPS} steps "
        f"{ {k: n for k, n in totals.items() if n} }; card {card_state()}")
    return totals


def ptv3_levels(vox):
    """The bench pair at PTv3's five levels: stride-2 grid max pooling at
    capacities n_cap >> level, as the model pools."""
    from warpconvnet_tpu_torch.nn.functional.sparse_pool import sparse_max_pool

    out = [vox]
    for i in range(1, len(PTV3_WIDTHS)):
        out.append(sparse_max_pool(out[-1], 2, 2, out_capacity=vox.max_num_points >> i)[0])
    return out


def phase_ptv3_shapes(vox):
    """PTv3's kernel shapes on the bench pair ``vox`` (6 channels, n_cap
    PTV3_N_CAP), each against its plain version and timed beside its bound:
    K2 and K4 (bf16, in the maps' row orders) on the 5^3 stem map at C 6 ->
    32 and on each level's 3^3 map at its positional conv's width; K9, K9-dkv
    and K9-dq (fp32, as training runs them) at level 0's patch shape [B,
    n_cap, 2, 16], segments of 1024 rows of the valid rows and the pad rows
    on ids of their own (``patch_segment_ids``), with the kv tiles K9 visits
    against those of the valid rows alone. Returns {kind: entry} for the
    kernels' JSON line."""
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig
    from warpconvnet_tpu_torch.kernels import segment_attention as k9
    from warpconvnet_tpu_torch.nn.functional.flash_attention import patch_segment_ids
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(17)
    levels = ptv3_levels(vox)
    log(f"PTv3 bench pair: valid rows by level {[v.num_valid.tolist() for v in levels]}")
    convs = [("stem 5^3 L0", levels[0], 5, PTV3_IN, PTV3_WIDTHS[0], 1)]
    convs += [(f"xCPE 3^3 L{i}", v, 3, PTV3_WIDTHS[i], PTV3_WIDTHS[i], PTV3_CPE[i])
              for i, v in enumerate(levels)]
    results = dict(fwd=[], fused=[])
    for label, v, ks, c_in, c_out, per_step in convs:
        sub = generate_output_coords_and_kernel_map(v, ks)[2].with_orders()
        b, k, n = sub.table.shape
        pairs = int((sub.table >= 0).sum())
        flops = 2.0 * pairs * c_in * c_out
        x = torch.randn((b, n, c_in), generator=gen, device="cuda")
        x = torch.where(v.valid_mask()[..., None], x, 0).to(dt)
        w = (torch.randn((k, c_in, c_out), generator=gen, device="cuda") / (k * c_in) ** 0.5)
        w = w.to(dt)
        g = (torch.randn((b, n, c_out), generator=gen, device="cuda") / 300).to(dt)
        got = ig.implicit_gemm_fwd(x, w, sub.table, order=sub.order)
        ref = ig.implicit_gemm_fwd_plain(x, w, sub.table)
        dx, dw = ig.implicit_gemm_bwd_fused(x, g, w, sub.table, sub.offsets, order=sub.order)
        ref_dx, ref_dw = ig.implicit_gemm_bwd_fused_plain(x, g, w, sub.table, sub.offsets)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **K2_TOL[dt])
        torch.testing.assert_close(dx.float(), ref_dx.float(), **K2_TOL[dt])
        dw_err = rel_err(dw, ref_dw)
        check(dw_err <= DW_TOL, f"K4 PTv3 {label}: dw relative error {dw_err:.3e} > {DW_TOL}")
        rows = {}
        for kind, fn, plain, nb, f in (
                ("fwd", lambda: ig.implicit_gemm_fwd(x, w, sub.table, order=sub.order),
                 lambda: ig.implicit_gemm_fwd_plain(x, w, sub.table),
                 nbytes(x, w, sub.table, got), flops),
                ("fused", lambda: ig.implicit_gemm_bwd_fused(x, g, w, sub.table, sub.offsets,
                                                             order=sub.order),
                 lambda: ig.implicit_gemm_bwd_fused_plain(x, g, w, sub.table, sub.offsets),
                 nbytes(x, g, w, sub.table, dx, dw), 2 * flops)):
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            b_ms, b_by = bound(nb, f, dt)
            rows[kind] = dict(shape=f"{label} {c_in}->{c_out}", k=k, rows=n, pairs=pairs,
                              launches_per_step=per_step, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
            results[kind].append(rows[kind])
        results["fused"][-1]["dw_rel_err"] = dw_err
        log(f"PTv3 {label} {c_in}->{c_out} bf16 ({per_step} a step, {pairs} pairs): K2 "
            f"{rows['fwd']['ms']:.4f} ms (plain {rows['fwd']['plain_ms']:.4f}, bound "
            f"{rows['fwd']['bound_ms']:.4f}), K4 {rows['fused']['ms']:.4f} ms (plain "
            f"{rows['fused']['plain_ms']:.4f}, bound {rows['fused']['bound_ms']:.4f}); dw rel err "
            f"{dw_err:.3e}")
        del x, w, g, got, ref, dx, dw, ref_dx, ref_dw, sub
    for kind, name in (("fwd", "K2"), ("fused", "K4")):
        rows = results[kind]
        log(f"{name} over a PTv3 step's conv shapes: {sum(r['launches_per_step'] for r in rows)} "
            f"launches, {sum(r['ms'] * r['launches_per_step'] for r in rows):.4f} ms by the "
            f"shapes' times, bound {sum(r['bound_ms'] * r['launches_per_step'] for r in rows):.4f}"
            f" ms; card {card_name()}")

    v0 = levels[0]
    b, n, h, d = v0.batch_size, v0.max_num_points, PTV3_WIDTHS[0] // 16, 16
    seg_q, seg_kv = patch_segment_ids(v0.num_valid, n, PTV3_PATCH)
    pad = seg_q != seg_kv
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda") for _ in "qkv")
    q = q * 2.5
    # The caller (Attention) zeroes pad outputs, so dO is zero there.
    do = torch.where(pad[..., None, None], 0, torch.randn((b, n, h, d), generator=gen,
                                                          device="cuda"))
    out, lse = k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True)
    ref, ref_lse = k9.segment_attention_fwd_plain(q, k, v, seg_q, seg_kv, return_lse=True)
    di = k9.rowsum_o_do(out, do)
    args = (q, k, v, do, lse, di, seg_q, seg_kv)
    dk, dv = k9.segment_attention_bwd_dkv(*args)
    dq = k9.segment_attention_bwd_dq(*args)
    ref_grads = k9.segment_attention_bwd_plain(q, k, v, out, lse, do, seg_q, seg_kv)
    torch.cuda.synchronize()
    tol = K9_TOL[torch.float32]
    err = rel_err(out, ref)
    max_abs, scale = float((out - ref).abs().max()), float(ref.abs().max())
    check(err <= tol and max_abs <= tol * scale, f"K9 PTv3 L0 patches: relative error "
          f"{err:.3e}, max abs {max_abs:.3e} (largest {scale:.3e}) > {tol}")
    finite = torch.isfinite(ref_lse)
    check(torch.equal(torch.isfinite(lse), finite), "K9 PTv3 L0: lse +inf on other rows")
    lse_err = rel_err(lse[finite], ref_lse[finite])
    check(lse_err <= tol, f"K9 PTv3 L0 patches: lse relative error {lse_err:.3e} > {tol}")
    check(bool((out[pad] == 0).all()) and bool((dq[pad] == 0).all()),
          "K9 PTv3 L0: a pad row's output or dq is not zero")
    errs = [rel_err(g, r) for g, r in zip((dq, dk, dv), ref_grads)]
    check(max(errs) <= K9_BWD_TOL[torch.float32],
          f"K9-bwd PTv3 L0 patches: dq, dk, dv relative errors {errs} > "
          f"{K9_BWD_TOL[torch.float32]}")
    del ref, ref_lse, ref_grads
    visited, tiles = k9.kv_tiles_visited(seg_q, seg_kv)
    alone = sum(k9.kv_tiles_visited(seg_q[i:i + 1, :m], seg_kv[i:i + 1, :m])[0]
                for i, m in enumerate(v0.num_valid.tolist()))
    check(visited <= 1.1 * alone, f"K9 PTv3 L0: {visited} kv tiles visited, the valid rows "
          f"alone {alone}")
    pairs = equal_segment_pairs(seg_q, seg_kv)
    inputs = nbytes(q, k, v, seg_q, seg_kv)
    shape = (f"B={b} S={n} H={h} D={d} fp32, {PTV3_PATCH}-row patches of "
             f"{v0.num_valid.tolist()} valid rows (PTv3 level 0; 4 of the 22 blocks a step)")
    entries = {}
    for kind, fn, nb, f in (
            ("attn", lambda: k9.segment_attention_fwd(q, k, v, seg_q, seg_kv, return_lse=True),
             inputs + nbytes(out, lse), 4.0 * pairs * d * h),
            ("dkv", lambda: k9.segment_attention_bwd_dkv(*args),
             inputs + nbytes(do, lse, di, dk, dv), 8.0 * pairs * d * h),
            ("dq", lambda: k9.segment_attention_bwd_dq(*args),
             inputs + nbytes(do, lse, di, dq), 6.0 * pairs * d * h)):
        ms = cuda_ms(fn, iters=5, warmup=1)
        b_ms, b_by = bound(nb, f, peak=TF32X3_FLOPS)
        entries[kind] = dict(shape=shape, ms=ms, bound_ms=b_ms, bound_by=b_by)
    entries["attn"].update(rel_err=err, max_abs_err=max_abs, lse_rel_err=lse_err,
                           kv_tiles_visited=visited, kv_tiles=tiles, kv_tiles_valid_alone=alone)
    entries["dkv"]["rel_err"], entries["dq"]["rel_err"] = max(errs[1:]), errs[0]
    log(f"PTv3 patch attention {shape}: K9 {entries['attn']['ms']:.4f} ms (bound "
        f"{entries['attn']['bound_ms']:.4f}), K9-dkv {entries['dkv']['ms']:.4f} ms (bound "
        f"{entries['dkv']['bound_ms']:.4f}), K9-dq {entries['dq']['ms']:.4f} ms (bound "
        f"{entries['dq']['bound_ms']:.4f}) on {pairs} equal-segment pairs; rel err out {err:.3e}, "
        f"lse {lse_err:.3e}, dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}; kv tiles "
        f"visited {visited} of {tiles}, the valid rows alone {alone}; card {card_state()}")
    return dict(fwd=results["fwd"], fused=results["fused"], **entries)


def phase_ptv3_train(device):
    """PTv3 training: a small fp32 step (the published depths at small
    widths) against the plain path, then PTV3_TRAIN_STEPS bench-scale steps
    at the published widths on the kernel path. Returns the bench-scale
    steps' launches."""
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.point_transformer_v3 import build_ptv3

    keys = tuple(wrappers())

    def snapshot(model):
        return ({k: v.detach().clone() for k, v in model.state_dict().items()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    small_model = build_ptv3(PTV3_IN, NUM_CLASSES, patch_size=64, device=device,
                             generator=torch.Generator().manual_seed(1),
                             enc_channels=(16, 16, 32, 32, 32), enc_num_head=(1, 1, 2, 2, 2),
                             dec_channels=(16, 16, 32, 32), dec_num_head=(1, 1, 2, 2))
    state0, params0 = snapshot(small_model)
    small = make_batch(600, 4096, device, channels=PTV3_IN).lex_sort()
    small_labels = labels_for(small, 601)
    runs = [train_steps(small_model, state0, small, small_labels, 1, plain, keys)[3]
            for plain in (False, False, True)]
    compare_first_steps(runs[0], runs[2], runs[1], params0, torch.float32,
                        "ptv3 train fp32 (small widths, patch 64, n_cap 4096)", PTV3_TRAIN_TOL)
    del small_model, runs

    model = build_ptv3(PTV3_IN, NUM_CLASSES, device=device,
                       generator=torch.Generator().manual_seed(0))
    state0 = snapshot(model)[0]
    batch = make_batch(9, PTV3_N_CAP, device, channels=PTV3_IN).lex_sort()
    labels = labels_for(batch, 10)
    points = int(batch.num_valid.sum())
    constants.set_compute_dtype(torch.bfloat16)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, ms, launches, _ = train_steps(model, state0, batch, labels, PTV3_TRAIN_STEPS,
                                              plain=False, keys=keys)
        totals = all_counts(keys)
        peak = torch.cuda.max_memory_allocated()
    finally:
        constants.set_compute_dtype(None)
    log(f"ptv3 train bf16 conv compute, fp32 trunk: {batch.num_valid.tolist()} voxels; losses "
        f"{losses}")
    want = {k: PTV3_PER_STEP.get(k, 0) for k in keys}
    for i, per in enumerate(launches):
        check(per == want, f"ptv3 step {i}: launches {per}, want {want}")
    check(losses[-1] < losses[1], f"ptv3 loss did not fall after step 2: {losses}")
    steady = ms[1:]
    secs = sum(steady) / 1e3
    log(f"ptv3 train: step ms (steps 2-{PTV3_TRAIN_STEPS}) {[round(t, 3) for t in steady]}; "
        f"step 1 {ms[0]:.3f}; {points * len(steady) / secs:.1f} points/s; peak memory "
        f"{peak / 2**30:.3f} GiB; launches over {PTV3_TRAIN_STEPS} steps "
        f"{ {k: n for k, n in totals.items() if n} }; card {card_state()}")
    return totals


def profile_run(label, fn, out_dir, trace_name):
    """Profile one call of ``fn`` (after the caller's warm-up): device time
    by kernel, the device span and its idle share, read from the exported
    trace ``out_dir/trace_name``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, trace_name)
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
    print(f"profiled {label}: host wall {wall:.3f} ms, device busy {busy:.3f} ms over a span "
          f"of {span:.3f} ms, idle share {1 - busy / span:.1%}, {len(ops)} device ops")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"{t:10.3f} ms {t / busy:6.1%} {n:5d}x  {name[:110]}")


def profile_paths(device, out_dir):
    """Profile one bench-scale bf16 MinkUNet18 train step and one
    SparseConvNeXtBlock fwd+bwd, each after two warm-up runs, and one
    Volt-s forward and one Volt-s train step, each after one."""
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18
    from warpconvnet_tpu_torch.nn.modules.blocks import SparseConvNeXtBlock
    from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

    model = MinkUNet18(3, NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(0))
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                        NUM_CLASSES)
    constants.set_compute_dtype(torch.bfloat16)
    batch = make_batch(7, N_CAP, device).lex_sort()
    labels = torch.from_numpy(np.random.default_rng(8).integers(
        0, NUM_CLASSES, size=tuple(batch.coords.shape[:2]))).to(device)
    for _ in range(2):
        step(batch, labels)
    profile_run("MinkUNet18 train step", lambda: step(batch, labels), out_dir,
                "train_step_trace.json")
    constants.set_compute_dtype(None)
    del model, step, batch

    block = SparseConvNeXtBlock(CONVNEXT_C, CONVNEXT_K, device=device,
                                generator=torch.Generator().manual_seed(0))
    vox = make_batch(301, N_CAP, device, channels=CONVNEXT_C, scale=0.1).lex_sort()
    vox = vox.replace(features=vox.features.to(torch.bfloat16))
    for _ in range(2):
        convnext_run(block, vox, train=True)
    profile_run("SparseConvNeXtBlock fwd+bwd", lambda: convnext_run(block, vox, train=True),
                out_dir, "convnext_trace.json")
    del block, vox

    from warpconvnet_tpu_torch.models.volt import build_volt

    model = build_volt("volt-s", 3, NUM_CLASSES, token_capacity=TOKEN_CAPACITY, device=device,
                       generator=torch.Generator().manual_seed(0)).eval()
    vox = make_batch(11, N_CAP, device)
    constants.set_compute_dtype(torch.bfloat16)
    with torch.inference_mode():
        forward_ms(model, vox)
        profile_run("Volt-s forward", lambda: forward_ms(model, vox), out_dir, "volt_trace.json")
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                        NUM_CLASSES)
    batch = vox.lex_sort()
    labels = labels_for(batch, 8)
    step(batch, labels)
    profile_run("Volt-s train step", lambda: step(batch, labels), out_dir,
                "volt_train_trace.json")
    constants.set_compute_dtype(None)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile a bench-scale MinkUNet18 train step, a ConvNeXt block "
                             "fwd+bwd, a Volt-s forward and a Volt-s train step into DIR instead")
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

    print(card_name(), flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    if args.profile:
        profile_paths(device, args.profile)
        return 0

    vox = make_batch(0, N_CAP, device).lex_sort()
    tokens = token_counts(vox)
    log(f"bench scene pair: {vox.num_valid.tolist()} voxels, {tokens} tokens at patch {PATCH}")
    table, k1 = phase_k1(vox)
    k5 = phase_k5(vox)
    k2 = phase_k2(vox, table)
    bwd = phase_bwd(vox, table)
    step_shape_results, step_map_rows = phase_step_shapes(vox)
    k2["step_shapes"], k2["step_maps"] = step_shape_results["fwd"], step_map_rows
    bwd["dgrad"]["step_shapes"] = step_shape_results["dgrad"]
    bwd["wgrad"]["step_shapes"] = step_shape_results["wgrad"]
    bwd["fused"]["step_shapes"] = step_shape_results["fused"]
    depth = phase_depthwise(vox, table)
    del table, vox
    # The main paths, each driven with every launch count set to 0 just
    # before it, while recording (K1 counts its tiles).
    with device_counts(device) as gained:
        paths = {f"MinkUNet18 inference ({REQUESTS} requests)": phase_slice(device),
                 f"MinkUNet18 train ({TRAIN_STEPS} steps)": phase_train(device)}
        paths.update(phase_convnext(device))
        paths.update(phase_strided_grouped(device))
        k9 = phase_k9(tokens)
        k9_bwd = phase_k9_bwd(tokens)
        paths[f"Volt-s inference ({REQUESTS} requests)"] = phase_volt(device)
        paths[f"Volt-s train ({VOLT_TRAIN_STEPS} steps)"] = phase_volt_train(device)
        ptv3 = phase_ptv3_shapes(make_batch(0, PTV3_N_CAP, device, channels=PTV3_IN).lex_sort())
        paths[f"PTv3 train ({PTV3_TRAIN_STEPS} steps)"] = phase_ptv3_train(device)
    tiles, wide = gained["k1.tiles"], gained["k1.wide_tiles"]
    log(f"K1 over the main-path phases: {wide} of {tiles} tiles walked in device memory")
    k1["main_paths_global_share"] = wide / tiles
    k2["ptv3_shapes"], bwd["fused"]["ptv3_shapes"] = ptv3["fwd"], ptv3["fused"]
    for key, entry in (("attn", k9), ("dkv", k9_bwd["dkv"]), ("dq", k9_bwd["dq"])):
        entry["ptv3_patches"] = ptv3[key]
    entries = dict(k1=k1, fwd=k2, **bwd, **depth, attn=k9, **k9_bwd)
    for key, entry in entries.items():
        by_path = {p: c[key] for p, c in paths.items() if c[key]}
        check(by_path != {}, f"{entry['name']}: launched on no main path")
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    k5["launches"] = 0
    entries["k5"] = k5
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
