"""Time the depthwise kernels K6 (forward, and dgrad through the reverse
table) and K8 on the card at the depthwise path's shapes, and the
SparseConvNeXtBlock and a strided depthwise conv around them, for one
checkout of the port or several in turn.

    python3 tools/time_k6_k8.py                                 # this checkout
    python3 tools/time_k6_k8.py --tree A --tree B --tree B --tree A
    python3 tools/time_k6_k8.py --shapes-only ...              # the kernels alone

Each ``--tree`` is the root of a checkout (the directory that holds
``warpconvnet_tpu_torch``); the trees run one after another, each in its
own process, so two versions compare on the same card in one call. Every
tree is timed by the same code: the timing helpers and the scene builder
of this checkout's ``chip_smoke.py``, on its bench scene pair (B 2, n_cap
131072, seed 0, lex-sorted) and the maps the tree builds on it (the 7^3 and
L0 3^3 self-maps, the L0 -> L1 2^3 parity map and its reverse).

Prints the card's name and power limit, then one JSON line per tree: per
shape, the time a call by CUDA events back to back (``ms``) and from a
profiler trace (``device_ms``), the host's time to issue one call
(``host_ms``), a SHA-1 of K6's output or K8's dx (equal across trees that
sum in the same order), for K8 the K6-dgrad + K7 pair by events
(``pair_ms``) and the floats its blocks add into dw where the tree counts
them (``dw_floats``); then the ConvNeXt block (C 96, 7^3, bf16 features):
fwd+bwd and inference ms by CUDA events (the first of each left out), one
profiled fwd+bwd's device busy time, span, idle share and depthwise
kernels' device ms by name; and a 2^3 stride-2 depthwise conv's fwd+bwd ms.
Last, one ``summary`` line pools each tree's runs (median, least, most).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20


def load_smoke():
    """This checkout's ``chip_smoke.py`` as a module (it imports the port
    only inside its functions, so they run the tree's port)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sha1(t) -> str:
    """SHA-1 of a tensor's bits."""
    import torch

    view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return hashlib.sha1(t.contiguous().view(view).cpu().numpy().tobytes()).hexdigest()


def timed(cs, torch, fn):
    """(events ms, trace ms, host issue ms) of one call of ``fn``."""
    ms, dev = cs.cuda_ms(fn), cs.device_ms(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / CALLS
    torch.cuda.synchronize()
    return dict(ms=ms, device_ms=dev, host_ms=host)


def shape_times(cs, torch, vox):
    from warpconvnet_tpu_torch.kernels import depthwise_fma as dw
    from warpconvnet_tpu_torch.nn.functional.sparse_conv import (
        generate_output_coords_and_kernel_map,
    )
    from warpconvnet_tpu_torch.ops.kernel_map import kernel_offsets

    gen = torch.Generator(device="cuda").manual_seed(2)
    mask = vox.valid_mask()[..., None]
    n0, c = vox.max_num_points, cs.CONVNEXT_C

    def rand(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    maps = {}
    for ks in (cs.CONVNEXT_K, 3):
        sub = generate_output_coords_and_kernel_map(vox, ks)[2]
        maps[f"{ks}^3"] = (sub.table, kernel_offsets(ks))
    down = generate_output_coords_and_kernel_map(vox, 2, stride=2, out_capacity=cs.N_CAP // 2)[2]
    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def record(row, fn, out):
        row.update(timed(cs, torch, fn), sha1=sha1(out))
        rows.append(row)
        cs.log(f"{row['kind']} {row['shape']}: {row}")

    for name, cc, dtype in (("7^3", c, bf), ("7^3", c, f32), ("3^3", c, bf), ("3^3", c, f32),
                            ("3^3", cs.VOLT_S_C, bf)):
        table = maps[name][0]
        k = table.shape[1]
        x = rand((cs.B, n0, cc), dtype) * mask
        w = rand((k, cc), torch.float32, k ** -0.5)
        record(dict(kind="K6", shape=f"{name} C{cc} {str(dtype)[6:]}"),
               lambda: dw.depthwise_fma_fwd(x, w, table), dw.depthwise_fma_fwd(x, w, table))
    rev = down.rev.contiguous()
    n1 = down.table.shape[2]
    for dtype in (bf, f32):
        g = rand((cs.B, n1, c), dtype)
        w = rand((8, c), torch.float32, 8 ** -0.5)
        x = rand((cs.B, n0, c), dtype) * mask
        record(dict(kind="K6-dgrad", shape=f"2^3 rev C{c} {str(dtype)[6:]}"),
               lambda: dw.depthwise_fma_dgrad(g, w, rev), dw.depthwise_fma_dgrad(g, w, rev))
        row = dict(kind="K7", shape=f"2^3 C{c} {str(dtype)[6:]}")
        row.update(timed(cs, torch, lambda: dw.depthwise_fma_wgrad(x, g, down.table)))
        rows.append(row)
        cs.log(f"K7 {row['shape']}: {row}")
    try:  # the counter registry (a tree without it reports no count)
        from warpconvnet_tpu_torch import tracing
    except ImportError:
        tracing = None
    for name, dtype in (("7^3", bf), ("3^3", bf), ("3^3", f32)):
        table, offsets = maps[name]
        k = table.shape[1]
        flip = table.flip(1).contiguous()
        x = rand((cs.B, n0, c), dtype) * mask
        g = rand((cs.B, n0, c), dtype) * mask
        w = rand((k, c), torch.float32, k ** -0.5)
        row = dict(kind="K8", shape=f"{name} C{c} {str(dtype)[6:]}")
        if tracing is not None:
            tracing.reset_counters()
            with tracing.recording():
                dx = dw.depthwise_fma_bwd_fused(x, g, w, table, offsets)[0]
            row["dw_floats"] = tracing.counters(x.device)["k8.dw_floats"]
        else:
            dx = dw.depthwise_fma_bwd_fused(x, g, w, table, offsets)[0]
        row["pair_ms"] = cs.cuda_ms(lambda: (dw.depthwise_fma_dgrad(g, w, flip),
                                             dw.depthwise_fma_wgrad(x, g, table)))
        record(row, lambda: dw.depthwise_fma_bwd_fused(x, g, w, table, offsets), dx)
    return rows


def block_profile(cs, torch, fn):
    """One profiled call of ``fn``: device busy ms, span ms, idle share and
    the device ms of each kernel whose name holds ``depth``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            ops = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in ops) / 1e3
    span = (max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops)) / 1e3
    by = {}
    for e in ops:
        found = re.search(r"depth_\w+(<[^()]*>)?", e["name"])
        if found:
            by.setdefault(found.group(0), []).append(e["dur"] / 1e3)
    return dict(busy_ms=busy, span_ms=span, idle_share=1 - busy / span,
                kernels={k: dict(calls=len(v), ms=sum(v)) for k, v in by.items()})


def block_times(cs, torch, dev, runs):
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.nn.modules.blocks import SparseConvNeXtBlock
    from warpconvnet_tpu_torch.nn.modules.sparse_conv import SparseDepthwiseConv3d

    block = SparseConvNeXtBlock(cs.CONVNEXT_C, cs.CONVNEXT_K, device=dev,
                                generator=torch.Generator().manual_seed(0))
    vox = cs.make_batch(301, cs.N_CAP, dev, channels=cs.CONVNEXT_C, scale=0.1).lex_sort()
    vox = vox.replace(features=vox.features.to(torch.bfloat16))
    train = [cs.convnext_run(block, vox, train=True)[2] for _ in range(runs)][1:]
    infer = [cs.convnext_run(block, vox, train=False)[2] for _ in range(runs)][1:]
    prof = block_profile(cs, torch, lambda: cs.convnext_run(block, vox, train=True))
    conv = SparseDepthwiseConv3d(cs.CONVNEXT_C, 2, stride=2, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    constants.set_compute_dtype(torch.bfloat16)
    strided = []
    for _ in range(runs):
        x = vox.features.detach().requires_grad_(True)
        conv.zero_grad(set_to_none=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, _ = conv(vox.replace(features=x), out_capacity=cs.N_CAP // 2)
        (out.features.float() ** 2).sum().backward()
        end.record()
        torch.cuda.synchronize()
        strided.append(start.elapsed_time(end))
    constants.set_compute_dtype(None)
    return dict(convnext_fwd_bwd_ms=train, convnext_inference_ms=infer, convnext_profile=prof,
                strided_fwd_bwd_ms=strided[1:])


def run_tree(tree, shapes_only, runs):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_smoke()
    dev = torch.device("cuda", 0)
    vox = cs.make_batch(0, cs.N_CAP, dev).lex_sort()
    rows = shape_times(cs, torch, vox)
    del vox
    return dict(tree=tree, shapes=rows,
                **({} if shapes_only else block_times(cs, torch, dev, runs)))


def summary(runs):
    """Each tree's block numbers and kernel times pooled over its runs."""
    pooled = {}
    for run in runs:
        tree = pooled.setdefault(run["tree"], {})
        for key in ("convnext_fwd_bwd_ms", "convnext_inference_ms", "strided_fwd_bwd_ms"):
            tree.setdefault(key, []).extend(run.get(key, []))
        for row in run["shapes"]:
            tree.setdefault(f"{row['kind']} {row['shape']} device_ms", []).append(row["device_ms"])
    return {tree: {key: dict(median=statistics.median(v), min=min(v), max=max(v), n=len(v))
                   for key, v in keys.items() if v}
            for tree, keys in pooled.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="root of a checkout; repeat to run several in turn")
    parser.add_argument("--shapes-only", action="store_true",
                        help="time the kernels' shapes only, not the ConvNeXt block")
    parser.add_argument("--runs", type=int, default=9,
                        help="ConvNeXt and strided runs of each kind a tree (the first left out)")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:  # one tree, in this process
        print(json.dumps(run_tree(args.tree[0], args.shapes_only, args.runs)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rc, runs = 0, []
    for tree in args.tree or [ROOT]:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--tree", tree,
                               "--runs", str(args.runs)] + ["--shapes-only"] * args.shapes_only,
                              stdout=subprocess.PIPE, text=True)
        print(done.stdout, end="", flush=True)
        rc |= done.returncode
        if done.returncode == 0:
            runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    print(json.dumps({"summary": summary(runs)}), flush=True)
    print(f"rc={rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
