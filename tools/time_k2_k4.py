"""Time the implicit-GEMM kernels K2 (forward and dgrad), K3 and K4 on the
card at the shapes of a bf16 MinkUNet18 train step, for one checkout of the
port or several in turn.

    python3 tools/time_k2_k4.py                                 # this checkout
    python3 tools/time_k2_k4.py --tree A --tree B --tree B --tree A
    python3 tools/time_k2_k4.py --shapes-only ...              # the kernels alone
    python3 tools/time_k2_k4.py --steps 17 --forwards 16 ...   # longer model runs

Each ``--tree`` is the root of a checkout (the directory that holds
``warpconvnet_tpu_torch``); the trees run one after another, each in its
own process, so two versions compare on the same card in one call. Every
tree is timed by the same code: the timing helpers, the map builder
(``step_maps``) and the shape list (``step_shapes``) of this checkout's
``chip_smoke.py``, on its bench scene pair (B 2, n_cap 131072, seed 0,
lex-sorted). A tree whose maps carry row orders gets them; one whose
wrappers take no ``order`` is called without.

Prints the card's name and power limit, then one JSON line per tree: per
shape (kind fwd / dgrad / wgrad / fused, launches a step; and K3 and K4 in
fp32, kinds wgrad_fp32 and fused_fp32, at chip_smoke.py phase_bwd's C
32->32 on the L0 2^3 map and its reverse and on the L0 3^3 map, outside the
step's sums), the time a call by CUDA
events back to back (``ms``) and from a profiler trace (``device_ms``: the
call's kernels, its weight packing and dw memset included), the host's
time to issue one call (``host_ms``), for K4 also the split pair
K2-dgrad + K3 by events (``pair_ms``), and a SHA-1 of K2's and
K2-dgrad's output (equal across runs of one tree: deterministic; the
trees' digests differ where they sum in other orders), for K3 its plan;
the events-weighted sums a step, and K3's by trace (``wgrad_device``); then bf16 MinkUNet18 forwards (eval mode, CUDA events; 6 by
default) and train steps (9 by default), the first of each left out: per
step the host's time to issue it (until ``step()`` returns) and to finish
it (after a synchronise), and one profiled step's device busy time, span,
idle share and K2 / K3 / K4 device time by kernel name. Last, one ``summary``
line pools each tree's runs: the median, least and most forward ms, step
ms and issue ms, and their counts.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
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
    """SHA-1 of a bf16 tensor's bits."""
    import torch

    return hashlib.sha1(t.contiguous().cpu().view(torch.int16).numpy().tobytes()).hexdigest()


def shape_times(cs, torch, vox):
    from warpconvnet_tpu_torch.kernels import implicit_gemm as ig

    takes_order = "order" in inspect.signature(ig.implicit_gemm_fwd).parameters

    def kw(order):
        return dict(order=order) if takes_order and order is not None else {}

    subs, downs = cs.step_maps(vox)
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []

    def timed(row, fn):
        row["ms"], row["device_ms"] = cs.cuda_ms(fn), cs.device_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        row["host_ms"] = (time.perf_counter() - t0) * 1e3 / CALLS
        torch.cuda.synchronize()
        if row["kind"].startswith("wgrad"):  # K3's blocks and chunk rows, where the tree has them
            row["plan"] = getattr(ig.implicit_gemm_wgrad, "plan", None)
        rows.append(row)
        cs.log(f"{row['shape']} {row['kind']}: {row}")

    for kind, label, table, order, n_src, c_in, c_out, convs, sub in cs.step_shapes(subs, downs):
        b, k, n_out = table.shape
        w = (torch.randn((k, c_in, c_out), generator=gen, device="cuda") / (k * c_in) ** 0.5)
        w = w.to(dt)
        row = dict(kind=kind, shape=label, launches_per_step=convs)
        if kind == "fused":
            x = torch.randn((b, n_out, c_in), generator=gen, device="cuda").to(dt)
            g = (torch.randn((b, n_out, c_out), generator=gen, device="cuda") / 300).to(dt)
            rev = table.flip(1).contiguous()

            def fn():
                return ig.implicit_gemm_bwd_fused(x, g, w, table, sub.offsets, **kw(order))

            row["pair_ms"] = cs.cuda_ms(lambda: (ig.implicit_gemm_dgrad(g, w, rev, **kw(order)),
                                                 ig.implicit_gemm_wgrad(x, g, table)))
        elif kind == "wgrad":  # dw sums with atomics: its bits vary, so no digest
            x = torch.randn((b, n_src, c_in), generator=gen, device="cuda").to(dt)
            g = (torch.randn((b, n_out, c_out), generator=gen, device="cuda") / 300).to(dt)

            def fn():
                return ig.implicit_gemm_wgrad(x, g, table)
        else:
            x = torch.randn((b, n_src, c_in), generator=gen, device="cuda").to(dt)
            if kind == "fwd":
                def fn():
                    return ig.implicit_gemm_fwd(x, w, table, **kw(order))
            else:
                wd = w.transpose(1, 2).contiguous()

                def fn():
                    return ig.implicit_gemm_dgrad(x, wd, table, **kw(order))
            row["sha1"] = sha1(fn())
        timed(row, fn)
    # K3 in fp32 at chip_smoke.py phase_bwd's C 32->32, on the L0 2^3 map
    # and its reverse (outside the bf16 step's sums).
    down = downs[0]
    for label, table, n_src in (("L0->L1 2^3 32->32 fp32", down.table, down.rev.shape[2]),
                                ("L1->L0 2^3 transposed 32->32 fp32", down.rev,
                                 down.table.shape[2])):
        b, _, n_out = table.shape
        x = torch.randn((b, n_src, 32), generator=gen, device="cuda")
        g = torch.randn((b, n_out, 32), generator=gen, device="cuda") / 300

        def fn():
            return ig.implicit_gemm_wgrad(x, g, table)
        timed(dict(kind="wgrad_fp32", shape=label, launches_per_step=0), fn)
    # K4 in fp32 at phase_bwd's L0 3^3 C 32->32, beside it.
    sub = subs[0]
    b, k, n = sub.table.shape
    x = torch.randn((b, n, 32), generator=gen, device="cuda")
    g = torch.randn((b, n, 32), generator=gen, device="cuda") / 300
    w = torch.randn((k, 32, 32), generator=gen, device="cuda") / (k * 32) ** 0.5

    def fn():
        return ig.implicit_gemm_bwd_fused(x, g, w, sub.table, sub.offsets,
                                          **kw(getattr(sub, "order", None)))
    timed(dict(kind="fused_fp32", shape="L0 3^3 32->32 fp32", launches_per_step=0), fn)
    totals = {kind: sum(r["ms"] * r["launches_per_step"] for r in rows if r["kind"] == kind)
              for kind in ("fwd", "dgrad", "wgrad", "fused")}
    totals["wgrad_device"] = sum(r["device_ms"] for r in rows if r["kind"] == "wgrad")
    return rows, totals


def step_profile(cs, torch, step, batch, labels):
    """One profiled train step: device busy ms, span ms, idle share, and
    device ms by kernel name for K2 (``igemm_fwd``), K3 (``igemm_wgrad``)
    and K4 (``igemm_bwd_fused``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch, labels)
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
    for key in ("igemm_fwd", "igemm_bwd_fused", "igemm_wgrad"):
        hits = [e["dur"] for e in ops if key in e["name"]]
        by[key] = dict(calls=len(hits), ms=sum(hits) / 1e3)
    return dict(busy_ms=busy, span_ms=span, idle_share=1 - busy / span, kernels=by)


def model_times(cs, torch, dev, steps, forwards):
    from warpconvnet_tpu_torch import constants
    from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18
    from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step

    model = MinkUNet18(3, cs.NUM_CLASSES, device=dev, generator=torch.Generator().manual_seed(0))
    constants.set_compute_dtype(torch.bfloat16)
    request = cs.make_batch(1, cs.N_CAP, dev)
    model.eval()
    with torch.inference_mode():
        forward_ms = [cs.forward_ms(model, request)[1] for _ in range(forwards)][1:]
    model.train()
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=cs.LR),
                                        cs.NUM_CLASSES)
    batch = cs.make_batch(7, cs.N_CAP, dev).lex_sort()
    labels = cs.labels_for(batch, 8)
    host, wall = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, labels)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    prof = step_profile(cs, torch, step, batch, labels)
    constants.set_compute_dtype(None)
    return dict(forward_ms=forward_ms, step_host_issue_ms=host[1:], step_ms=wall[1:],
                step_profile=prof)


def run_tree(tree, shapes_only, steps, forwards):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    vox = cs.make_batch(0, cs.N_CAP, dev).lex_sort()
    rows, totals = shape_times(cs, torch, vox)
    del vox
    return dict(tree=tree, shapes=rows, ms_a_step_by_shapes=totals,
                **({} if shapes_only else model_times(cs, torch, dev, steps, forwards)))


def summary(runs):
    """Each tree's model numbers pooled over its runs."""
    pooled = {}
    for run in runs:
        tree = pooled.setdefault(run["tree"], {})
        for key in ("forward_ms", "step_ms", "step_host_issue_ms"):
            tree.setdefault(key, []).extend(run.get(key, []))
    return {tree: {key: dict(median=statistics.median(v), min=min(v), max=max(v), n=len(v))
                   for key, v in keys.items() if v}
            for tree, keys in pooled.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="root of a checkout; repeat to run several in turn")
    parser.add_argument("--shapes-only", action="store_true",
                        help="time the kernels' shapes only, not the MinkUNet18 forward and step")
    parser.add_argument("--steps", type=int, default=9,
                        help="train steps a run (the first left out)")
    parser.add_argument("--forwards", type=int, default=6,
                        help="forwards a run (the first left out)")
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:  # one tree, in this process
        print(json.dumps(run_tree(args.tree[0], args.shapes_only, args.steps, args.forwards)),
              flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rc, runs = 0, []
    for tree in args.tree or [ROOT]:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--tree", tree,
                               "--steps", str(args.steps), "--forwards", str(args.forwards)]
                              + ["--shapes-only"] * args.shapes_only,
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
