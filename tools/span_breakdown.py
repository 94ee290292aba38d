"""Where a benchmark cell's host time and the card's idle time go, by the
port's ``wcn.*`` spans (``warpconvnet_tpu_torch/tracing.py``).

    python3 tools/span_breakdown.py --workload minkunet18.train --seed 7 [--seconds 10] [--items 3]

Runs the cell through the benchmark's harness (``benchmark/harness/cell.py``:
set-up, a window of ``--seconds`` with nothing recording, then ``--items``
steps or requests under ``torch.profiler``, each in the harness's own
``bench.step`` / ``bench.request`` span) and prints, per item:

- host ms by span (the name without its ``[...]`` detail): calls, ms, and
  ms in the outermost spans of that name;
- each ``wcn.sync.*`` site: calls and host ms;
- the card's idle time (gaps between device operations), by the innermost
  ``wcn.*`` or ``bench.*`` span running when each gap began, and by the
  phase (``wcn.train_step.<phase>``, ``wcn.model.*`` or the item's span);
- the host's longest CUDA runtime calls and the span each ran in;
- the cost of tracing when on: the traced items' host time in their
  ``bench.*`` span and in the step or model span against the window's
  ``host_issue_ms`` (the same call with nothing recording), and the host
  issue time of as many items recording spans with no profiler (the spans'
  own cost, without the profiler's) and of as many again with nothing
  recording, back to back (the same scenes' spread).

Last, one JSON line of the same numbers. Skips the comparison that decides
``correct``: this is a reading of where time goes, not a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = ("wcn.train_step.", "wcn.train_step", "wcn.model.", "bench.")


def _events(prof):
    """(host spans and ops, device ops, runtime calls) of a profile, each
    (name, start s, duration s, thread)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    host, dev, runtime = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", "?"), e["ts"] * 1e-6, e["dur"] * 1e-6, e.get("tid"))
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(item)
        elif cat in ("cpu_op", "user_annotation"):
            host.append(item)
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append(item)
    return host, dev, runtime


def _cls(name):
    return name.split("[")[0]


def _union(spans):
    total, end = 0.0, float("-inf")
    for t, d in sorted(spans):
        if t + d > end:
            total += t + d - max(t, end)
            end = t + d
    return total


def _innermost(spans, t, want):
    """The shortest span covering time ``t`` whose name ``want`` accepts."""
    best = None
    for name, s, d, _ in spans:
        if s <= t < s + d and want(name) and (best is None or d < best[1]):
            best = (name, d)
    return _cls(best[0]) if best else "(no span)"


def analyse(host, dev, runtime, n_items):
    spans = [e for e in host if e[0].startswith(("wcn.", "bench."))]
    by_name = defaultdict(list)
    for name, t, d, _ in spans:
        by_name[_cls(name)].append((t, d))
    table = {k: dict(calls=len(v) / n_items, ms=1e3 * sum(d for _, d in v) / n_items,
                     outermost_ms=1e3 * _union(v) / n_items) for k, v in sorted(by_name.items())}
    syncs = {k: v for k, v in table.items() if k.startswith("wcn.sync.")}
    dev = sorted(dev, key=lambda e: e[1])
    gaps, end = [], None
    for _, t, d, _ in dev:
        if end is not None and t > end:
            gaps.append((end, t - end))
        end = t + d if end is None else max(end, t + d)
    idle_s = sum(d for _, d in gaps)
    span_s = (max(t + d for _, t, d, _ in dev) - dev[0][1]) if dev else 0.0
    by_span, by_phase = defaultdict(float), defaultdict(float)
    for start, length in gaps:
        by_span[_innermost(spans, start, lambda n: True)] += length
        by_phase[_innermost(spans, start, lambda n: n.startswith(PHASES))] += length
    share = {key: {k: v / idle_s for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
             for key, d in (("by_span", by_span), ("by_phase", by_phase))} if idle_s else {}
    idle = {"idle_ms": 1e3 * idle_s / n_items, "idle_share": idle_s / span_s if span_s else None,
            **share}
    longest = sorted(runtime, key=lambda e: -e[2])[:12]
    calls = [[name, 1e3 * d, _innermost(spans, t + d / 2, lambda n: True)]
             for name, t, d, _ in longest]
    rt = defaultdict(float)
    for name, _, d, _ in runtime:
        rt[name] += d
    runtime_ms = {k: 1e3 * v / n_items for k, v in sorted(rt.items(), key=lambda kv: -kv[1])[:8]}
    return dict(spans=table, syncs=syncs, idle=idle, longest_runtime_calls=calls,
                runtime_ms=runtime_ms)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--items", type=int, default=None, help="default: the cell's trace_items")
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from benchmark.harness import cell, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    run = cell.Run(spec.cell(args.workload), args.seed, args.seconds, "cuda", T_START)
    run.setup()
    run.window()
    ctx = run.ctx
    issue_ms = 1e3 * sum(ctx.issue_s) / len(ctx.issue_s)
    n = args.items or run.cfg["trace_items"][run.kind]
    train = run.kind == "train"
    item_span = "bench.step" if train else "bench.request"
    try:  # a checkout without the port's tracing module has no spans to record
        from warpconvnet_tpu_torch import tracing
    except ImportError:
        tracing = None

    def items(ctx):
        for _ in range(n):
            if train:
                run._train_once(run.next_index, ctx)
            else:
                run._infer_once(run.next_index, ctx, keep=False)
            run.next_index += 1
        torch.cuda.synchronize()

    recorded = cell.Context(run.kind, run.cfg, run.mix)
    if tracing is not None:
        with tracing.recording():
            items(recorded)
    window = cell.Context(run.kind, run.cfg, run.mix)  # as many items again, nothing recording
    items(window)
    sliced = cell.Context(run.kind, run.cfg, run.mix)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(item_span):
                if train:
                    run._train_once(run.next_index, sliced)
                else:
                    run._infer_once(run.next_index, sliced, keep=False)
            run.next_index += 1
        torch.cuda.synchronize()
    host, dev, runtime = _events(prof)
    out = analyse(host, dev, runtime, n)
    traced_issue = 1e3 * sum(sliced.issue_s) / n
    main_span = "wcn.train_step" if train else next(
        (k for k in out["spans"] if k.startswith("wcn.model.")), None)
    out["tracing_cost"] = dict(
        window_host_issue_ms=issue_ms, traced_host_issue_ms=traced_issue,
        traced_item_span_ms=out["spans"].get(item_span, {}).get("ms"),
        traced_main_span_ms=out["spans"].get(main_span, {}).get("ms") if main_span else None,
        spans_only_host_issue_ms=1e3 * sum(recorded.issue_s) / n if recorded.issue_s else None,
        untraced_host_issue_ms=1e3 * sum(window.issue_s) / n,
        window_items=len(ctx.issue_s), traced_items=n)
    out["workload"], out["seed"], out["items"] = args.workload, args.seed, n
    from benchmark.harness import measure

    out["card"] = measure.card_name()
    print(f"== {args.workload} seed {args.seed}: {n} items traced; card {out['card']}")
    print("host ms an item by span (calls, ms, outermost ms):")
    for k, v in out["spans"].items():
        print(f"  {k:60s} {v['calls']:8.2f} {v['ms']:10.3f} {v['outermost_ms']:10.3f}")
    print(f"idle {out['idle']['idle_ms']:.3f} ms an item, share {out['idle']['idle_share']}")
    for key in ("by_phase", "by_span"):
        print(f"idle time {key}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["idle"].get(key, {}).items()))
    print("longest runtime calls (ms, span): " + "; ".join(
        f"{a} {b:.3f} {c}" for a, b, c in out["longest_runtime_calls"]))
    print("runtime ms an item: " + ", ".join(f"{k} {v:.3f}" for k, v in out["runtime_ms"].items()))
    print(f"tracing cost: {out['tracing_cost']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
