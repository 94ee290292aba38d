"""Segment attention's share of its roofline in the profiled slice, in %:
useful attention FLOPs (4 S^2 D H a forward, 8 S^2 D H a backward, per
scene, no recompute), counted by the benchmark, over the configuration's
attention peak (`attn_peak`, TF32 for an fp32 trunk) and the device time
of the kernels this file attributes to attention by name: K9, K9-dkv and
K9-dq (`seg_attn_*`). Read for
``attn_roofline.train`` and ``attn_roofline.infer``."""

from benchmark.harness.measure import PEAK_FLOPS


def read(ctx):
    if ctx.trace is None:
        return None
    flops = sum(f for kind, _, f, _ in ctx.traced_work if kind in ("attn", "attn_bwd"))
    spent = ctx.trace.time_of(lambda n: "seg_attn_" in n)
    if flops <= 0 or spent <= 0:
        return None
    return 100.0 * flops / PEAK_FLOPS[ctx.config["attn_peak"]] / spent
