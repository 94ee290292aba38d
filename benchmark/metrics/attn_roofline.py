"""Attention's share of its roofline in the profiled slice, in %: the sum
over its kernel calls of max(FLOPs / the configuration's attention peak
(`attn_peak`, TF32 for an fp32 trunk), bytes / HBM rate), counted by the
benchmark (`harness/work.py`: useful attention FLOPs, 4 S^2 D H a global
forward, 4 D H (q P^2 + r^2) a patched one, 4 D H times the sum over
windows of their cells squared a windowed one (shifted or not), the
backward twice that, no recompute; bytes for patched and windowed
attention, none for global), over the device time of the kernels this
file attributes to attention by name: K9, K9-dkv and K9-dq (`seg_attn_*`),
whichever call launched them. A call without a byte count (global
attention) is bounded by its FLOPs alone. Read for ``attn_roofline.train``
and ``attn_roofline.infer``."""

from benchmark.harness.measure import PEAK_FLOPS, bound_s


def read(ctx):
    if ctx.trace is None:
        return None
    peak = PEAK_FLOPS[ctx.config["attn_peak"]]
    calls = [(f, b) for kind, _, f, b in ctx.traced_work if kind in ("attn", "attn_bwd")]
    flops = sum(f for f, b in calls if not b)
    bounded = sum(bound_s(f, b, peak) for f, b in calls if b)
    spent = ctx.trace.time_of(lambda n: "seg_attn_" in n)
    if flops + bounded <= 0 or spent <= 0:
        return None
    return 100.0 * flops / peak / spent + 100.0 * bounded / spent
