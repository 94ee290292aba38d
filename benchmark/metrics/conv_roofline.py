"""The table convs' share of their roofline in the profiled slice, in %:
the sum over their kernel calls (`sub` of any kernel size, `sub3` at
k 3, `down2`, `up2`) of max(FLOPs / the conv dtype's peak, bytes / HBM rate),
counted by the benchmark (`harness/work.py`), over the device time of
the kernels this file attributes to the convs by name: K2, K3, K4
(`igemm_*`) and their weight packing (`pack_weights`). Read for
``conv_roofline.train`` and ``conv_roofline.infer``."""

from benchmark.harness.measure import PEAK_FLOPS, bound_s

CONV_OPS = ("sub3", "sub", "down2", "up2")


def _conv_kernel(name):
    return "igemm_" in name or "pack_weights" in name


def read(ctx):
    if ctx.trace is None:
        return None
    peak = PEAK_FLOPS[ctx.config["conv_dtype"]]
    bound = sum(bound_s(f, b, peak) for _, op, f, b in ctx.traced_work if op in CONV_OPS)
    spent = ctx.trace.time_of(_conv_kernel)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
