"""Model FLOPs of the window's (untraced) steps or requests, counted by the benchmark
from the configuration's call table (a training step at three times its
forward), over the window's seconds times the configuration's peak
(`mfu_peak_flops`), in %. Read for ``mfu.train`` and ``mfu.infer``."""


def read(ctx):
    if not ctx.items:
        return None
    return 100.0 * ctx.flops / (ctx.window_s * ctx.config["mfu_peak_flops"])
