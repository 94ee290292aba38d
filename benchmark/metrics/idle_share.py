"""Share of the profiled slice's device span (first device operation's
start to the last one's end) in which no kernel, copy or memset ran, in %
(the arithmetic of `chip_smoke.py` `profile_run`). Read for
``idle_share.train`` and ``idle_share.infer``."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.span_s())
