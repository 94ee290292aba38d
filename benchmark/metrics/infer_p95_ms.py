"""95th percentile of all requests' latencies in the window, each from the
request's start to its synchronise (linear interpolation between ranks)."""

import numpy as np


def read(ctx):
    if ctx.kind != "infer" or not ctx.latency_s:
        return None
    return 1e3 * float(np.percentile(ctx.latency_s, 95))
