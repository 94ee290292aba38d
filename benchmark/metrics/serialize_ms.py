"""Host milliseconds a training step spends serializing its levels: the
program's ``wcn.serialize`` spans (each (level, order) pair's Morton keys,
per-scene sort and inverse, computed once a forward), outermost spans
counted once, in the profiled slice, over its steps. Read for
``serialize_ms.train``; None without such spans."""

from benchmark.metrics._spans import matching, per_item, union_s


def read(ctx):
    if ctx.trace is None or not matching(ctx.trace, "wcn.serialize"):
        return None
    return per_item(ctx, lambda trace: 1e3 * union_s(matching(trace, "wcn.serialize")))
