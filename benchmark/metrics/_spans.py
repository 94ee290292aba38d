"""What the readers of the program's spans share (not a metric): the
profiled slice's items and the host time and count of a family of the
program's ``wcn.*`` spans (``warpconvnet_tpu_torch/tracing.py``), which
the profiler exports as ``user_annotation`` events on the trace's clock
(``measure.Trace.host``)."""

ITEM_SPANS = ("bench.step", "bench.request")  # the cell's own span around each item


def items(trace) -> int:
    """Steps or requests of the profiled slice."""
    return sum(1 for name, _, _ in trace.host if name in ITEM_SPANS)


def traced(trace) -> bool:
    """Whether the program marked its layers in this trace at all (a
    program without spans gives no ``wcn.*`` event)."""
    return any(name.startswith("wcn.") for name, _, _ in trace.host)


def matching(trace, prefix: str):
    """(start, duration) of every span whose name starts with ``prefix``."""
    return [(t, d) for name, t, d in trace.host if name.startswith(prefix)]


def union_s(spans) -> float:
    """Seconds covered by the spans, overlaps once: the time in the
    outermost of nested spans."""
    total, end = 0.0, float("-inf")
    for t, d in sorted(spans):
        if t + d > end:
            total += t + d - max(t, end)
            end = t + d
    return total


def per_item(ctx, value):
    """``value(trace)`` over the slice's items; None without a trace, an
    item or the program's spans."""
    trace = ctx.trace
    if trace is None or not traced(trace):
        return None
    n = items(trace)
    return value(trace) / n if n else None
