"""Host milliseconds a training step spends in its optimizer step: the
program's span ``wcn.train_step.optimizer`` (``parallel/train.py``), in
the profiled slice, over its steps. Read for ``optimizer_ms.train``; None
without that span."""

from benchmark.metrics._spans import matching, per_item, union_s


def read(ctx):
    if ctx.trace is None or not matching(ctx.trace, "wcn.train_step.optimizer"):
        return None
    return per_item(ctx, lambda trace: 1e3 * union_s(matching(trace, "wcn.train_step.optimizer")))
