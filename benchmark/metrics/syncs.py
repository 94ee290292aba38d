"""The program's ``wcn.sync.*`` spans (host calls that block on the card)
in the profiled slice, over its items. Read for ``syncs.train`` and
``syncs.infer``; 0 where the program marks no such call, None where it
marks none of its layers."""

from benchmark.metrics._spans import matching, per_item


def read(ctx):
    return per_item(ctx, lambda trace: float(len(matching(trace, "wcn.sync."))))
