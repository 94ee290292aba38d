"""Host milliseconds an item spends in the program's ``wcn.sync.*`` spans
(host calls that block on the card: copies of host data to the card,
reads of card values), outermost spans counted once, in the profiled
slice, over its items. Read for ``sync_wait_ms.train`` and
``sync_wait_ms.infer``; 0 where the program marks no such call, None
where it marks none of its layers."""

from benchmark.metrics._spans import matching, per_item, union_s


def read(ctx):
    return per_item(ctx, lambda trace: 1e3 * union_s(matching(trace, "wcn.sync.")))
