"""Host milliseconds an item spends building kernel maps: the program's
``wcn.map.*`` spans (the coordinate engine's builders, ``ops/kernel_map.py``,
``geometry/voxels.py``, the map builders of ``nn/functional/``), outermost
spans counted once, in the profiled slice, over its items. Read for
``map_build_ms.train`` and ``map_build_ms.infer``; None where the program
marks none of its layers."""

from benchmark.metrics._spans import matching, per_item, union_s


def read(ctx):
    return per_item(ctx, lambda trace: 1e3 * union_s(matching(trace, "wcn.map.")))
