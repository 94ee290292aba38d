"""K2's forward tile work over its useful pairs in the profiled slice: the
rows its tensor-core tiles computed (64 for each (tile, offset) a tile
walked, the kernel's own count ``k2.fwd_tile_work``) over the table
entries >= 0 of those launches (``k2.fwd_pairs``); 1 would be no row
adding zeros. The program's device counters count only while a profiler
records, so they cover exactly the slice. Read for ``k2_tile_waste.train``
and ``k2_tile_waste.infer``.

The reader reaches the program only through
``warpconvnet_tpu_torch.tracing.counters``, from the module the run has
loaded (it imports nothing of the program); None where the program has
no such counters or the slice ran no K2 forward."""

import sys


def read(ctx):
    tracing = sys.modules.get("warpconvnet_tpu_torch.tracing")
    if ctx.trace is None or tracing is None or not hasattr(tracing, "counters"):
        return None
    counts = tracing.counters()
    work, pairs = counts.get("k2.fwd_tile_work", 0), counts.get("k2.fwd_pairs", 0)
    if work <= 0 or pairs <= 0:
        return None
    return work / pairs
