"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set
from: the numbers ``correct`` compares, for the program on many seeds and
for the control (the plain reference one precision below the
configuration's, in the program's place) on a few, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 3]

Train cells take their compared first steps and no window; infer cells a
short window (``--seconds``) at the cell's own load. Prints one JSON line a
seed, then the largest program reading and the smallest control reading
of each number (and, for train cells given ``--fault-seeds``, the
smallest readings of two faults put in the program's place: the reference
stepping on half of each batch, and the reference taking its loss from
half of each batch after a forward over all of it).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="", help="train cells: the half-batch faults")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark.harness import cell, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    c = spec.cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    lows, highs = {}, {}
    fault_low = {"half_batch": {}, "half_loss": {}}
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = cell.Run(c, seed, args.seconds, "cuda")
        run.setup()
        if run.kind == "infer":
            run.window()
        run.release_program()
        t0 = time.perf_counter()
        run.compare("reference")
        line = {"seed": seed, "setup_s": run.ctx.setup_s, "failed": run.failed,
                "reference_s": time.perf_counter() - t0, "program": dict(run.checks),
                "notes": run.notes}
        for k, v in run.checks.items():
            lows[k] = max(lows.get(k, 0.0), v)
        if seed in control:
            run.compare("control")
            line["control"] = dict(run.checks)
            line["control_notes"] = run.notes
            for k, v in run.checks.items():
                highs[k] = min(highs.get(k, float("inf")), v)
        if seed in faults and run.kind == "train":
            for fault, low in fault_low.items():
                run.compare(fault)
                line[fault] = dict(run.checks)
                for k, v in run.checks.items():
                    low[k] = min(low.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        del run
        cell._free()
    print(json.dumps({"workload": args.workload, "program_max": lows, "control_min": highs,
                      **{f"{k}_min": v for k, v in fault_low.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
